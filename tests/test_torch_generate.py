"""The PyTorch port's generation-policy modules — beam selection
(``generate/beam.py``) and grammar compilation (``generate/grammar.py``)
— against the JAX package's on the same inputs, on the CPU:

* ``log_softmax64``, ``rank_candidates``, ``select`` and
  ``finished_ranking`` give the same candidates, order and float64
  scores, exact ties (broken by parent position, then token) and banned
  tokens included;
* ``offline_beam_decode`` over one ``logits_fn`` (with and without a
  grammar) gives the same hypotheses and scores;
* ``json_schema_regex`` gives the same strings, and the DFA tables,
  accepting flags and every state's float32 ``[V]`` mask are the same
  bit for bit, over a list of regexes and schemas.
"""

import numpy as np
import pytest

from paddle_tpu.serving.decode.generate import beam as jax_beam
from paddle_tpu.serving.decode.generate import grammar as jax_grammar
from paddle_tpu_torch.serving.decode.generate import beam
from paddle_tpu_torch.serving.decode.generate import (
    BeamParams,
    CompiledGrammar,
    GrammarConstraint,
    json_schema_regex,
)

# a vocabulary of single characters, a few multi-character tokens and
# EOS at 0: enough to emit JSON and the regexes below
VOCAB = (["<eos>"] + list("abcdefghijklmnopqrstuvwxyz")
         + list("ABCDEFGHIJ0123456789") + list('{}[]",:-. _')
         + ["true", "false", "null", '"a"', "ab", '":', "12"])

REGEXES = [
    "ab*c",
    "a(b|c)*d",
    "[A-Z][a-z]+( [A-Z][a-z]+)*",
    "[^abc]+x?",
    "\\d+(\\.\\d\\d)?",
    "(\\w|-)+\\.",
    "a?b?c?",
    ".a.",
]

SCHEMAS = [
    {"type": "boolean"},
    {"type": "integer"},
    {"type": "number"},
    {"type": "null"},
    {"enum": ["a", "b", "c-d"]},
    {"type": "array", "items": {"type": "integer"}},
    {"type": "object"},
    {"type": "object", "properties": {
        "name": {"type": "string"}, "age": {"type": "integer"},
        "tags": {"type": "array", "items": {"enum": ["a", "b", "c"]}},
        "ok": {"type": "boolean"}}},
]


def _rows(rng, parents, V, ties=False, banned=0):
    rows = []
    for _ in range(parents):
        if ties:
            row = rng.randint(-2, 3, V).astype(np.float32)
        else:
            row = rng.standard_normal(V).astype(np.float32) * 3
        if banned:
            row[rng.choice(V, banned, replace=False)] += np.float32(-1e9)
        rows.append(row)
    return rows


CASES = [
    dict(parents=1, V=50, ties=False, banned=0, eos=0, room=4),
    dict(parents=3, V=40, ties=True, banned=0, eos=None, room=3),
    dict(parents=4, V=64, ties=True, banned=20, eos=0, room=4),
    dict(parents=2, V=8, ties=True, banned=3, eos=5, room=2),
    dict(parents=3, V=30, ties=False, banned=29, eos=1, room=3),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_rank_candidates_and_select_match_jax(case):
    c = CASES[case]
    rng = np.random.RandomState(100 + case)
    rows = _rows(rng, c["parents"], c["V"], c["ties"], c["banned"])
    scores = ([0.0] * c["parents"] if c["ties"]
              else list(rng.standard_normal(c["parents"])))
    for r in rows:
        assert np.array_equal(beam.log_softmax64(r),
                              jax_beam.log_softmax64(r))
    ranked = beam.rank_candidates(scores, rows)
    assert ranked == jax_beam.rank_candidates(scores, rows)
    # banned tokens never become candidates
    assert len(ranked) == sum(int((r > -5e8).sum()) for r in rows)
    got = beam.select(scores, rows, c["room"], c["eos"])
    assert got == jax_beam.select(scores, rows, c["room"], c["eos"])
    live, fin = got
    assert len(live) + len(fin) == min(c["room"], len(ranked))
    assert all(t == c["eos"] for _p, t, _s in fin)


def test_select_breaks_exact_ties_by_parent_then_token():
    """Every candidate scores -log(8): the committed (parent, token)
    order decides, as in the JAX package."""
    rows = [np.zeros(8, dtype="float32"), np.zeros(8, dtype="float32")]
    live, fin = beam.select([0.0, 0.0], rows, 3, eos_id=None)
    assert [(p, t) for p, t, _s in live] == [(0, 0), (0, 1), (0, 2)]
    assert fin == []
    assert (live, fin) == jax_beam.select([0.0, 0.0], rows, 3, eos_id=None)
    # a tie across parents: parent 1's token 0 ranks after parent 0's
    # token 7 when both score the same
    rows = [np.full(8, -50.0, np.float32), np.full(8, -50.0, np.float32)]
    rows[0][7] = 0.0
    rows[1][0] = 0.0
    live, _ = beam.select([0.0, 0.0], rows, 2, eos_id=None)
    assert [(p, t) for p, t, _s in live] == [(0, 7), (1, 0)]
    assert live == jax_beam.select([0.0, 0.0], rows, 2, eos_id=None)[0]
    finished = [([2, 1], -1.0), ([1, 9], -1.0), ([3], 0.0), ([1, 2], -1.0)]
    assert beam.finished_ranking(finished) == \
        jax_beam.finished_ranking(finished)
    assert [t for t, _s in beam.finished_ranking(finished)] == \
        [[3], [1, 2], [1, 9], [2, 1]]


def _logits_fn(V, seed):
    """A deterministic oracle with a greedy trap and near-ties: the row
    is a hash of the last two tokens."""
    def fn(tokens):
        key = (tokens[-1] * 31 + (tokens[-2] if len(tokens) > 1 else 7))
        rng = np.random.RandomState(seed + key)
        row = rng.standard_normal(V).astype(np.float32)
        row[rng.randint(V)] = row.max()        # an exact tie at the top
        return row
    return fn


@pytest.mark.parametrize("width,eos", [(1, 0), (3, 0), (4, None)])
def test_offline_beam_decode_matches_jax(width, eos):
    fn = _logits_fn(24, width)
    got = beam.offline_beam_decode(fn, [3, 5], 6, BeamParams(width),
                                   eos_id=eos, max_len=16)
    want = jax_beam.offline_beam_decode(
        fn, [3, 5], 6, jax_beam.BeamParams(width), eos_id=eos, max_len=16)
    assert got == want
    assert len(got) == width


def test_offline_beam_decode_with_grammar_matches_jax():
    V = len(VOCAB)
    fn = _logits_fn(V, 7)
    pg = CompiledGrammar.from_regex("a(b|c)*d", VOCAB, eos_id=0)
    jg = jax_grammar.CompiledGrammar.from_regex("a(b|c)*d", VOCAB, eos_id=0)
    got = beam.offline_beam_decode(fn, [1], 7, BeamParams(3), 0, 32,
                                   grammar=GrammarConstraint(pg))
    want = jax_beam.offline_beam_decode(
        fn, [1], 7, jax_beam.BeamParams(3), 0, 32,
        grammar=jax_grammar.GrammarConstraint(jg))
    assert got == want
    for toks, _s in got:
        c = GrammarConstraint(pg)
        for t in toks:
            c.advance(t)


def test_beam_params_refuses_a_width_below_one():
    with pytest.raises(ValueError, match="beam width"):
        BeamParams(0)
    assert BeamParams(3).describe() == {"width": 3}


@pytest.mark.parametrize("schema", range(len(SCHEMAS)))
def test_json_schema_regex_matches_jax(schema):
    s = SCHEMAS[schema]
    assert json_schema_regex(s) == jax_grammar.json_schema_regex(s)


def test_json_schema_refusals_match_jax():
    for bad in ({"type": "tuple"}, {"enum": [1, 2]}):
        with pytest.raises(ValueError) as got:
            json_schema_regex(bad)
        with pytest.raises(ValueError) as want:
            jax_grammar.json_schema_regex(bad)
        assert str(got.value) == str(want.value)


def _same_grammar(pg, jg):
    assert pg.dfa.start == jg.dfa.start
    assert pg.dfa.table == jg.dfa.table
    assert pg.dfa.accepting == jg.dfa.accepting
    for state in range(len(pg.dfa.table)):
        a, b = pg.mask(state), jg.mask(state)
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes(), state
        # a live state always leaves a continuation
        assert (a == 0).any()


@pytest.mark.parametrize("pattern", REGEXES)
def test_regex_dfa_and_masks_match_jax(pattern):
    pg = CompiledGrammar.from_regex(pattern, VOCAB, eos_id=0)
    jg = jax_grammar.CompiledGrammar.from_regex(pattern, VOCAB, eos_id=0)
    _same_grammar(pg, jg)


@pytest.mark.parametrize("schema", range(len(SCHEMAS)))
def test_json_schema_dfa_and_masks_match_jax(schema):
    s = SCHEMAS[schema]
    pg = CompiledGrammar.from_json_schema(s, VOCAB, eos_id=0)
    jg = jax_grammar.CompiledGrammar.from_json_schema(s, VOCAB, eos_id=0)
    _same_grammar(pg, jg)


def test_grammar_constraint_masks_fork_and_advance():
    g = CompiledGrammar.from_regex("ab*c", VOCAB, eos_id=0)
    c = GrammarConstraint(g)
    a, b, cc = VOCAB.index("a"), VOCAB.index("b"), VOCAB.index("c")
    ab = VOCAB.index("ab")
    m0 = c.mask()
    assert m0[a] == 0.0 and m0[ab] == 0.0 and m0[b] < 0 and m0[0] < 0
    c.advance(a)
    m1 = c.mask()
    assert m1[b] == 0.0 and m1[cc] == 0.0 and m1[0] < 0
    c2 = c.fork()                      # the beam fork: O(1), independent
    c.advance(b)
    c2.advance(cc)
    assert not c.accepting() and c2.accepting()
    assert c2.mask()[0] == 0.0         # EOS exactly in accepting states
    c2.advance(0)                      # EOS freezes the state
    assert c2.accepting()
    with pytest.raises(ValueError, match="not allowed"):
        c.advance(a)
    with pytest.raises(ValueError, match="non-accepting"):
        c.advance(0)
    c.advance(cc)
    assert c.accepting()


def test_grammar_refusals_match_jax():
    cases = [("a(b", "unbalanced"), ("[ab", "unbalanced"),
             ("*a", "unexpected"), ("a)", "unexpected"),
             ("Q", "matches nothing")]
    for pattern, word in cases:
        with pytest.raises(ValueError) as got:
            CompiledGrammar.from_regex(pattern, VOCAB, eos_id=0)
        with pytest.raises(ValueError) as want:
            jax_grammar.CompiledGrammar.from_regex(pattern, VOCAB, eos_id=0)
        assert str(got.value) == str(want.value)
        assert word in str(got.value)
    with pytest.raises(ValueError, match="eos_id"):
        CompiledGrammar.from_regex("ab", VOCAB, eos_id=None)
