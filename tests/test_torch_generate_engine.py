"""The PyTorch port's decode engine serving beam search and grammar-
constrained decode, against the JAX package's engine, at a tiny size on
the CPU (vocab 64, hidden 16, 2 layers, 4 slots, max_len 32, blocks of
4, ``eos_id=0``, ``logits_mask=True``, a chunk budget of 5 tokens):

* beam results (every hypothesis, best first) equal the JAX engine's and
  JAX's ``offline_beam`` token for token, with scores within 1e-5, and
  the same fork / prune / finished counts, under shuffled admission,
  with block conservation checked after every scheduler iteration (the
  port's engine is hand-stepped); a beam after a chunked prefill and a
  beam with a grammar among them;
* constrained streams equal the JAX engine's in every composition it
  serves: decode, chunked prefill, sampled, speculative (draft-KV and
  replay proposals) and beam;
* admission counts rows: a beam waits at the head of its lane for its
  width in free slots while a lower lane admits; a fork copies the
  parent's tail rows in the arena; a beam that runs out of blocks fails
  as a unit and returns every slot and block;
* an all-zero DEC_MASK feed leaves the decode step's logits bit for bit;
* the refused compositions raise the JAX engine's messages.
"""

import re

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu.serving.decode import BeamParams as JaxBeam
from paddle_tpu.serving.decode import CompiledGrammar as JaxGrammar
from paddle_tpu.serving.decode import GenerationEngine as JaxEngine
from paddle_tpu.serving.decode import SamplingParams as JaxSampling
from paddle_tpu.serving.decode import build_decoder_model as jax_build
from paddle_tpu.serving.request import RejectedError as JaxRejected
from paddle_tpu_torch.convert import load_params
from paddle_tpu_torch.serving.brownout import BrownoutController
from paddle_tpu_torch.serving.decode import (
    BeamParams,
    CompiledGrammar,
    GrammarConstraint,
    SamplingParams,
)
from paddle_tpu_torch.serving.decode import GenerationEngine as TorchEngine
from paddle_tpu_torch.serving.decode import build_decoder_model as torch_build
from paddle_tpu_torch.serving.decode.model import DecodeModel
from paddle_tpu_torch.serving.request import Priority, RejectedError

GEOM = dict(vocab_size=64, hidden=16, num_layers=2, slots=4, max_len=32,
            block_size=4)
CHUNK = 5
VOCAB = (["<eos>"] + list("abcdefghijklmnopqrstuvwxyz")
         + list("ABCDEFGHIJ0123456789") + list('{}[]",:-. _')
         + ["true", "false", "null", '"a"', "ab", '":'])
assert len(VOCAB) == GEOM["vocab_size"]
REGEX = "[A-E][a-z]+( [A-E][a-z]+)*"
SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"},
    "tags": {"type": "array", "items": {"enum": ["a", "b"]}}}}
BEAM_KEYS = ("beam_requests", "beam_forks", "beam_prunes", "beam_finished")


def _param_arrays(jentry):
    m = jentry.model
    arenas = {n for kv in m.state_names for n in kv}
    return {v.name: np.asarray(jentry._scope.find_var(v.name))
            for v in m.startup_program.global_block().vars.values()
            if v.persistable and v.name not in arenas}


def _renamed(arrays, src, dst):
    return {dst + n[len(src):]: a for n, a in arrays.items()}


@pytest.fixture(scope="module")
def served():
    """A started JAX engine and a port engine (CPU, hand-stepped, never
    started) hosting the same target "t", the same 1-layer draft "small"
    (no mask feed) and a model "noeos" with no eos_id; the port engine
    also hosts "plain", the target's weights built without the mask
    feed."""
    small = dict(GEOM, num_layers=1)
    noeos = dict(GEOM, num_layers=1, max_len=8)
    jeng = JaxEngine(queue_depth=64, breaker_threshold=0)
    jt = jeng.register_model(jax_build(**GEOM, eos_id=0, logits_mask=True,
                                       chunk_tokens=CHUNK, name="t"))
    jd = jeng.register_model(jax_build(**small, eos_id=0, name="small"))
    jeng.register_model(jax_build(**noeos, name="noeos"))
    teng = TorchEngine(place=pt.CPUPlace(), queue_depth=64)
    tt = teng.register_model(torch_build(**GEOM, eos_id=0, logits_mask=True,
                                         chunk_tokens=CHUNK, name="t"))
    td = teng.register_model(torch_build(**small, eos_id=0, name="small"))
    tp = teng.register_model(torch_build(**GEOM, eos_id=0, name="plain"))
    teng.register_model(torch_build(**noeos, name="noeos"))
    target = _param_arrays(jt)
    load_params(tt.scope, target)
    load_params(tp.scope, _renamed(target, "t_v1.", "plain_v1."))
    load_params(td.scope, _param_arrays(jd))
    # the brownout ladder closes the LOW lane (L3) and sheds non-HIGH
    # submits (L4) under queue pressure, which these hand-stepped bursts
    # may or may not reach depending on the measured drain rate; the
    # admission order and the refusals are what these tests check, so
    # the target's ladder never escalates here (tests/test_torch_overload.py
    # drives the ladder)
    tt._brownout = BrownoutController(enter=(1.1,) * 4, exit=(1.0,) * 4)
    jeng.start()
    grammars = {"regex": (CompiledGrammar.from_regex(REGEX, VOCAB, 0),
                          JaxGrammar.from_regex(REGEX, VOCAB, 0)),
                "schema": (CompiledGrammar.from_json_schema(SCHEMA, VOCAB, 0),
                           JaxGrammar.from_json_schema(SCHEMA, VOCAB, 0))}
    yield jeng, jt, teng, tt, grammars
    jeng.shutdown()


def _drain(entry, resps, check=None):
    """Hand-step the port entry's scheduler (its loop body) until every
    response is done, asserting block conservation after each
    iteration."""
    for _ in range(2000):
        if all(r.done() for r in resps):
            return
        assert not entry._iterate()
        entry.block_pool.check_conservation()
        if check is not None:
            check()
    raise AssertionError("the port engine did not finish in 2000 iterations")


def _tokens(resp):
    return [int(t) for t in resp.result(timeout=120)["tokens"]]


def _beams(resp):
    return [([int(t) for t in h["tokens"]], h["score"])
            for h in resp.result(timeout=120)["beams"]]


def _same_beams(got, want, tag):
    assert [t for t, _s in got] == [list(t) for t, _s in want], tag
    for (_t, a), (_u, b) in zip(got, want):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (tag, a, b)


def _conforms(g, toks):
    c = GrammarConstraint(g)
    for t in toks:
        c.advance(t)           # raises on a banned token or a bad EOS
    if toks and toks[-1] == 0:
        assert c.accepting()
    return "".join(VOCAB[t] for t in toks if t != 0)


def test_beam_results_match_the_jax_engine_under_shuffled_admission(served):
    jeng, jt, teng, tt, grammars = served
    pg, jg = grammars["schema"]
    rng = np.random.RandomState(11)
    shared = [5, 9, 14, 2]
    # (prompt, width, max_new, grammar?): the 9-token prompts stream
    # through the chunk program (budget 5) before their beams begin; two
    # prompts share a block with the last
    reqs = [(shared + [7], 3, 6, False),
            (rng.randint(1, 64, 9).tolist(), 2, 5, False),
            (shared + [11, 3], 4, 4, False),
            ([6, 2, 11], 3, 8, True),
            (rng.randint(1, 64, 3).tolist(), 1, 6, False),
            (shared + rng.randint(1, 64, 5).tolist(), 3, 5, True)]
    before_t = tt.stats()
    before_j = jt.stats()
    order = np.random.RandomState(4).permutation(len(reqs))
    tresp, jresp = {}, {}
    for i in order:
        p, w, n, gram = reqs[i]
        kw = dict(model="t", max_new_tokens=n, beam_width=w)
        tresp[i] = teng.submit(p, grammar=pg if gram else None, **kw)
        jresp[i] = jeng.submit(p, grammar=jg if gram else None, **kw)
    _drain(tt, list(tresp.values()))
    for i, (p, w, n, gram) in enumerate(reqs):
        got = _beams(tresp[i])
        jgot = _beams(jresp[i])
        own = tt.offline_beam(p, n, BeamParams(w),
                              grammar=pg if gram else None)
        ref = jt.offline_beam(p, n, JaxBeam(w), grammar=jg if gram else None)
        _same_beams(got, jgot, ("jax engine", i))
        _same_beams(got, ref, ("jax offline_beam", i))
        _same_beams(got, own, ("own offline_beam", i))
        assert _tokens(tresp[i]) == got[0][0]
        if gram:
            for toks, _s in got:
                _conforms(pg, toks)
    after_t = tt.stats()
    after_j = jt.stats()
    for k in BEAM_KEYS:
        assert (after_t[k] - before_t[k]
                == after_j[k] - before_j.get(k, 0)), k
    assert after_t["beam_requests"] - before_t["beam_requests"] == len(reqs)
    assert after_t["beam_forks"] > before_t["beam_forks"]
    assert (after_t["block_pool"]["forks"] - before_t["block_pool"]["forks"]
            == after_t["beam_forks"] - before_t["beam_forks"])
    assert after_t["chunk_runs"] > before_t["chunk_runs"]
    assert after_t["active_slots"] == 0
    assert after_t["block_pool"]["blocks_live"] == 0
    assert len(after_t["beam_rank_seconds"]) > len(
        before_t["beam_rank_seconds"])


MODES = {
    "decode": lambda g: dict(prompts=[[3, 9, 27], [40, 7]]),
    "chunked": lambda g: dict(prompts=[list(range(1, 12)),
                                       [8, 6, 4, 2, 1, 3, 5, 7]]),
    "sampled": lambda g: dict(prompts=[[3, 9, 27], [12, 5, 1, 1]],
                              sampling=lambda i: dict(
                                  temperature=0.9, top_k=8, seed=40 + i)),
    "spec_draft_kv": lambda g: dict(prompts=[[3, 9, 27], [40, 7, 7]],
                                    spec=dict(draft_model="small", spec_k=3)),
    "spec_replay": lambda g: dict(prompts=[[4, 4, 1], [2, 61]],
                                  spec=dict(draft_model="small", spec_k=2,
                                            draft_kv=False)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("which", ["regex", "schema"])
def test_constrained_streams_match_the_jax_engine(served, mode, which):
    jeng, jt, teng, tt, grammars = served
    pg, jg = grammars[which]
    spec = MODES[mode](pg)
    prompts = spec["prompts"]
    sampling = spec.get("sampling", lambda i: None)
    extra = spec.get("spec", {})
    before = tt.stats()
    # a constrained request beside an unconstrained one of the same mode
    tresp, jresp = [], []
    for i, p in enumerate(prompts):
        kw = dict(model="t", max_new_tokens=10, sampling=sampling(i),
                  **extra)
        tresp.append(teng.submit(p, grammar=pg if i == 0 else None, **kw))
        jresp.append(jeng.submit(p, grammar=jg if i == 0 else None, **kw))
    _drain(tt, tresp)
    for i, p in enumerate(prompts):
        got, jgot = _tokens(tresp[i]), _tokens(jresp[i])
        gram = (pg, jg) if i == 0 else (None, None)
        sp = sampling(i)
        own = tt.offline_decode(p, 10, sampling=sp, grammar=gram[0])
        ref = jt.offline_decode(p, 10, sampling=sp and JaxSampling(**sp),
                                grammar=gram[1])
        assert got == jgot == own == ref, (mode, i, got, jgot, own, ref)
    text = _conforms(pg, _tokens(tresp[0]))
    if which == "regex" and _tokens(tresp[0])[-1] == 0:
        assert re.fullmatch(REGEX, text)
    after = tt.stats()
    assert after["grammar_steps"] - before["grammar_steps"] == \
        len(_tokens(tresp[0]))
    if mode.startswith("spec"):
        assert after["spec_target_steps"] > before["spec_target_steps"]
    if mode == "spec_draft_kv":
        assert after["spec_draft_kv_steps"] > before["spec_draft_kv_steps"]
    if mode == "chunked":
        assert after["chunk_runs"] > before["chunk_runs"]


def test_a_beam_waits_for_its_width_while_a_lower_lane_admits(served):
    jeng, jt, teng, tt, grammars = served
    long_ = teng.submit([1, 2, 3], model="t", max_new_tokens=12)
    assert not tt._iterate()                       # 1 of 4 slots taken
    beam = teng.submit([4, 5, 6], model="t", max_new_tokens=4,
                       beam_width=4)
    after = teng.submit([7, 8], model="t", max_new_tokens=3)
    low = teng.submit([9, 10], model="t", max_new_tokens=3,
                      priority=Priority.LOW)
    assert not tt._iterate()
    modes = {st.request.response: st.mode for st in tt._slots
             if st is not None}
    # the beam (4 rows) waits at the head of NORMAL, and so does the
    # NORMAL request behind it (FIFO); LOW dispatches meanwhile
    assert beam not in modes and after not in modes
    assert low in modes or low.done()
    _drain(tt, [long_, beam, after, low])
    assert len(_beams(beam)) == 4
    want = jt.offline_beam([4, 5, 6], 4, JaxBeam(4))
    _same_beams(_beams(beam), want, "waited beam")
    assert tt.stats()["active_slots"] == 0


def test_a_fork_copies_the_parents_tail_rows_on_the_device(served):
    jeng, jt, teng, tt, grammars = served
    m = tt.model
    prompt = [21, 22, 23, 24, 25]      # a block and a row (no chunking)
    resp = teng.submit(prompt, model="t", max_new_tokens=5, beam_width=3)
    tt._admit_free_slots()             # prefill and the first selection
    group = next(st.beam for st in tt._slots if st is not None)
    assert len(group.order) == 3
    sts = [tt._slots[s] for s in group.order]
    seed = sts[0]
    for child in sts[1:]:
        # full block shared, tail block private with the same row
        assert child.blocks[0] is seed.blocks[0]
        assert child.blocks[1] is not seed.blocks[1]
        src, dst = seed.blocks[1].row0, child.blocks[1].row0
        for kn, vn in m.state_names:
            for n in (kn, vn):
                a = tt.scope.find_var(n)
                assert torch.equal(a[dst:dst + 1], a[src:src + 1])
                assert bool(a[src].any())
    assert seed.blocks[0].refcount >= 3
    _drain(tt, [resp])
    _same_beams(_beams(resp), jt.offline_beam(prompt, 5, JaxBeam(3)),
                "forked beam")


@pytest.mark.parametrize("favoured", [(0, 1, 2), (1, 2)])
def test_exact_ties_break_by_hypothesis_order_not_slot_id(served, favoured):
    """The parent index of the tie-break is a position in the group's
    hypothesis order (the last selection's rank order), whatever slots
    the hypotheses sit in: the engine's step gives what ``select`` gives
    over the rows in that order."""
    from paddle_tpu_torch.serving.decode.generate.beam import select

    jeng, jt, teng, tt, grammars = served
    V = tt.model.vocab_size
    resp = teng.submit([30, 31, 32], model="t", max_new_tokens=6,
                       beam_width=3)
    tt._admit_free_slots()             # prefill and the first selection
    group = next(st.beam for st in tt._slots if st is not None)
    # a hypothesis order that is not the slots' order, equal scores
    order = [group.order[2], group.order[0], group.order[1]]
    group.order = list(order)
    for sid in order:
        tt._slots[sid].score = 0.0
    prev = [list(tt._slots[sid].generated) for sid in order]
    rows = [np.zeros(V, np.float32) for _ in order]
    for p in favoured:                 # exact ties across parents
        rows[p][5] = 3.0
    live, fin = select([0.0] * 3, rows, 3, 0)
    assert tt._commit_beam_selection(group, rows)
    got = [(list(tt._slots[sid].generated), tt._slots[sid].score)
           for sid in group.order]
    assert got == [(prev[p] + [t], sc) for p, t, sc in live]
    assert group.finished == [(prev[p] + [t], sc) for p, t, sc in fin]
    # parents keep their slots: each survivor's first child stays in place
    assert group.order[:len(favoured)] == [order[p] for p in favoured]
    _drain(tt, [resp])
    assert len(_beams(resp)) == 3


def test_a_beam_that_runs_out_of_blocks_fails_as_a_unit():
    eng = TorchEngine(place=pt.CPUPlace(), queue_depth=8)
    e = eng.register_model(torch_build(**GEOM, eos_id=0, logits_mask=True,
                                       num_blocks=6, name="few"))
    # 4 beams of a 7-token prompt and 8 new tokens need more than 6 blocks
    resp = eng.submit([1, 2, 3, 4, 5, 6, 7], max_new_tokens=8, beam_width=4)
    _drain(e, [resp])
    with pytest.raises(Exception, match="block pool exhausted"):
        resp.result(timeout=1)
    st = e.stats()
    assert st["active_slots"] == 0 and st["failed"] == 1
    assert st["block_pool"]["blocks_live"] == 0
    e.block_pool.check_conservation()
    # the entry still serves afterwards
    ok = eng.submit([1, 2], max_new_tokens=3, beam_width=2)
    _drain(e, [ok])
    assert len(_beams(ok)) == 2


def test_an_all_zero_mask_feed_leaves_the_step_logits_bit_for_bit(served):
    jeng, jt, teng, tt, grammars = served
    tp = teng.entry("plain")
    m = tt.model
    S, L, R, V = m.slots, m.max_len, m.rows, m.vocab_size
    rng = np.random.RandomState(2)
    for e in (tt, tp):
        e._reset_arenas()
    # the same random arenas in both (the rows a step reads)
    for names, pnames in zip(m.state_names, tp.model.state_names):
        for n, pn in zip(names, pnames):
            a = torch.from_numpy(rng.standard_normal((R, m.hidden))
                                 .astype(np.float32))
            tt.scope.set(n, a.clone())
            tp.scope.set(pn, a.clone())
    cur = np.array([3, 9, 0, 17])
    bias = np.full((S, 1, L), -1e9, np.float32)
    for s in range(S):
        bias[s, 0, :cur[s] + 1] = 0.0
    feeds = {DecodeModel.DEC_TOKEN: rng.randint(0, V, (S, 1)),
             DecodeModel.DEC_POSITION: cur[:, None],
             DecodeModel.DEC_BIAS: bias,
             DecodeModel.DEC_ROWS: rng.randint(0, R, S * L),
             DecodeModel.DEC_WRITE_ROWS: np.full((S,), R, np.int64)}
    plain = tp._run("step", feeds)[0]
    zero = tt._mask_feed([])
    assert tuple(zero.shape) == (S, 1, V) and not bool(zero.any())
    assert tt._mask_feed([]) is zero              # allocated once
    masked = tt._run("step", dict(feeds, **{DecodeModel.DEC_MASK: zero}))[0]
    assert torch.equal(plain, masked)
    g, _ = grammars["regex"]
    fed = tt._mask_feed([(2, GrammarConstraint(g))])
    assert np.array_equal(fed[2, 0].numpy(), g.mask(g.start_state))
    assert not bool(fed[[0, 1, 3]].any())
    for e in (tt, tp):
        e._reset_arenas()
    # and the served streams agree
    for p in ([5, 1, 9], [30, 2, 2, 8, 1, 40]):
        a = teng.submit(p, model="plain", max_new_tokens=6)
        b = teng.submit(p, model="t", max_new_tokens=6)
        _drain(tt, [b])
        _drain(tp, [a])
        assert _tokens(a) == _tokens(b) == tp.offline_decode(p, 6)


def _refusal_cases(pg, jg):
    bad_eos = (CompiledGrammar.from_regex("ab", VOCAB, eos_id=3),
               JaxGrammar.from_regex("ab", VOCAB, eos_id=3))
    short = VOCAB[:40]
    bad_vocab = (CompiledGrammar.from_regex("ab", short, eos_id=0),
                 JaxGrammar.from_regex("ab", short, eos_id=0))
    return {
        "width above the slots": ("t", dict(beam_width=5), None),
        "beam with sampling": ("t", dict(beam_width=2), "sampling"),
        "beam with a draft": ("t", dict(beam_width=2,
                                        draft_model="small"), None),
        "grammar not compiled": ("t", dict(grammar="ab"), None),
        "grammar without eos": ("noeos", {}, (pg, jg)),
        "grammar eos differs": ("t", {}, bad_eos),
        "grammar vocab differs": ("t", {}, bad_vocab),
        # a model with an eos_id but no mask feed: the port's "plain" and
        # the JAX engine's "small" (so it compiles no other model)
        "grammar without the mask feed": (("plain", "small"), {}, (pg, jg)),
    }


CASE_NAMES = sorted(_refusal_cases(None, None))


@pytest.mark.parametrize("case", CASE_NAMES)
def test_refused_compositions_raise_the_jax_engines_messages(served, case):
    jeng, jt, teng, tt, grammars = served
    pg, jg = grammars["regex"]
    model, kw, extra = _refusal_cases(pg, jg)[case]
    tmodel, jmodel = model if isinstance(model, tuple) else (model, model)
    tkw, jkw = dict(kw), dict(kw)
    if extra == "sampling":
        tkw["sampling"] = SamplingParams(temperature=1.0)
        jkw["sampling"] = JaxSampling(temperature=1.0)
    elif extra is not None:
        tkw["grammar"], jkw["grammar"] = extra
    with pytest.raises(RejectedError) as got:
        teng.submit([1, 2], model=tmodel, max_new_tokens=2, **tkw)
    with pytest.raises(JaxRejected) as want:
        jeng.submit([1, 2], model=jmodel, max_new_tokens=2, **jkw)
    assert str(got.value) == str(want.value)


def test_only_tenants_and_absolute_deadlines_stay_unported(served):
    jeng, jt, teng, tt, grammars = served
    # tenants are served since the overload slice
    # (tests/test_torch_tenants.py); absolute deadlines stay with M6
    resp = teng.submit([1, 2], model="t", max_new_tokens=2, tenant="a")
    _drain(tt, [resp])
    assert len(_tokens(resp)) == 2
    with pytest.raises(NotImplementedError, match="ROADMAP.md, M6"):
        teng.submit([1, 2], model="t", deadline_at=1.0)
    with pytest.raises(TypeError, match="unexpected keyword"):
        teng.submit([1, 2], model="t", beam=3)
