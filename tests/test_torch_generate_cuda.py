"""Beam search and grammar-constrained decode on the card, at a small
width: every beam and constrained slot is a slot of the ``[S, 1]`` decode
step, whose attention launches the paged-attention kernel (K3).

* Beam results hold against ``offline_beam`` (the ``[1, L]`` prefill
  program): the ranked hypotheses are equal, or, where they part (K3's
  float32 sums and the prefill's differ in the last bits), each of the
  engine's hypotheses re-scored by the prefill forward is within 1e-3
  of the reference's hypothesis at the same rank.
* A constrained stream walks its grammar with no banned token and ends
  (at EOS) in an accepting state; the speculative constrained stream is
  bit-equal to ``offline_decode(grammar=)`` (verify and reference run
  the same prefill program at the same shapes).
* A decode step with an all-zero ``DEC_MASK`` gives the same logits bits
  as a ``logits_mask=False`` build with the same weights.

Marked ``cuda``: it skips without a card and runs on one with

    python -m pytest --noconftest -m cuda tests/test_torch_generate_cuda.py -q
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.convert import load_params, persistables_to_numpy
from paddle_tpu_torch.serving.decode import (
    BeamParams,
    CompiledGrammar,
    GenerationEngine,
    GrammarConstraint,
    build_decoder_model,
)
from paddle_tpu_torch.serving.decode.generate.beam import log_softmax64
from paddle_tpu_torch.serving.decode.model import DecodeModel

pytestmark = pytest.mark.cuda

GEOM = dict(vocab_size=64, hidden=64, num_layers=2, slots=4, max_len=64,
            block_size=8)
VOCAB = (["<eos>"] + list("abcdefghijklmnopqrstuvwxyz")
         + list("ABCDEFGHIJ0123456789") + list('{}[]",:-. _')
         + ["true", "false", "null", '"a"', "ab", '":'])
SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"},
    "tags": {"type": "array", "items": {"enum": ["a", "b"]}}}}
# the beam bar: a hypothesis re-scored by the prefill forward within 1e-3
# of the reference's at its rank (float64 sums of float32 log-probs)
BEAM_TOL = 1e-3


@pytest.fixture
def engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    eng = GenerationEngine(seed=5)            # CUDAPlace(0)
    yield eng
    eng.shutdown()


def _rescore(entry, prompt, toks, grammar=None):
    """The float64 sum of the prefill forward's log-probs of ``toks``
    after ``prompt`` (masked like the beam's rows)."""
    g = GrammarConstraint(grammar) if grammar is not None else None
    seq = list(prompt)
    total = 0.0
    for t in toks:
        row = entry.prefill_logits(seq)[len(seq) - 1].cpu().numpy()
        if g is not None:
            row = row + g.mask()
            g.advance(t)
        total += float(log_softmax64(row)[t])
        seq.append(t)
    return total


def _check_beams(entry, prompt, got, want, grammar=None):
    assert len(got) == len(want)
    for (toks, score), (rtoks, rscore) in zip(got, want):
        if list(toks) == list(rtoks):
            assert abs(score - rscore) <= BEAM_TOL
            continue
        assert abs(_rescore(entry, prompt, toks, grammar) - rscore) \
            <= BEAM_TOL, (toks, rtoks)


def test_beams_hold_against_offline_beam_and_launch_k3(engine):
    t = engine.register_model(build_decoder_model(
        **GEOM, eos_id=0, logits_mask=True, name="t"))
    g = CompiledGrammar.from_json_schema(SCHEMA, VOCAB, 0)
    reqs = [([5, 17, 2, 40, 33, 8, 1, 60, 12], 3, 12, None),
            ([9, 9, 4], 4, 10, None),
            ([7, 21, 3, 3, 50], 2, 14, g)]
    engine.start()
    kernels.reset_launches()
    resps = [engine.submit(p, model="t", max_new_tokens=n, beam_width=w,
                           grammar=gr) for p, w, n, gr in reqs]
    outs = [r.result(timeout=300) for r in resps]
    launches = kernels.launches("paged_attention")
    st = t.stats()
    assert launches == GEOM["num_layers"] * st["steps"] and st["steps"]
    for (p, w, n, gr), out in zip(reqs, outs):
        got = [([int(x) for x in h["tokens"]], h["score"])
               for h in out["beams"]]
        assert len(got) == w
        _check_beams(t, p, got, t.offline_beam(p, n, BeamParams(w),
                                               grammar=gr), gr)
        if gr is not None:
            for toks, _s in got:
                c = GrammarConstraint(gr)
                for x in toks:
                    c.advance(x)
    assert st["beam_forks"] > 0 and st["active_slots"] == 0
    t.block_pool.check_conservation()
    assert t.block_pool.stats()["blocks_live"] == 0


def test_constrained_streams_conform_and_speculation_is_bit_equal(engine):
    t = engine.register_model(build_decoder_model(
        **GEOM, eos_id=0, logits_mask=True, name="t"))
    engine.register_model(build_decoder_model(
        **dict(GEOM, num_layers=1), name="d"))
    g = CompiledGrammar.from_regex("[A-E][a-z]+( [A-E][a-z]+)*", VOCAB, 0)
    engine.start()
    plain = engine.submit([3, 9, 27], model="t", max_new_tokens=16,
                          grammar=g)
    spec = engine.submit([4, 4, 1], model="t", max_new_tokens=16, grammar=g,
                         draft_model="d", spec_k=3)
    toks = [int(x) for x in plain.result(timeout=300)["tokens"]]
    c = GrammarConstraint(g)
    for x in toks:
        c.advance(x)
    if toks[-1] == 0:
        assert c.accepting()
    stoks = [int(x) for x in spec.result(timeout=300)["tokens"]]
    assert stoks == t.offline_decode([4, 4, 1], 16, grammar=g)
    assert t.stats()["grammar_steps"] == len(toks) + len(stoks)


def test_an_all_zero_mask_leaves_the_step_logits_bit_for_bit(engine):
    masked = engine.register_model(build_decoder_model(
        **GEOM, logits_mask=True, name="m"))
    plain = engine.register_model(build_decoder_model(**GEOM, name="p"))
    arenas = {n for kv in masked.model.state_names for n in kv}
    weights = {"p" + n[1:]: a for n, a in persistables_to_numpy(
        masked.scope, masked.model.startup_program).items()
        if n not in arenas}
    load_params(plain.scope, weights)
    m = masked.model
    S, L, R, V = m.slots, m.max_len, m.rows, m.vocab_size
    gen = torch.Generator().manual_seed(0)
    for kv, pkv in zip(m.state_names, plain.model.state_names):
        for n, pn in zip(kv, pkv):
            a = torch.randn((R, m.hidden), generator=gen).cuda()
            masked.scope.set(n, a.clone())
            plain.scope.set(pn, a.clone())
    cur = np.array([3, 40, 0, 63])
    bias = np.full((S, 1, L), -1e9, np.float32)
    for s in range(S):
        bias[s, 0, :cur[s] + 1] = 0.0
    rng = np.random.RandomState(1)
    feeds = {DecodeModel.DEC_TOKEN: rng.randint(0, V, (S, 1)),
             DecodeModel.DEC_POSITION: cur[:, None],
             DecodeModel.DEC_BIAS: bias,
             DecodeModel.DEC_ROWS: rng.randint(0, R, S * L),
             DecodeModel.DEC_WRITE_ROWS: np.full((S,), R, np.int64)}
    kernels.reset_launches()
    want = plain._run("step", feeds)[0]
    got = masked._run("step", dict(feeds, **{
        DecodeModel.DEC_MASK: masked._mask_feed([])}))[0]
    assert kernels.launches("paged_attention") == 2 * GEOM["num_layers"]
    assert torch.equal(got, want)
