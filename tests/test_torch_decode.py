"""The PyTorch port's decode engine against the JAX package's, at a tiny
size on the CPU (vocab 64, hidden 16, 2 layers, 4 slots, max_len 32,
blocks of 4):

* both packages' ``build_decoder_model`` emit the same ops (types,
  attributes, var names, in order) and vars for every program, the
  chunk-prefill program included;
* with the JAX engine's weights carried over by name
  (``paddle_tpu_torch.convert``), prefill and decode-step logits agree
  within rtol=atol=1e-5 (float32 sums in another order);
* the port's engine serves shuffled mixed-length prompts, some sharing a
  block prefix, with tokens equal to its own ``offline_decode`` and the
  JAX engine's;
* the entry points default to the card and raise without one, and the
  generation modes not ported yet raise naming their ROADMAP.md item.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu.serving.decode import GenerationEngine as JaxEngine
from paddle_tpu.serving.decode import build_decoder_model as jax_build
from paddle_tpu.serving.request import RejectedError as JaxRejected
from paddle_tpu_torch.convert import load_params, params_from_numpy
from paddle_tpu_torch.serving.request import (DeadlineExceededError,
                                              RejectedError, ReplicaLostError)
from paddle_tpu_torch.serving.decode import GenerationEngine as TorchEngine
from paddle_tpu_torch.serving.decode import build_decoder_model as torch_build
from paddle_tpu_torch.serving.decode.model import DecodeModel
from paddle_tpu_torch.utils.enforce import EnforceError

GEOM = dict(vocab_size=64, hidden=16, num_layers=2, slots=4, max_len=32,
            block_size=4)
PROGRAMS = ("decode_program", "prefill_program", "inject_program",
            "startup_program", "chunk_program")


def _param_names(model):
    arenas = {n for kv in model.state_names for n in kv}
    return [v.name for v in model.startup_program.global_block().vars.values()
            if v.persistable and v.name not in arenas]


@pytest.fixture(scope="module")
def pair():
    """A JAX engine entry and a port entry (CPU) holding the same weights."""
    jeng = JaxEngine(queue_depth=64, breaker_threshold=0)
    jentry = jeng.register_model(jax_build(**GEOM))
    arrays = {n: np.asarray(jentry._scope.find_var(n))
              for n in _param_names(jentry.model)}
    teng = TorchEngine(place=pt.CPUPlace(), queue_depth=64)
    tentry = teng.register_model(torch_build(**GEOM))
    load_params(tentry.scope, arrays)
    yield jeng, jentry, teng, tentry, arrays
    teng.shutdown()


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("program", PROGRAMS)
def test_programs_match_the_jax_builder(program, fused):
    # the chunk program exists only on a model built with a chunk budget
    chunk = dict(chunk_tokens=5) if program == "chunk_program" else {}
    want = getattr(jax_build(**GEOM, fused_attention=fused, **chunk), program)
    got = getattr(torch_build(**GEOM, fused_attention=fused, **chunk),
                  program)
    wb, gb = want.global_block(), got.global_block()
    assert [op.desc() for op in gb.ops] == [op.desc() for op in wb.ops]
    assert [v.desc() for v in gb.vars.values()] == \
        [v.desc() for v in wb.vars.values()]


def test_weights_carry_over_by_name(pair):
    _, jentry, _, tentry, arrays = pair
    assert arrays and all(n.startswith("decoder_v1.") for n in arrays)
    for n, a in arrays.items():
        got = tentry.scope.find_var(n)
        assert got.dtype == torch.float32 and tuple(got.shape) == a.shape
        np.testing.assert_array_equal(got.numpy(), a)
    copied = params_from_numpy({"w": arrays[n]}, "cpu")["w"]
    copied.add_(1.0)            # a copy, never a view of the caller's array
    np.testing.assert_array_equal(np.asarray(jentry._scope.find_var(n)),
                                  arrays[n])


def test_prefill_logits_match_jax(pair):
    _, jentry, _, tentry, _ = pair
    prompt = [3, 9, 27, 1, 60, 5, 5, 12, 40]
    feeds = jentry._prefill_feeds(prompt)
    want = [np.asarray(f) for f in jentry._run("prefill", feeds)]
    got = [t.numpy() for t in tentry._run("prefill", feeds)]
    assert len(got) == len(want) == 1 + 2 * GEOM["num_layers"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def _fresh_pair():
    """Fresh entries (zeroed arenas) of both packages with one weight set:
    decode steps write the arenas, so they must not share the fixture's."""
    jentry = JaxEngine(queue_depth=8, breaker_threshold=0).register_model(
        jax_build(**GEOM, name="step"))
    tentry = TorchEngine(place=pt.CPUPlace(), queue_depth=8).register_model(
        torch_build(**GEOM, name="step"))
    load_params(tentry.scope, {n: np.asarray(jentry._scope.find_var(n))
                               for n in _param_names(jentry.model)})
    return jentry, tentry


def test_decode_step_logits_and_arena_writes_match_jax():
    jentry, tentry = _fresh_pair()
    m = tentry.model
    S, L, Hd, R = m.slots, m.max_len, m.hidden, m.rows
    rng = np.random.RandomState(3)
    # inject 5 random K/V rows per layer at rows 8..12, then one decode
    # step where slot 0 reads them, slot 2 shares two of them, slot 1 is
    # retired (drop row R) and slot 3 writes into a fresh row
    inj = {DecodeModel.INJ_ROWS: np.full((L,), R, np.int64)}
    inj[DecodeModel.INJ_ROWS][:5] = np.arange(8, 13)
    for kn, vn in m.inject_kv_feeds:
        inj[kn] = rng.randn(1, L, Hd).astype(np.float32)
        inj[vn] = rng.randn(1, L, Hd).astype(np.float32)
    jentry._run("inject", inj)
    tentry._run("inject", inj)
    rows = np.zeros((S, L), np.int64)
    rows[0, :6] = np.arange(8, 14)
    rows[2, :2] = [8, 9]
    rows[2, 2] = 20
    rows[3, 0] = 30
    bias = np.full((S, 1, L), -1e9, np.float32)
    bias[0, 0, :6] = 0.0
    bias[2, 0, :3] = 0.0
    bias[3, 0, :1] = 0.0
    feeds = {
        DecodeModel.DEC_TOKEN: np.array([[4], [0], [17], [63]], np.int64),
        DecodeModel.DEC_POSITION: np.array([[5], [0], [2], [0]], np.int64),
        DecodeModel.DEC_BIAS: bias,
        DecodeModel.DEC_ROWS: rows.reshape(-1),
        DecodeModel.DEC_WRITE_ROWS: np.array([13, R, 20, 30], np.int64),
    }
    arena0 = tentry.scope.find_var(m.state_names[0][0])
    want = np.asarray(jentry._run("step", feeds)[0])
    got = tentry._run("step", feeds)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the executor wrote the arena in place: same tensor object
    assert tentry.scope.find_var(m.state_names[0][0]) is arena0
    for kn, vn in m.state_names:
        for n in (kn, vn):
            np.testing.assert_allclose(
                tentry.scope.find_var(n).numpy(),
                np.asarray(jentry._scope.find_var(n)), rtol=1e-5, atol=1e-5)


def test_engine_tokens_match_offline_and_jax(pair):
    jeng, jentry, teng, tentry, _ = pair
    rng = np.random.RandomState(11)
    shared = rng.randint(0, 64, size=8).tolist()     # two full blocks
    prompts = []
    for i in range(10):
        n = int(rng.randint(1, 14))
        tail = rng.randint(0, 64, size=n).tolist()
        prompts.append(shared + tail if i % 3 == 0 else tail)
    # one prompt twice, admitted in one round: its partial tail block is
    # shared until the first append, which copies it on write
    prompts += [shared + [5, 6, 7]] * 2
    max_news = [int(rng.randint(1, 9)) for _ in prompts]
    order = [10, 11] + list(rng.permutation(10))
    teng.start()
    resps = {i: teng.submit(prompts[i], max_new_tokens=max_news[i])
             for i in order}
    got = {i: [int(t) for t in resps[i].result(timeout=60)["tokens"]]
           for i in order}
    for i, p in enumerate(prompts):
        own = tentry.offline_decode(p, max_news[i])
        ref = jentry.offline_decode(p, max_news[i])
        assert got[i] == own == ref, (i, got[i], own, ref)
    stats = tentry.stats()
    assert stats["completed"] >= len(prompts)
    assert stats["block_pool"]["radix_hits"] >= 3     # shared prefix reused
    assert stats["block_pool"]["cow_copies"] >= 1
    # every block is free, cached or live, exactly once
    tentry.block_pool.check_conservation()


def test_bad_row_map_fails_the_step_loudly():
    """A row outside [0, R) fails the step before it runs (the kernel would
    clamp it; the plain version raises), so both devices behave alike."""
    eng = TorchEngine(place=pt.CPUPlace(), queue_depth=8)
    entry = eng.register_model(torch_build(**GEOM, name="badrows"))
    resp = eng.submit([1, 2, 3, 4, 5], max_new_tokens=4)
    entry._admit_free_slots()
    st = next(s for s in entry._slots if s is not None)
    st.row_map[1] = entry.model.rows
    entry._step()
    with pytest.raises(ReplicaLostError, match="row map outside"):
        resp.result(timeout=5)
    stats = entry.stats()
    assert stats.get("steps", 0) == 0 and stats["step_failures"] == 1
    eng.shutdown()


def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(EnforceError, match="CPUPlace"):
        TorchEngine()
    with pytest.raises(EnforceError, match="CPUPlace"):
        pt.Executor()


def test_unported_generation_modes_raise(pair):
    jeng, teng = pair[0], pair[2]
    # beam search and grammars are served now: they reach the JAX
    # engine's validation (tests/test_torch_generate_engine.py serves them)
    for kw in (dict(beam_width=99), dict(grammar=object())):
        with pytest.raises(RejectedError) as got:
            teng.submit([1, 2, 3], max_new_tokens=2, **kw)
        with pytest.raises(JaxRejected) as want:
            jeng.submit([1, 2, 3], max_new_tokens=2, **kw)
        assert str(got.value) == str(want.value)
    # weighted-fair tenants are served now (tests/test_torch_tenants.py),
    # and absolute deadlines since the fleet slice (a deadline already
    # past expires in the queue, tests/test_torch_fleet.py); the HBM gate
    # still raises, naming its ROADMAP item
    teng.start()
    out = teng.submit([1, 2, 3], max_new_tokens=2, tenant="a")
    assert len(out.result(timeout=60)["tokens"]) == 2
    with pytest.raises(NotImplementedError, match="ROADMAP.md, M12"):
        TorchEngine(place=pt.CPUPlace(), hbm_budget_mb=64)
    late = teng.submit([1, 2, 3], max_new_tokens=2, deadline_at=1.0)
    with pytest.raises(DeadlineExceededError):
        late.result(timeout=60)
