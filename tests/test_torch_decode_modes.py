"""The PyTorch port's decode engine in its other scheduling modes —
chunked prefill and speculative decoding (replay and draft-KV
proposals) — against the JAX package's, at a tiny size on the CPU
(vocab 64, hidden 16, 2 layers, 4 slots, max_len 32, blocks of 4, a
chunk budget of 5 tokens):

* one chunk of the chunk-prefill program gives the JAX program's logits
  and arena writes within rtol = atol = 1e-5 (float32 sums in another
  order), on the same weights (``paddle_tpu_torch.convert``);
* the engine's tokens in each mode equal its own ``offline_decode``, the
  JAX engine's and JAX's ``offline_decode`` exactly, under shuffled
  admission;
* chunks the radix already holds are skipped, an iteration runs at most
  one chunk, an identical draft is accepted every time, draft-KV pins an
  idle draft entry and falls back to replay for a busy one, and bad
  speculative requests are refused with the JAX engine's messages.
"""

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu.serving.decode import GenerationEngine as JaxEngine
from paddle_tpu.serving.decode import build_decoder_model as jax_build
from paddle_tpu.serving.request import RejectedError as JaxRejected
from paddle_tpu_torch.convert import load_params
from paddle_tpu_torch.serving.brownout import BrownoutController
from paddle_tpu_torch.serving.decode import GenerationEngine as TorchEngine
from paddle_tpu_torch.serving.decode import build_decoder_model as torch_build
from paddle_tpu_torch.serving.decode.model import DecodeModel
from paddle_tpu_torch.serving.request import RejectedError

GEOM = dict(vocab_size=64, hidden=16, num_layers=2, slots=4, max_len=32,
            block_size=4)
CHUNK = 5


def _param_arrays(jentry):
    m = jentry.model
    arenas = {n for kv in m.state_names for n in kv}
    return {v.name: np.asarray(jentry._scope.find_var(v.name))
            for v in m.startup_program.global_block().vars.values()
            if v.persistable and v.name not in arenas}


def _renamed(arrays, src, dst):
    """The same weights under another model's name prefix."""
    return {dst + n[len(src):]: a for n, a in arrays.items()}


@pytest.fixture(scope="module")
def served():
    """A JAX engine and a port engine (CPU) hosting the same target (with
    a chunk budget), the same 1-layer draft "small" (with a shorter
    max_len) and a draft "v48" of another vocabulary; the port engine
    also hosts "same", a draft holding the target's weights."""
    small = dict(GEOM, num_layers=1, max_len=24)
    v48 = dict(GEOM, num_layers=1, vocab_size=48)
    jeng = JaxEngine(queue_depth=64, breaker_threshold=0)
    jt = jeng.register_model(jax_build(**GEOM, chunk_tokens=CHUNK, name="t"))
    jd = jeng.register_model(jax_build(**small, name="small"))
    jeng.register_model(jax_build(**v48, name="v48"))
    teng = TorchEngine(place=pt.CPUPlace(), queue_depth=64)
    tt = teng.register_model(torch_build(**GEOM, chunk_tokens=CHUNK,
                                         name="t"))
    ts = teng.register_model(torch_build(**GEOM, name="same"))
    td = teng.register_model(torch_build(**small, name="small"))
    teng.register_model(torch_build(**v48, name="v48"))
    target = _param_arrays(jt)
    load_params(tt.scope, target)
    load_params(ts.scope, _renamed(target, "t_v1.", "same_v1."))
    load_params(td.scope, _param_arrays(jd))
    # the brownout ladder sheds draft-KV (L1) and speculation (L2) under
    # queue or pool pressure, which these bursts may or may not reach
    # depending on the measured drain rate; the route a request takes is
    # what these tests check, so the target's ladder never escalates here
    # (tests/test_torch_overload.py drives the ladder)
    tt._brownout = BrownoutController(enter=(1.1,) * 4, exit=(1.0,) * 4)
    yield jeng, jt, teng, tt
    teng.shutdown()
    jeng.shutdown()


def _tokens(resp):
    return [int(t) for t in resp.result(timeout=120)["tokens"]]


def _check_exact(jeng, jt, teng, tt, prompts, max_news, order, **spec):
    """Submit in ``order`` to both engines (``spec(i)`` -> submit options
    of request i); every stream equals both offline references."""
    teng.start()
    jeng.start()
    tr = {i: teng.submit(prompts[i], model="t", max_new_tokens=max_news[i],
                         **spec.get("torch", lambda i: {})(i))
          for i in order}
    jr = {i: jeng.submit(prompts[i], model="t", max_new_tokens=max_news[i],
                         **spec.get("jax", lambda i: {})(i))
          for i in order}
    for i in order:
        got, jgot = _tokens(tr[i]), _tokens(jr[i])
        own = tt.offline_decode(prompts[i], max_news[i])
        ref = jt.offline_decode(prompts[i], max_news[i])
        assert got == own == jgot == ref, (i, got, own, jgot, ref)


def test_chunk_program_logits_and_arena_writes_match_jax(served):
    jeng, jt, teng, tt = served
    m = tt.model
    L, R = m.max_len, m.rows
    prompt = [3, 9, 27, 1, 60, 5, 5, 12, 40, 7, 2, 33]
    row_map = np.zeros((L,), np.int64)
    row_map[:12] = np.arange(20, 32)
    # both arenas from zeros: earlier traffic left other rows in each
    jt._reset_arenas()
    tt._reset_arenas()
    try:
        for start in (0, CHUNK, 2 * CHUNK):
            stop = min(start + CHUNK, len(prompt))
            real = stop - start
            toks = np.zeros((1, CHUNK), np.int64)
            toks[0, :real] = prompt[start:stop]
            pos = np.zeros((1, CHUNK), np.int64)
            pos[0, :real] = np.arange(start, stop)
            bias = np.full((1, CHUNK, L), -1e9, np.float32)
            for c in range(real):
                bias[0, c, :start + c + 1] = 0.0
            wrows = np.full((CHUNK,), R, np.int64)
            wrows[:real] = row_map[start:stop]
            feeds = {DecodeModel.CHU_TOKENS: toks,
                     DecodeModel.CHU_POSITIONS: pos,
                     DecodeModel.CHU_BIAS: bias,
                     DecodeModel.CHU_ROWS: row_map,
                     DecodeModel.CHU_WRITE_ROWS: wrows}
            want = np.asarray(jt._run("chunk", feeds)[0])
            got = tt._run("chunk", feeds)[0].numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            for kn, vn in m.state_names:
                for n in (kn, vn):
                    np.testing.assert_allclose(
                        tt.scope.find_var(n).numpy(),
                        np.asarray(jt._scope.find_var(n)),
                        rtol=1e-5, atol=1e-5)
    finally:
        # the rows written here belong to no block: zero both arenas
        jt._reset_arenas()
        tt._reset_arenas()


def test_chunked_engine_tokens_match_offline_and_jax(served):
    jeng, jt, teng, tt = served
    rng = np.random.RandomState(5)
    shared = rng.randint(0, 64, size=8).tolist()         # two full blocks
    prompts, max_news = [], []
    for i in range(8):
        tail = rng.randint(0, 64, size=int(rng.randint(1, 14))).tolist()
        prompts.append(shared + tail if i % 3 == 0 else tail)
        max_news.append(int(rng.randint(2, 9)))
    order = [int(i) for i in rng.permutation(len(prompts))]
    runs = tt.stats()["chunk_runs"]
    _check_exact(jeng, jt, teng, tt, prompts, max_news, order)
    assert tt.stats()["chunk_runs"] > runs           # long prompts chunked
    tt.block_pool.check_conservation()


def test_radix_shared_chunks_are_skipped():
    eng = TorchEngine(place=pt.CPUPlace(), queue_depth=8)
    entry = eng.register_model(torch_build(**GEOM, chunk_tokens=CHUNK,
                                           name="share"))
    prompt = np.random.RandomState(12).randint(0, 64, size=16).tolist()
    ref = entry.offline_decode(prompt, 4)
    eng.start()
    try:
        out1 = _tokens(eng.submit(prompt, max_new_tokens=4))
        first = entry.stats()
        out2 = _tokens(eng.submit(prompt, max_new_tokens=4))
        second = entry.stats()
    finally:
        eng.shutdown()
    assert out1 == out2 == ref
    assert first["chunk_runs"] == 4 and first["chunk_tokens"] == 16
    # the second admission paid ONE chunk (the final-logits chunk): the
    # radix served its four blocks
    assert second["chunk_runs"] - first["chunk_runs"] == 1
    assert second["chunk_tokens"] - first["chunk_tokens"] == 1


def test_an_iteration_runs_at_most_one_chunk():
    eng = TorchEngine(place=pt.CPUPlace(), queue_depth=8)
    entry = eng.register_model(torch_build(**GEOM, chunk_tokens=CHUNK,
                                           name="fair"))
    rng = np.random.RandomState(11)
    longs = [rng.randint(0, 64, size=n).tolist() for n in (17, 14)]
    refs = [entry.offline_decode(p, 5) for p in longs]
    ref_short = entry.offline_decode([1, 2], 20)
    short = eng.submit([1, 2], max_new_tokens=20)
    assert entry._admit_free_slots() == 1
    entry._step()                           # the short one is decoding
    resps = [eng.submit(p, max_new_tokens=5) for p in longs]
    record = []
    for _ in range(60):
        decoding = [st for st in entry._slots
                    if st is not None and st.mode == "decode"]
        before = [len(st.generated) for st in decoding]
        runs = entry.stats()["chunk_runs"]
        assert not entry._iterate()
        record.append((len(decoding), entry.stats()["chunk_runs"] - runs,
                       [len(st.generated) - b
                        for st, b in zip(decoding, before)]))
        if short.done() and all(r.done() for r in resps):
            break
    chunked = [r for r in record if r[1]]
    # 17 and 14 tokens at 5 a chunk: 4 + 3 chunks, one an iteration
    assert len(chunked) == 7 and all(r[1] == 1 for r in record if r[1])
    # every slot that was decoding gained its token in every iteration
    assert all(d == 1 for r in record for d in r[2]), record
    assert all(r[0] for r in chunked), record
    assert [_tokens(r) for r in resps] == refs
    assert _tokens(short) == ref_short


def _spec_traffic(seed, n=8):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, 64, size=int(rng.randint(1, 9))).tolist()
               for _ in range(n)]
    max_news = [int(rng.randint(2, 12)) for _ in range(n)]
    return prompts, max_news, [int(i) for i in rng.permutation(n)]


@pytest.mark.parametrize("draft_kv", [False, True])
def test_speculation_in_mixed_traffic_matches_offline_and_jax(served,
                                                              draft_kv):
    jeng, jt, teng, tt = served
    prompts, max_news, order = _spec_traffic(21 + draft_kv)
    before = tt.stats()
    spec = {"torch": lambda i: (dict(draft_model="small", spec_k=3,
                                     draft_kv=draft_kv) if i % 2 == 0
                                else {}),
            "jax": lambda i: (dict(draft_model="small", spec_k=3)
                              if i % 2 == 0 else {})}
    _check_exact(jeng, jt, teng, tt, prompts, max_news, order, **spec)
    after = tt.stats()
    assert after["spec_emitted_tokens"] > before["spec_emitted_tokens"]
    assert after["spec_draft_kv_fallbacks"] == 0
    kv_steps = after["spec_draft_kv_steps"] - before["spec_draft_kv_steps"]
    replay = after["spec_draft_steps"] - before["spec_draft_steps"]
    assert (kv_steps > 0 and replay == 0) if draft_kv else \
        (kv_steps == 0 and replay > 0)
    tt.block_pool.check_conservation()
    teng.entry("small").block_pool.check_conservation()


def test_identical_draft_is_always_accepted(served):
    jeng, jt, teng, tt = served
    teng.start()
    before = tt.stats()
    prompt = [3, 1, 4, 1, 5]
    got = _tokens(teng.submit(prompt, model="t", max_new_tokens=12,
                              draft_model="same", spec_k=3))
    assert got == tt.offline_decode(prompt, 12) == \
        jt.offline_decode(prompt, 12)
    st = tt.stats()
    d = {k: st[k] - before[k] for k in (
        "spec_target_steps", "spec_emitted_tokens", "spec_proposed_tokens",
        "spec_accepted_tokens", "spec_draft_kv_steps")}
    assert d["spec_accepted_tokens"] == d["spec_proposed_tokens"] > 0
    assert d["spec_target_steps"] / d["spec_emitted_tokens"] <= 0.7, d
    assert d["spec_draft_kv_steps"] > 0
    assert st["spec_draft_kv_fallbacks"] == 0
    assert teng.entry("same").stats()["draft_pinned"] is True


def test_distinct_draft_still_gives_exact_output(served):
    jeng, jt, teng, tt = served
    teng.start()
    before = tt.stats()
    prompt = [9, 9, 8, 7]
    got = _tokens(teng.submit(prompt, model="t", max_new_tokens=10,
                              draft_model="small", spec_k=4))
    assert got == tt.offline_decode(prompt, 10) == \
        jt.offline_decode(prompt, 10)
    st = tt.stats()
    assert (st["spec_target_steps"] - before["spec_target_steps"]
            <= st["spec_emitted_tokens"] - before["spec_emitted_tokens"])


@pytest.mark.parametrize("case", ["self", "ghost", "spec_k", "max_len",
                                  "vocab", "sampling"])
def test_speculative_validation_messages_match_the_jax_engine(served, case):
    jeng, jt, teng, tt = served
    kw = {"self": dict(draft_model="t"),
          "ghost": dict(draft_model="ghost"),
          "spec_k": dict(draft_model="small", spec_k=0),
          "max_len": dict(draft_model="small", max_new_tokens=22),
          "vocab": dict(draft_model="v48"),
          "sampling": dict(sampling=3)}[case]
    kw = dict(dict(max_new_tokens=2), **kw)
    with pytest.raises(JaxRejected) as want:
        jeng.submit([1, 2, 3], model="t", **kw)
    with pytest.raises(RejectedError) as got:
        teng.submit([1, 2, 3], model="t", **kw)
    # the port hosts one more model, which the "no model" message lists
    assert str(got.value).split("; hosted")[0] == \
        str(want.value).split("; hosted")[0]


def test_draft_kv_pins_an_idle_draft_and_falls_back_when_busy():
    eng = TorchEngine(place=pt.CPUPlace(), queue_depth=16)
    tgt = eng.register_model(torch_build(**GEOM, name="pin_t"))
    drf = eng.register_model(torch_build(**dict(GEOM, num_layers=1),
                                         name="pin_d"))
    eng.start()
    try:
        prompt = [3, 9, 2, 6, 1]
        ref = tgt.offline_decode(prompt, 6)
        # busy draft: primary traffic on it, so replay proposals
        hold = eng.submit([5, 5, 4], model="pin_d", max_new_tokens=24)
        got = _tokens(eng.submit(prompt, model="pin_t", max_new_tokens=6,
                                 draft_model="pin_d", spec_k=3))
        hold.result(timeout=120)
        assert got == ref
        st0 = tgt.stats()
        assert st0["spec_draft_kv_prefills"] == 0 and st0["spec_draft_steps"]
        assert drf.stats()["draft_pinned"] is False
        # idle draft: pinned, one draft step a token, primary refused
        got = _tokens(eng.submit(prompt, model="pin_t", max_new_tokens=6,
                                 draft_model="pin_d", spec_k=3))
        assert got == ref
        st = tgt.stats()
        assert st["spec_draft_kv_prefills"] == 1
        assert st["spec_draft_kv_steps"] > 0
        assert st["spec_draft_kv_fallbacks"] == 0
        assert st["draft_pinned"] is False        # the target is no draft
        assert drf.stats()["draft_pinned"] is True
        with pytest.raises(RejectedError, match="pinned"):
            eng.submit([1, 2, 3], model="pin_d", max_new_tokens=2)
    finally:
        eng.shutdown()
    # every draft slot and block went back on retire
    assert drf.stats()["active_slots"] == 0
    assert drf.block_pool.check_conservation()["blocks_live"] == 0


def test_a_failed_draft_step_poisons_the_draft_and_falls_back():
    """A draft-KV step that fails (here: a draft row map outside the
    arena, which the kernel would clamp) poisons the draft entry; the
    request finishes on replay proposals with the same tokens, and the
    fallback is counted."""
    eng = TorchEngine(place=pt.CPUPlace(), queue_depth=16)
    tgt = eng.register_model(torch_build(**GEOM, name="poison_t"))
    drf = eng.register_model(torch_build(**dict(GEOM, num_layers=1),
                                         name="poison_d"))
    prompt = [4, 8, 15, 16, 23]
    ref = tgt.offline_decode(prompt, 8)
    resp = eng.submit(prompt, model="poison_t", max_new_tokens=8,
                      draft_model="poison_d", spec_k=3)
    assert tgt._admit_free_slots() == 1
    st = next(s for s in tgt._slots if s is not None)
    assert st.mode == "spec" and st.d_slot is not None
    st.d_row_map[0] = drf.model.rows
    while not resp.done():
        assert not tgt._iterate()
    assert _tokens(resp) == ref
    stats = tgt.stats()
    assert stats["spec_draft_kv_fallbacks"] == 1
    assert stats["spec_draft_steps"] > 0
    assert drf._draft_ok is False
    assert drf.stats()["active_slots"] == 0


def test_a_draft_block_shared_by_two_proposal_slots_falls_back():
    """Two draft-KV requests whose prompt the draft's radix still holds
    (from a primary request before the draft was pinned) share its
    partial tail block; the first proposal step that would write into it
    falls back to replay (counted, the draft stays healthy) instead of
    copying it, and both streams stay exact."""
    eng = TorchEngine(place=pt.CPUPlace(), queue_depth=16)
    tgt = eng.register_model(torch_build(**GEOM, name="cow_t"))
    drf = eng.register_model(torch_build(**dict(GEOM, num_layers=1),
                                         name="cow_d"))
    prompt = [7, 1, 30, 2, 9, 44]              # a full block + 2 of the next
    ref = tgt.offline_decode(prompt, 6)
    # one token: the request retires at prefill, its partial tail stays
    # registered in the draft's radix
    first = eng.submit(prompt, model="cow_d", max_new_tokens=1)
    while not first.done():
        assert not drf._iterate()
    resps = [eng.submit(prompt, model="cow_t", max_new_tokens=6,
                        draft_model="cow_d", spec_k=3) for _ in range(2)]
    assert tgt._admit_free_slots() == 2
    while not all(r.done() for r in resps):
        assert not tgt._iterate()
    assert [_tokens(r) for r in resps] == [ref, ref]
    st = tgt.stats()
    assert st["spec_draft_kv_fallbacks"] == 1 and drf._draft_ok
    assert st["spec_draft_kv_steps"] > 0 and st["spec_draft_steps"] > 0
    assert drf.stats()["active_slots"] == 0
    assert drf.block_pool.check_conservation()["blocks_live"] == 0
