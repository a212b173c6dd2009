"""The decode engine's park and resume on the card, at a small width:
under a block pool that serves about two sessions, a parked session's
rows go to the host tier through one device-to-host copy and come back
through one upload and the inject program.

* An intact tier entry resumes bit-exact: the arena rows at the resumed
  slot's row map equal the spilled bytes, bit for bit, and every stream
  equals the same requests' streams on an uncut pool (each slot's decode
  step reads the same row bits either way).
* K3 (the hand-written ``paged_attention`` kernel) over the rows that
  came back from the tier equals its plain version.

Marked ``cuda``: it skips without a card and runs on one with

    python -m pytest --noconftest -m cuda tests/test_torch_overload_cuda.py -q
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import attention as A
from paddle_tpu_torch.serving.decode import GenerationEngine, build_decoder_model

pytestmark = pytest.mark.cuda

GEOM = dict(vocab_size=64, hidden=64, num_layers=2, slots=4, max_len=64,
            block_size=8)
# the kernel sums over positions in another order than the plain version
# (chunked online softmax against one softmax + matmul): float32 rounding
# of convex combinations of N(0, 1) rows, as chip_smoke.py's PARITY_ATOL
PARITY_ATOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _k3_errors(entry, st, gen):
    """K3 against its plain version over the rows just injected for
    ``st``, in every layer: (launches, largest error)."""
    m = entry.model
    H, L, S = m.hidden, m.max_len, m.slots
    rows = torch.from_numpy(np.tile(st.row_map, S)).cuda()
    bias = torch.full((S, 1, L), -1e9, device="cuda")
    bias[:, 0, :st.cursor] = 0.0
    q = torch.randn(S, H, generator=gen, device="cuda")
    before = kernels.launches("paged_attention")
    err = 0.0
    for kn, vn in m.state_names:
        k, v = entry.scope.find_var(kn), entry.scope.find_var(vn)
        got = A.paged_attention(q, k, v, rows, bias, S, L, H ** -0.5)
        ref = A.paged_attention_composite(q, k, v, rows, bias, S, L,
                                          H ** -0.5)
        err = max(err, float((got - ref).abs().max()))
    return kernels.launches("paged_attention") - before, err


def _serve(num_blocks, prompts, max_new, checks=None):
    """Hand-step the prompts through an engine on the card; with
    ``checks``, record at every resume the spilled bytes, the arena rows
    read back after the inject, and K3 against its plain version over
    them."""
    eng = GenerationEngine(seed=7, breaker_threshold=0)     # CUDAPlace(0)
    entry = eng.register_model(build_decoder_model(
        **GEOM, num_blocks=num_blocks, name="ovc"))
    if checks is not None:
        orig = entry._inject_rows
        gen = torch.Generator(device="cuda").manual_seed(5)

        def inject(st, key):
            ent = entry._tier._entries.get(key)
            spilled = None if ent is None else [
                (k.copy(), v.copy()) for k, v in ent.kv_rows]
            ok = orig(st, key)
            checks.append((spilled, entry._read_rows(st.row_map, st.cursor),
                           _k3_errors(entry, st, gen)))
            return ok

        entry._inject_rows = inject
    resps = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    for _ in range(4000):
        if all(r.done() for r in resps):
            break
        entry._iterate()
    outs = [[int(t) for t in r.result(timeout=60)["tokens"]] for r in resps]
    st = entry.stats()
    eng.shutdown()
    return st, outs


def test_intact_tier_entries_resume_bit_exact(card):
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 64, int(n)).tolist() for n in (20, 27, 33, 18)]
    checks = []
    st, outs = _serve(12, prompts, 24, checks)
    _st, want = _serve(64, prompts, 24)
    assert st["sessions_parked"] >= 1 and st["failed"] == 0
    assert st["sessions_parked"] == st["sessions_resumed"]
    assert st["resume_replays"] == 0
    assert checks
    for spilled, back, _k3 in checks:
        assert spilled is not None
        for (k, v), (k2, v2) in zip(spilled, back):
            assert np.array_equal(k.view(np.uint32), k2.view(np.uint32))
            assert np.array_equal(v.view(np.uint32), v2.view(np.uint32))
    assert outs == want


def test_k3_over_rows_back_from_the_tier_equals_its_plain_version(card):
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 64, int(n)).tolist() for n in (30, 22, 26)]
    checks = []
    st, _outs = _serve(12, prompts, 20, checks)
    assert st["sessions_resumed"] >= 1 and checks
    for _spilled, _back, (launches, err) in checks:
        assert launches == GEOM["num_layers"]
        assert err <= PARITY_ATOL
