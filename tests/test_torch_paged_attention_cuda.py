"""The decode-attention kernel (K3 ``paged_attention``, K4
``decode_attention``) against its plain versions on the card, the
counterpart of ``chip_smoke.py`` phase 2: ragged lengths, rows shared by a
common prefix, masked tail positions (with a retired slot, every position
masked) and a batch of one, at widths up to the decoder's (H = 768).
Marked ``cuda``: it skips without a card and runs on one with

    python -m pytest -m cuda tests/test_torch_paged_attention_cuda.py -q

Two launches on the same inputs give the same bits (the slot's combine
runs in the block that finishes last, in split order whatever that
block is). The bar is ``chip_smoke.py``'s (atol 1e-4): both sides compute convex
combinations of N(0, 1) value rows in float32, the kernel by a chunked
online softmax and the composite by one softmax and a product, so they
differ by rounding near 1e-6; a wrong row, weight or mask moves the output
by the order of the values. Each call launches the kernel once.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import attention as A

pytestmark = pytest.mark.cuda

ATOL = 1e-4
NEG_INF = -1e9
# name, slots S, positions L, width H, arena rows R, what the case plants.
# The last four meet the split plan's edges on an H100 (132 SMs): a last
# chunk of 8 positions (chunks of 32), a width not a multiple of 32 (and of
# the kernel's 8 float4 loads in flight), one slot over 256 chunks, and
# 2048 slots of one chunk each, more blocks than the card holds at once
CASES = [
    ("ragged lengths", 6, 300, 128, 4096, "ragged"),
    ("shared prefix", 4, 512, 768, 8192, "shared"),
    ("masked tail", 5, 257, 64, 2048, "masked"),
    ("batch of one", 1, 1024, 768, 2048, "ragged"),
    ("L not a multiple of the chunk", 8, 1000, 768, 8192, "shared"),
    ("width 36", 5, 300, 36, 2048, "masked"),
    ("one slot, 8192 positions", 1, 8192, 768, 8192, "ragged"),
    ("past one wave", 2048, 40, 64, 4096, "ragged"),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, S, L, H, R, kind, seed):
    """q, arenas, a row map and a [S, 1, L] bias. ``ragged``: each slot
    attends to a different prefix length; ``shared``: slots 1 and 2 reuse
    slot 0's first half of rows (a common prompt prefix); ``masked``: short
    prefixes, so most positions are a masked tail, and the last slot is
    retired (every position masked: the output is the plain average of its
    rows)."""
    rng = np.random.RandomState(seed)
    rows = np.stack([rng.choice(R, L, replace=False) for _ in range(S)])
    if kind == "shared":
        for s in range(1, min(S, 3)):
            rows[s, :L // 2] = rows[0, :L // 2]
    if kind == "masked":
        lengths = rng.randint(1, max(2, L // 8), size=S)
        lengths[-1] = 0
    else:
        lengths = rng.randint(1, L + 1, size=S)
        lengths[0] = L
    bias = np.full((S, 1, L), NEG_INF, np.float32)
    for s, n in enumerate(lengths):
        bias[s, 0, :n] = 0.0
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, ka, va = (torch.randn(*shape, generator=gen, device=dev)
                 for shape in ((S, H), (R, H), (R, H)))
    return (q, ka, va, torch.from_numpy(rows.reshape(-1)).to(dev),
            torch.from_numpy(bias).to(dev))


def _close(name, got, want):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all(), name
    err = float((got - want).abs().max())
    assert err <= ATOL, f"{name}: max abs err {err}"


@pytest.mark.parametrize("name,S,L,H,R,kind", CASES, ids=[c[0] for c in CASES])
def test_paged_attention_matches_composite(dev, name, S, L, H, R, kind):
    q, ka, va, rows, bias = _inputs(dev, S, L, H, R, kind, seed=S * L + H)
    scale = 1.0 / float(np.sqrt(H))
    kernels.reset_launches()
    got = A.paged_attention(q, ka, va, rows, bias, S, L, scale)
    assert kernels.launches("paged_attention") == 1
    want = A.paged_attention_composite(q, ka, va, rows, bias, S, L, scale)
    _close(name, got, want)


@pytest.mark.parametrize("name,S,L,H,R,kind", CASES, ids=[c[0] for c in CASES])
def test_decode_attention_matches_composite(dev, name, S, L, H, R, kind):
    q, ka, va, rows, bias = _inputs(dev, S, L, H, R, kind, seed=S + L * H)
    kc, vc = _dense(q, ka, va, rows, bias, S, L, H)
    scale = 1.0 / float(np.sqrt(H))
    kernels.reset_launches()
    got = A.decode_attention(q, kc, vc, bias, scale)
    assert kernels.launches("decode_attention") == 1
    want = A.cached_attention_composite(q, kc, vc, bias, scale)
    _close(name, got, want)


def _dense(q, ka, va, rows, bias, S, L, H):
    """The dense [S, L, H] caches of the same rows (shared rows repeat)."""
    return (ka.index_select(0, rows).reshape(S, L, H),
            va.index_select(0, rows).reshape(S, L, H))


@pytest.mark.parametrize("name,S,L,H,R,kind", [CASES[1], CASES[4], CASES[7]],
                         ids=[CASES[i][0] for i in (1, 4, 7)])
def test_two_launches_give_the_same_bits(dev, name, S, L, H, R, kind):
    q, ka, va, rows, bias = _inputs(dev, S, L, H, R, kind, seed=S + L + H)
    kc, vc = _dense(q, ka, va, rows, bias, S, L, H)
    scale = 1.0 / float(np.sqrt(H))
    paged = [A.paged_attention(q, ka, va, rows, bias, S, L, scale) for _ in range(2)]
    dense = [A.decode_attention(q, kc, vc, bias, scale) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(paged[0], paged[1]), name
    assert torch.equal(dense[0], dense[1]), name
