"""The blocked top-k kernel (K7) against its plain version on the card,
the counterpart of ``chip_smoke.py`` phase 2d: word_emb's size at DGC's
k (75,776 at sparsity 0.996 and 18,944 at 0.999), an FFN weight's at
1,049, planted ties, n not a multiple of the block, a block with fewer
real elements than k (pad lanes chosen), and k > block. Marked ``cuda``:
it skips without a card and runs on one with

    python -m pytest -m cuda tests/test_torch_topk_cuda.py -q

The kernel selects and copies, so the bar is bit equality: the per-block
stage's values and indices, the final top-k's, and |x[idx]| == vals.
"""

import pytest
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import topk

pytestmark = pytest.mark.cuda

BLOCK = topk.DEFAULT_BLOCK
CASES = [
    ("word_emb k=75776", 37000 * 512, 75776, "normal"),
    ("word_emb k=18944", 37000 * 512, 18944, "normal"),
    ("ffn k=1049", 512 * 2048, 1049, "normal"),
    ("ties", 3 * BLOCK + 5, 4000, "ties"),
    ("ragged", 2 * BLOCK + 777, 600, "normal"),
    ("short last block", 4 * BLOCK + 100, 300, "normal"),
    ("k > block", 300000, 140000, "ties"),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _vector(n, kind, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, generator=gen, device=dev)
    if kind == "ties":
        x = torch.round(x * 2) / 2
        x[::7] = -0.0
    return x


@pytest.mark.parametrize("name,n,k,kind", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain(dev, name, n, k, kind):
    x = _vector(n, kind, n % 9973, dev)
    kernels.reset_launches()
    sv, si = topk.blocked_topk_stage(x, k, BLOCK)
    pv, pi = topk.blocked_topk_stage_plain(x, k, BLOCK)
    torch.cuda.synchronize()
    assert kernels.launches("blocked_topk_abs") == 1
    assert torch.equal(sv, pv) and torch.equal(si, pi), name
    vals, idx = topk.blocked_topk_abs(x, k, BLOCK)
    wv, wi = topk.blocked_topk_abs_plain(x, k, BLOCK)
    assert torch.equal(vals, wv) and torch.equal(idx, wi), name
    assert torch.equal(x.abs()[idx.long()], vals), name
    assert int(idx.max()) < n
