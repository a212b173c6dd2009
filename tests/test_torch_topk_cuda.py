"""The blocked top-k kernels (K7) against their plain versions on the card,
the counterpart of ``chip_smoke.py`` phase 2d: word_emb's size at DGC's
k (75,776 at sparsity 0.996 and 18,944 at 0.999), an FFN weight's
[512, 2048] at 1,049 and 4,194, an attention projection's [512, 512] at
1,049, planted ties, n not a multiple of the block, a block with fewer
real elements than k (pad lanes chosen), k > block, blocks of 1000 (one
CTA), 4099 (a cluster of 5 whose last slice is shorter) and a block over
what a cluster keeps in shared memory, and an all-equal |x| whose tie cut
falls inside a middle CTA of the cluster. Marked ``cuda``: it skips
without a card and runs on one with

    python -m pytest -m cuda tests/test_torch_topk_cuda.py -q

The kernels select and copy, so the bar is bit equality: the per-block
stage's values and indices, the final top-k's, and |x[idx]| == vals. The
stage counts one launch, and so does the whole function, whether it folds
the selection into the kernel call or sorts the candidates outside it.
"""

import pytest
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import topk

pytestmark = pytest.mark.cuda

BLOCK = topk.DEFAULT_BLOCK
# name, n, k, block, kind
CASES = [
    ("word_emb k=75776", 37000 * 512, 75776, BLOCK, "normal"),
    ("word_emb k=18944", 37000 * 512, 18944, BLOCK, "normal"),
    ("ffn k=1049", 512 * 2048, 1049, BLOCK, "normal"),
    ("ffn k=4194", 512 * 2048, 4194, BLOCK, "normal"),
    ("attn k=1049", 512 * 512, 1049, BLOCK, "normal"),
    ("ties", 3 * BLOCK + 5, 4000, BLOCK, "ties"),
    ("ragged", 2 * BLOCK + 777, 600, BLOCK, "normal"),
    ("short last block", 4 * BLOCK + 100, 300, BLOCK, "normal"),
    ("k > block", 300000, 140000, BLOCK, "ties"),
    ("block 1000", 10 * 1000 + 7, 40, 1000, "normal"),
    ("block 4099", 5 * 4099 + 100, 300, 4099, "ties"),
    ("block 131072 zeros", 3 * BLOCK, 2000, BLOCK, "zeros"),
    ("block 1000000", 1300000, 3000, 1000000, "normal"),
    # 53248 = 6.5 slices of 8192 (a cluster of 16), 3.25 of 16384 (of 8):
    # the cut falls inside a middle CTA
    ("all equal, cut in a middle CTA", 2 * BLOCK, 53248, BLOCK, "equal"),
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
    elif kind == "zeros":
        x[torch.rand(n, generator=gen, device=dev) < 0.9] = 0.0
    elif kind == "equal":
        x = torch.where(x < 0, -1.5, 1.5)
    return x


@pytest.mark.parametrize("name,n,k,block,kind", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel_matches_plain(dev, name, n, k, block, kind):
    x = _vector(n, kind, n % 9973, dev)
    kernels.reset_launches()
    sv, si = topk.blocked_topk_stage(x, k, block)
    assert kernels.launches("blocked_topk_abs") == 1
    pv, pi = topk.blocked_topk_stage_plain(x, k, block)
    torch.cuda.synchronize()
    assert torch.equal(sv, pv) and torch.equal(si, pi), name
    vals, idx = topk.blocked_topk_abs(x, k, block)
    assert kernels.launches("blocked_topk_abs") == 2
    wv, wi = topk.blocked_topk_abs_plain(x, k, block)
    assert torch.equal(vals, wv) and torch.equal(idx, wi), name
    assert torch.equal(x.abs()[idx.long()], vals), name
    assert int(idx.max()) < n

