"""K8 at a nonzero counter base on the card: what a dense data-parallel
rank draws (its rows of the global batch's draw, ``parallel/
data_parallel.py``). Both entry points, ``random_bits`` and the fused
dropout forward, at bases on and off the vector path (multiples of 4 and
not) and across the 32-bit boundary of the counter's low word, equal to
their plain versions and to the slice of the whole draw; the dropout op
with ``__rng_block__`` equal to the same op on the CPU. Marked ``cuda``:
it skips without a card and runs on one with

    python -m pytest --noconftest -m cuda \
        tests/test_torch_data_parallel_cuda.py -q

The kernel hashes the same counters as the plain version, so the bar is
bit equality. Each call counts one launch.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.kernels import random as KR

pytestmark = pytest.mark.cuda

KEY = prng.fold_in(prng.prng_key(2026), 18)
# multiples of 4 take the vector path (the quad's counters share their
# high word), the others the scalar one
BASES = [1, 3, 4, 4099, 1_572_864, 2**32 - 8, 2**32 - 5, 3 * 2**32 + 1]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("n", [7, 1_000_003])
def test_random_bits_at_a_counter_base(dev, base, n):
    kernels.reset_launches()
    got = KR.random_bits(KEY, n, dev, base)
    assert kernels.launches("threefry_random_bits") == 1
    assert torch.equal(got, KR.random_bits_plain(KEY, n, dev, base))
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  prng.random_bits(KEY, (n,), base))


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("shape", [(16, 128, 768), (1001,)])
def test_dropout_at_a_counter_base(dev, base, shape):
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(shape, generator=gen, device=dev)
    kernels.reset_launches()
    out, mask = KR.dropout_fwd(x, KEY, 0.1, True, base)
    assert kernels.launches("threefry_dropout") == 1
    pout, pmask = KR.dropout_fwd_plain(x, KEY, 0.1, True, base)
    assert torch.equal(mask, pmask) and torch.equal(out, pout)


def test_two_ranks_blocks_are_the_whole_draw(dev):
    """Rank r of 2 drawing its half at base r * n: the halves put together
    are the one-device draw of the whole batch."""
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(32, 128, 768, generator=gen, device=dev)
    whole = KR.dropout_fwd(x, KEY, 0.1, True)
    n = x[:16].numel()
    halves = [KR.dropout_fwd(x[16 * r:16 * (r + 1)], KEY, 0.1, True, r * n)
              for r in range(2)]
    for i in range(2):
        assert torch.equal(torch.cat([h[i] for h in halves]), whole[i])


def test_dropout_op_with_a_rank_block_equals_the_cpu(dev):
    lower = get_op_def("dropout").lowering()
    attrs = {"dropout_prob": 0.1, "dropout_implementation": "upscale_in_train"}
    x = torch.randn(8, 33, generator=torch.Generator().manual_seed(9))
    outs = [lower({"X": [x.to(d)], "__rng_key__": [KEY],
                   "__rng_block__": [1]}, attrs) for d in ("cpu", dev)]
    for slot in ("Out", "Mask"):
        assert torch.equal(outs[0][slot][0], outs[1][slot][0].cpu())
    whole = lower({"X": [torch.cat([x, x]).to(dev)], "__rng_key__": [KEY]},
                  attrs)
    assert torch.equal(whole["Mask"][0][8:], outs[1]["Mask"][0])
