"""K8 (``kernels/csrc/threefry.cu``) against its plain version on the card,
the counterpart of ``chip_smoke.py`` phase 2e: ``random_bits`` at sizes
around the 4-element vector path (1 to 9, an odd million) equal to the
plain torch version and to the host numpy copy of ``jax.random.bits``
(``core/prng.py``, which the CPU tests hold equal to JAX); the fused
dropout forward in both implementations at p = 0, 0.1, 0.5 and 1, on
BERT-base's hidden shape, odd sizes and an unaligned view, equal to the
plain version; the random ops and the dropout op through the executor
on the card equal to the same program on the CPU. Marked ``cuda``: it
skips without a card and runs on one with

    python -m pytest -m cuda tests/test_torch_random_cuda.py -q

The kernel draws, compares and divides exactly as the plain version, so
the bar is bit equality. Each call counts one launch.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import kernels
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.kernels import random as KR

pytestmark = pytest.mark.cuda

KEY = prng.fold_in(prng.prng_key(2026), 5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 9, 1_000_003])
def test_random_bits_are_jax_random_bits(dev, n):
    kernels.reset_launches()
    got = KR.random_bits(KEY, n, dev)
    assert kernels.launches("threefry_random_bits") == 1
    assert torch.equal(got, KR.random_bits_plain(KEY, n, dev))
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  prng.random_bits(KEY, (n,)))


@pytest.mark.parametrize("shape", [(32, 128, 768), (1001,), (3, 5, 7)])
@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("upscale", [True, False])
def test_dropout_matches_its_plain_version(dev, shape, p, upscale):
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=dev)
    kernels.reset_launches()
    out, mask = KR.dropout_fwd(x, KEY, p, upscale)
    assert kernels.launches("threefry_dropout") == 1
    pout, pmask = KR.dropout_fwd_plain(x, KEY, p, upscale)
    assert torch.equal(mask, pmask) and torch.equal(out, pout)
    assert mask.dtype == x.dtype and out.shape == x.shape


def test_dropout_of_an_unaligned_view(dev):
    base = torch.randn(4099, device=dev)
    x = base[1:]                       # 4 bytes past a 16-byte boundary
    out, mask = KR.dropout_fwd(x, KEY, 0.1, True)
    pout, pmask = KR.dropout_fwd_plain(x, KEY, 0.1, True)
    assert torch.equal(mask, pmask) and torch.equal(out, pout)


def test_dropout_refuses_other_dtypes(dev):
    with pytest.raises(ValueError, match="float32"):
        KR.dropout_fwd(torch.zeros(8, device=dev, dtype=torch.float16),
                       KEY, 0.1, True)


def test_random_program_on_the_card_equals_the_cpu(dev):
    """Startup draws (normal, uniform, truncated normal) and a dropout
    run on the card equal the same runs on the CPU."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 11
    with pt.program_guard(main, startup):
        x = pt.data("x", [64, 96])
        h = pt.layers.fc(x, size=33, param_attr=pt.ParamAttr(
            name="w", initializer=pt.initializer.Normal(0.0, 0.5)),
            bias_attr=pt.ParamAttr(
                name="b", initializer=pt.initializer.TruncatedNormal(0, 1)))
        h = pt.layers.fc(h, size=17, param_attr=pt.ParamAttr(
            name="v", initializer=pt.initializer.Xavier()))
        h = pt.layers.dropout(h, 0.1, dropout_implementation="upscale_in_train")
    feed = {"x": np.random.RandomState(0).randn(64, 96).astype(np.float32)}
    runs = []
    for place in (pt.CPUPlace(), pt.CUDAPlace(0)):
        exe, scope = pt.Executor(place=place), pt.Scope()
        exe.run(startup, scope=scope)
        out = exe.run(main, feed=feed, fetch_list=[h], scope=scope)[0]
        runs.append([scope.find_var(n).cpu().numpy() for n in ("w", "b", "v")]
                    + [out])
    for name, a, b in zip(("w", "b", "v"), runs[0][:3], runs[1][:3]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the fc products sum in another order on the card: the masks decide
    np.testing.assert_array_equal(runs[0][3] == 0, runs[1][3] == 0)
