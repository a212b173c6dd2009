"""bf16 AMP on the card: the bf16 and float16 builds of the flash kernels
(K1, K2a, K2b) against their plain versions in the same type, and the
16-bit product guard of ``ops/math.py``. Marked ``cuda``: it skips
without a card and runs on one with

    python -m pytest --noconftest -m cuda tests/test_torch_amp_cuda.py -q

Kernel bars (``chip_smoke.py`` phase 2f's): each output within 1e-2 of
its largest magnitude, plus 1e-5 (the float32 kernels' atol) for outputs
that are zero in exact arithmetic and hold float32 rounding alone (a
single key's dS, for one), the LSE within rtol = atol = 1e-5. Both sides
round P and dS to the operand type before their products, the kernel
against the running maximum of its 32-key tiles, so an element may land
a 16-bit step away.

The product guard: cuBLAS may reduce a bf16 or float16 product in the low
type where PyTorch's ``allow_bf16_reduced_precision_reduction`` /
``allow_fp16_reduced_precision_reduction`` allow it (both True by
default); XLA sums such a dot in float32. With the flags on, a ``mul``
through the executor holds the float32-accumulated bar against a float64
reference (its error in norm within 5% of the exactly rounded result's)
where the same product straight through torch misses it (1.4x) at a
shape where cuBLAS takes a low-type reduction, and the caller's flags are
set again after the run. It also reads BERT-base's and ResNet-50's
product shapes.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.kernels import flash_attention as FA

pytestmark = pytest.mark.cuda

TOL, ATOL, LSE_TOL = 1e-2, 1e-5, (1e-5, 1e-5)
SHAPES = [  # B, H, S, D
    (32, 12, 128, 64),
    (2, 3, 100, 96),
    (1, 2, 37, 128),
    (3, 1, 200, 8),
    (2, 4, 64, 32),
    (2, 2, 1, 64),
    (2, 3, 17, 16),
    (2, 2, 129, 64),
    (1, 2, 512, 64),
]
DTYPES = [torch.bfloat16, torch.float16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(dev, dtype, B, H, S, D, with_bias, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(B, H, S, D, generator=gen, device=dev).to(dtype)
                     for _ in range(4))
    bias = None
    if with_bias:
        keep = torch.randint(max(S // 2, 1), S + 1, (B, 1), generator=gen,
                             device=dev)
        bias = torch.where(torch.arange(S, device=dev)[None] < keep, 0.0,
                           -10000.0).contiguous()
    return q, k, v, dout, bias


def _close(name, got, want, frac=TOL):
    assert got.dtype == want.dtype, name
    assert bool(torch.isfinite(got).all()), name
    err = float((got.float() - want.float()).abs().max())
    bar = frac * float(want.float().abs().max()) + ATOL
    assert err <= bar, (name, err, bar)


def _check_all(q, k, v, dout, bias, causal):
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    o, lse = FA.flash_attention_fwd(q, k, v, bias, causal, scale)
    o_p, lse_p = FA.flash_attention_composite(q, k, v, bias, causal, scale)
    _close("O", o, o_p)
    torch.testing.assert_close(lse, lse_p, rtol=LSE_TOL[0], atol=LSE_TOL[1])
    delta = (dout.float() * o_p.float()).sum(-1)
    args = (q, k, v, bias, dout, lse_p, delta, causal, scale)
    dk, dv, db = FA.flash_attention_bwd_dkdv(*args)
    dk_p, dv_p, db_p = FA.flash_attention_bwd_dkdv_composite(*args)
    _close("dK", dk, dk_p)
    _close("dV", dv, dv_p)
    if bias is not None:
        _close("dbias", db, db_p)
    _close("dQ", FA.flash_attention_bwd_dq(*args),
           FA.flash_attention_bwd_dq_composite(*args))
    return o, lse


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_16bit_kernels_match_their_plain_versions(dev, shape, with_bias, causal,
                                                  dtype):
    q, k, v, dout, bias = _inputs(dev, dtype, *shape, with_bias, seed=sum(shape))
    _check_all(q, k, v, dout, bias, causal)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f16"])
@pytest.mark.parametrize("masked", [-1e30, float("-inf")])
def test_a_row_whose_keys_are_all_masked(dev, dtype, masked):
    """Batch row 0 masks every key: with -1e30 every score ties and O is
    the mean of V with a dead LSE (no grad flows back); with -inf the
    kernel's ``l == 0`` branch gives O = 0."""
    q, k, v, dout, bias = _inputs(dev, dtype, 2, 3, 40, 64, True, seed=11)
    bias[0] = masked
    o, lse = _check_all(q, k, v, dout, bias, False)
    if masked == float("-inf"):
        assert not bool(o[0].any())
    assert bool((lse[0] <= -5e29).all())


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f16"])
def test_two_launches_give_the_same_bits_and_count_by_type(dev, dtype):
    from paddle_tpu_torch import kernels

    q, k, v, dout, bias = _inputs(dev, dtype, 4, 2, 96, 64, True, seed=5)
    kernels.reset_launches()
    a = FA.flash_attention_fwd(q, k, v, bias, True, 0.125)
    b = FA.flash_attention_fwd(q, k, v, bias, True, 0.125)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    name = FA.kernel_name("flash_attention_fwd", dtype)
    assert kernels.launches(name) == 2 and name.endswith(("_bf16", "_f16"))
    assert kernels.launches("flash_attention_fwd") == 0


def test_the_autograd_function_in_bf16(dev):
    q, k, v, dout, bias = _inputs(dev, torch.bfloat16, 2, 12, 128, 64, True, 3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FA.flash_attention(*leaves, bias=bias, causal=False)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, leaves, dout)
    o_p, lse_p = FA.flash_attention_composite(q, k, v, bias, False, 0.125)
    want = FA.flash_attention_bwd_composite(q, k, v, bias, o_p, lse_p, dout,
                                            False, 0.125)
    _close("O", out.detach(), o_p)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        _close(name, g, w)


def test_a_head_width_that_is_no_multiple_of_8_is_refused(dev):
    q = torch.zeros(1, 1, 8, 12, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        FA.flash_attention_fwd(q, q, q, None, False, 0.3)


# -- the 16-bit product guard ---------------------------------------------------
# (M, K, N) of ``mul`` [M, K] x [K, N]: the first is a shape where cuBLAS
# (torch 2.11, CUDA 12.8, H100) takes a low-type reduction when allowed,
# 1.41x the error of the exactly rounded product in bf16 and float16; the
# rest are the products of BERT-base's step at batch 32, seq 128, P = 20
# (the fc layers, the MLM output) and ResNet-50's fc at batch 128, where
# it took none in that build. Each shape's readings are printed (``-s``).
PRODUCTS = [(256, 1 << 16, 256), (4096, 768, 3072), (4096, 3072, 768),
            (640, 768, 30522), (128, 2048, 1000)]
LOW_TYPE_REDUCTION = {(256, 1 << 16, 256)}


def _product_inputs(dev, dtype, M, K, N):
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(M, K, device=dev, generator=gen)
    y = torch.randn(K, N, device=dev, generator=gen)
    if dtype == torch.float16:                  # keep the sums in range
        x, y = x * 0.05, y * 0.05
    x16, y16 = x.to(dtype), y.to(dtype)
    # the reference: the 16-bit values' exact products summed in float64
    return x16, y16, x16.double() @ y16.double()


def _err(got, ref):
    return float(torch.linalg.norm(got.double() - ref) / torch.linalg.norm(ref))


def _mul_program(dtype, M, K, N):
    """One ``mul`` op (the fc product AMP casts to the low type)."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.data("x", shape=[M, K], dtype=dtype)
        y = pt.data("y", shape=[K, N], dtype=dtype)
    block = main.global_block()
    out = block.create_var(name="out", shape=[M, N], dtype=dtype)
    block.append_op("mul", {"X": [x.name], "Y": [y.name]}, {"Out": [out.name]},
                    {"x_num_col_dims": 1, "y_num_col_dims": 1})
    return main, startup, out


@pytest.mark.parametrize("shape", PRODUCTS, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f16"])
def test_16bit_mul_sums_in_float32_with_reduced_precision_allowed(dev, dtype,
                                                                  shape):
    name = ("allow_bf16_reduced_precision_reduction" if dtype == torch.bfloat16
            else "allow_fp16_reduced_precision_reduction")
    matmul = torch.backends.cuda.matmul
    x16, y16, ref = _product_inputs(dev, dtype, *shape)
    rounded_once = _err(ref.to(dtype), ref)     # the output's own rounding
    saved = getattr(matmul, name)
    try:
        setattr(matmul, name, True)
        main, startup, out = _mul_program(dtype, *shape)
        exe, scope = pt.Executor(), pt.Scope()
        exe.run(startup, scope=scope)
        (got,) = exe.run(main, feed={"x": x16, "y": y16},
                         fetch_list=[out.name], scope=scope, return_numpy=False)
        assert getattr(matmul, name) is True, "the caller's flag was changed"
        control = x16 @ y16                     # straight through torch
    finally:
        setattr(matmul, name, saved)
    assert got.dtype == dtype
    err, control_err = _err(got, ref), _err(control, ref)
    print(f"{dtype} {'x'.join(map(str, shape))}: guarded {err:.4e}, bare "
          f"matmul {control_err:.4e}, rounded once {rounded_once:.4e}")
    # summed in float32 (about 1e-5 of the result off the exact sum) then
    # rounded once: a few results round the other way, so within 5% of
    # the exactly rounded result's error
    assert err <= rounded_once * 1.05, (err, rounded_once)
    if shape in LOW_TYPE_REDUCTION:
        # the bare product, reduced in the low type, misses that by far
        # more: without it this test would show nothing
        assert 1.2 * rounded_once < control_err, (rounded_once, control_err)
