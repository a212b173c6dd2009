"""The 16-bit plain versions of the port's flash-attention kernels (K1, K2a,
K2b at bf16 and float16, the operand types under AMP) against the JAX
package's Pallas kernels in interpret mode at the same type, as
tests/test_torch_flash_attention.py holds the float32 ones.

Inputs: {causal, not} x {bias with some masked keys, none} x {S = 32 with
blocks 16/8, S = 24 (ragged: the JAX wrapper halves its blocks to 8)}, in
bf16 and in float16, rounded from the same float32 numbers in both
packages. Both sides round P to the operand type for ``P V`` and P and dS
before the backward products, and O, dQ, dK, dV at the end; the Pallas
kernel rounds P against the running maximum of its 8-key blocks where the
plain version takes the row's final one, and the two sum in other orders,
so an element can land one 16-bit step apart. Bars: O, dQ, dK, dV and
dbias within 1e-2 of their largest magnitude; the LSE (f32 from exact
products of 16-bit values) within rtol = atol = 1e-5. The CUDA builds run
only on the card (tests/test_torch_amp_cuda.py, chip_smoke.py phase 2f).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jax_flash
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import flash_attention as torch_flash

B, H, D = 2, 2, 16
SCALE = 1.0 / np.sqrt(D)
TOL, LSE_TOL = 1e-2, 1e-5
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _inputs(S, with_bias, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, dout = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(4))
    bias = (np.where(rng.rand(B, S) > 0.25, 0.0, -1e9).astype(np.float32)
            if with_bias else None)
    return q, k, v, bias, dout


def _halved(S, block):
    block = min(block, S)
    while S % block:
        block //= 2
    return block


def _f32(x):
    """A JAX or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(name, got, want, frac=TOL):
    got, want = _f32(got), _f32(want)
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (name, err, np.abs(want).max())


@pytest.fixture(autouse=True)
def _zero_counters():
    kernels.reset_launches()
    yield
    assert all(n == 0 for n in kernels.launches().values())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("S,block_q,block_k", [(32, 16, 8), (24, 16, 8)])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_16bit_plain_versions_match_the_pallas_kernels(causal, with_bias, S,
                                                       block_q, block_k, dtype):
    tdt, jdt = DTYPES[dtype]
    q, k, v, bias, dout = _inputs(S, with_bias)
    jq, jk, jv, jg = (jnp.asarray(a).astype(jdt) for a in (q, k, v, dout))
    jb = None if bias is None else jnp.asarray(bias)
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, dout))
    tb = None if bias is None else torch.from_numpy(bias)
    # the same 16-bit inputs in both packages
    np.testing.assert_array_equal(_f32(tq), _f32(jq))

    def pallas(q_, k_, v_, b_):
        return jax_flash.flash_attention(q_, k_, v_, bias=b_, causal=causal,
                                         sm_scale=SCALE, block_q=block_q,
                                         block_k=block_k, interpret=True)

    @jax.jit
    def forward_and_vjp(q_, k_, v_, b_, g_):
        # one compile for both (interpret mode runs far faster compiled)
        o_, lse_ = jax_flash._fwd_impl(q_, k_, v_, b_, SCALE, causal,
                                       _halved(S, block_q),
                                       _halved(S, block_k), True)
        return o_, lse_, jax.vjp(pallas, q_, k_, v_, b_)[1](g_)

    want_o, want_lse, want = forward_and_vjp(jq, jk, jv, jb, jg)
    o, lse = torch_flash.flash_attention_composite(tq, tk, tv, tb, causal, SCALE)
    assert o.dtype == tdt and want_o.dtype == jdt
    assert lse.dtype == torch.float32 and want_lse.dtype == jnp.float32
    _close("O", o, want_o)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=LSE_TOL, atol=LSE_TOL)

    got = torch_flash.flash_attention_bwd_composite(
        tq, tk, tv, tb, o, lse, tg, causal, SCALE)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if name == "dbias" and bias is None:
            assert g is None and w is None
            continue
        assert g.dtype == (torch.float32 if name == "dbias" else tdt), name
        _close(name, g, w)


def test_the_autograd_function_gives_grads_in_the_operand_types():
    """``FlashAttention`` on CPU bf16 tensors: O, dq, dk, dv in bf16, the
    bias grad float32 (the JAX custom_vjp's contract), all equal to the
    plain backward's."""
    q, k, v, bias, dout = _inputs(24, True, seed=3)
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                      for a in (q, k, v, dout))
    tb = torch.from_numpy(bias).requires_grad_()
    out = torch_flash.flash_attention(tq, tk, tv, bias=tb, causal=True,
                                      sm_scale=SCALE)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, (tq, tk, tv, tb), tg.detach())
    o, lse = torch_flash.flash_attention_composite(
        tq.detach(), tk.detach(), tv.detach(), tb.detach(), True, SCALE)
    want = torch_flash.flash_attention_bwd_composite(
        tq.detach(), tk.detach(), tv.detach(), tb.detach(), o, lse,
        tg.detach(), True, SCALE)
    for g, w in zip(grads, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3 + [torch.float32]


def test_16bit_rounding_is_where_the_pallas_kernel_rounds():
    """Dropping the rounding of P before ``P V`` moves O by more than the
    plain version's distance from the Pallas kernel: the plain version
    rounds where the kernel does, and the test above would see it if it
    did not."""
    q, k, v, bias, _ = _inputs(32, True, seed=5)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want_o, _ = jax_flash._fwd_impl(jq, jk, jv, jnp.asarray(bias), SCALE, False,
                                    32, 32, True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    o, _ = torch_flash.flash_attention_composite(tq, tk, tv,
                                                 torch.from_numpy(bias), False,
                                                 SCALE)
    # unrounded P: the float32 function, rounded once at the end
    o32, _ = torch_flash.flash_attention_composite(
        tq.float(), tk.float(), tv.float(), torch.from_numpy(bias), False, SCALE)
    ours = np.abs(_f32(o) - _f32(want_o)).max()
    unrounded = np.abs(_f32(o32.to(torch.bfloat16)) - _f32(want_o)).max()
    assert ours < unrounded, (ours, unrounded)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_the_kernels_refuse_a_head_width_that_is_no_multiple_of_8(dtype):
    """A 16-byte copy is 8 values of a 16-bit type; the wrappers check that
    (and the CUDA device) before anything is built."""
    q = torch.zeros(1, 1, 8, 12, dtype=dtype)
    with pytest.raises(ValueError, match="multiple of 8"):
        torch_flash.flash_attention_fwd(q, q, q, None, False, 0.3)
    q = torch.zeros(1, 1, 8, 16, dtype=dtype)
    with pytest.raises(ValueError, match="CUDA"):
        torch_flash.flash_attention_fwd(q, q, q, None, False, 0.25)


def test_kernel_names_of_the_builds():
    assert torch_flash.kernel_name("flash_attention_fwd", torch.float32) == \
        "flash_attention_fwd"
    assert torch_flash.kernel_name("flash_attention_bwd_dq", torch.bfloat16) == \
        "flash_attention_bwd_dq_bf16"
    assert torch_flash.kernel_name("flash_attention_bwd_dkdv", torch.float16) == \
        "flash_attention_bwd_dkdv_f16"
    for dt in ("bf16", "f16"):
        for base in ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                     "flash_attention_bwd_dq"):
            assert kernels.KERNELS[f"{base}_{dt}"] == kernels.KERNELS[base]
