"""Flash attention: the forward kernel and its two backward kernels.

The JAX package computes attention for training with three Pallas kernels
wrapped in a ``jax.custom_vjp`` (``paddle_tpu/ops/pallas/flash_attention.py``).
Here:

* ``flash_attention_composite`` (O and the LSE),
  ``flash_attention_bwd_dkdv_composite`` and
  ``flash_attention_bwd_dq_composite`` — the plain PyTorch versions of the
  three kernels, with their semantics and signatures, and
  ``flash_attention_bwd_composite`` (dq, dk, dv, dbias from the LSE), the
  whole backward in plain PyTorch;
* ``flash_attention_fwd`` / ``flash_attention_bwd_dkdv`` /
  ``flash_attention_bwd_dq`` — the wrappers of the three hand-written CUDA
  kernels in ``csrc/flash_attention.cu`` (K1, K2a, K2b). Each checks its
  CUDA tensors, launches its kernel or raises, and counts the launch;
* ``FlashAttention`` — the ``torch.autograd.Function``, the counterpart of
  the ``custom_vjp``. Its forward computes O and saves O and the LSE; its
  backward computes delta = rowsum(dO * O) and the head-sum of dbias in
  plain torch (the JAX package leaves both to XLA) around K2a and K2b. On
  CUDA tensors it launches the kernels, on CPU tensors it computes the
  plain versions;
* ``flash_attention`` — the entry point of the op's kernel lowering.

Layout: q, k, v ``[B, H, S, D]``; ``bias`` an optional additive key bias
``[B, S]``; ``causal`` masks ``cols > rows`` with -1e30. The kernels take
float32 with D a multiple of 4 up to 128, or bf16 or float16 (AMP's
operand types) with D a multiple of 8 up to 128, at any S. They sum in
another order than the composites, so the two agree to a stated
tolerance (``chip_smoke.py`` checks it on the card), not bit for bit. The
float32 builds take every product on the tensor cores in the 3xTF32 split
(each operand as a TF32 big part plus a TF32 small part, three products
summed in f32), which keeps float32 accuracy where plain TF32 would not
(``tests/test_torch_flash_attention.py`` emulates both). The 16-bit builds
take one bf16 or f16 product with f32 accumulation, and round where the
Pallas kernel rounds under AMP: scores and the softmax stay f32, P is
rounded to the operand type only for ``P V`` (the normaliser sums the
unrounded P), P and dS before their backward products; O, dQ, dK and dV
come out in the operand type, LSE and dbias in float32. The plain versions
round at the same points. A 16-bit build's launches count under
``<kernel>_bf16`` or ``<kernel>_f16``. Two launches on the same inputs give
the same bits.
"""

import ctypes
import math

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import registry

__all__ = [
    "FlashAttention", "flash_attention", "flash_attention_composite",
    "flash_attention_bwd_dkdv_composite", "flash_attention_bwd_dq_composite",
    "flash_attention_bwd_composite", "flash_attention_fwd",
    "flash_attention_bwd_dkdv", "flash_attention_bwd_dq", "kernel_name",
]

_SOURCE = "flash_attention.cu"
_NEG = -1e30
_MAX_D = 128
#: the kernels' builds by operand type: the C entry points' suffix and the
#: head width's required multiple (a 16-byte copy is 4 or 8 values)
_BUILDS = {torch.float32: ("f32", 4), torch.bfloat16: ("bf16", 8),
           torch.float16: ("f16", 8)}
_LOW = (torch.bfloat16, torch.float16)


def _round(x, dtype):
    """float32 ``x`` rounded to the 16-bit operand type ``dtype`` (as float32
    again), where the kernels round it before a product; ``x`` itself for
    wider types."""
    return x.to(dtype).float() if dtype in _LOW else x


def kernel_name(base, dtype):
    """The launch-count name of kernel ``base``'s build for ``dtype``:
    ``base`` for float32, ``base_bf16`` / ``base_f16`` for the 16-bit
    builds."""
    suffix = _BUILDS[dtype][0]
    return base if suffix == "f32" else f"{base}_{suffix}"


def _scores(q, k, bias, causal, sm_scale):
    """The masked, scaled score matrix ``[B, H, S, S]`` in float32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    if causal:
        S = q.shape[2]
        keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full((), _NEG, device=s.device))
    return s


def flash_attention_composite(q, k, v, bias, causal, sm_scale):
    """(O ``[B, H, S, D]``, LSE ``[B, H, S]`` float32): the forward
    kernel's function in plain PyTorch. For 16-bit operands it rounds as
    the Pallas kernel does: P to the operand type for ``P V`` only, the
    normaliser over the unrounded f32 P (``paddle_tpu/ops/pallas/
    flash_attention.py:70-75``)."""
    s = _scores(q, k, bias, causal, sm_scale)
    if q.dtype not in _LOW:
        out = torch.matmul(torch.softmax(s, dim=-1), v.float())
        return out.to(q.dtype), torch.logsumexp(s, dim=-1)
    m = s.amax(dim=-1, keepdim=True).clamp_min(_NEG)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones((), device=l.device), l)
    out = torch.matmul(_round(p, q.dtype), v.float()) / l
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs(q, k, bias, lse, causal, sm_scale):
    """exp(s - lse), 0 on a row whose LSE marks no live key."""
    s = _scores(q, k, bias, causal, sm_scale)
    lse = lse[..., None]
    return torch.where(lse <= _NEG / 2, torch.zeros((), device=s.device),
                       torch.exp(s - lse))


def flash_attention_bwd_dkdv_composite(q, k, v, bias, dout, lse, delta, causal,
                                       sm_scale, want_dbias=True):
    """(dk, dv, per-head dbias ``[B, H, S]``): K2a's function. dbias is
    None without a bias or when ``want_dbias`` is false. 16-bit operands
    round P and dS before their products; dbias sums the f32 dS."""
    p = _probs(q, k, bias, lse, causal, sm_scale)
    g = dout.float()
    dv = torch.matmul(_round(p, q.dtype).transpose(-1, -2), g)
    ds = p * (torch.matmul(g, v.float().transpose(-1, -2)) - delta[..., None])
    dk = torch.matmul(_round(ds, q.dtype).transpose(-1, -2), q.float()) * sm_scale
    dbias = ds.sum(dim=2) if bias is not None and want_dbias else None
    return dk.to(k.dtype), dv.to(v.dtype), dbias


def flash_attention_bwd_dq_composite(q, k, v, bias, dout, lse, delta, causal,
                                     sm_scale):
    """dq: K2b's function (16-bit operands round dS before its product)."""
    p = _probs(q, k, bias, lse, causal, sm_scale)
    g = dout.float()
    ds = p * (torch.matmul(g, v.float().transpose(-1, -2)) - delta[..., None])
    return (torch.matmul(_round(ds, q.dtype), k.float()) * sm_scale).to(q.dtype)


def _backward(dkdv, dq_fn, q, k, v, bias, out, lse, dout, causal, sm_scale,
              want_dbias=True):
    # delta = rowsum(dO * O) and the head-sum of dbias: plain torch around
    # the two backward functions (the JAX package leaves both to XLA)
    delta = (dout.float() * out.float()).sum(-1)
    dk, dv, dbias = dkdv(q, k, v, bias, dout, lse, delta, causal, sm_scale,
                         want_dbias)
    dq = dq_fn(q, k, v, bias, dout, lse, delta, causal, sm_scale)
    return dq, dk, dv, None if dbias is None else dbias.sum(dim=1)


def flash_attention_bwd_composite(q, k, v, bias, out, lse, dout, causal,
                                  sm_scale):
    """(dq, dk, dv, dbias) from the saved O and LSE in plain PyTorch.
    ``dbias`` is ``[B, S]`` (summed over queries and heads), None without
    a bias."""
    return _backward(flash_attention_bwd_dkdv_composite,
                     flash_attention_bwd_dq_composite, q, k, v, bias, out, lse,
                     dout, causal, sm_scale)


# -- the CUDA kernels ---------------------------------------------------------


def _declare(lib):
    """Declares the C entry points' argument and result types on ``lib``, a
    build of ``csrc/flash_attention.cu`` (or of a variant of it), and
    returns it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [i, i, i, i, ctypes.c_float, i, p]   # BH, H, S, D, scale, causal, stream
    for suffix, _ in _BUILDS.values():
        for name, pointers in (("fwd", 6), ("bwd_dq", 8), ("bwd_dkdv", 10)):
            fn = getattr(lib, f"flash_attention_{name}_{suffix}")
            fn.argtypes = [p] * pointers + tail
            fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _lib():
    lib = build.load(_SOURCE)
    if lib.flash_attention_fwd_f32.argtypes is None:
        _declare(lib)
    return lib


def _check(name, t, shape, device, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _checked_shapes(q, k, v, bias):
    B, H, S, D = q.shape
    if q.dtype not in _BUILDS:
        raise TypeError(f"q has dtype {q.dtype}; the flash-attention kernels "
                        "take float32, bfloat16 or float16")
    multiple = _BUILDS[q.dtype][1]
    if D % multiple or D > _MAX_D:
        raise ValueError(f"flash attention: head width {D} is not a multiple "
                         f"of {multiple} up to {_MAX_D} ({q.dtype})")
    if q.device.type != "cuda":
        raise ValueError(f"the flash-attention kernels take CUDA tensors, "
                         f"q is on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, (B, H, S, D), q.device, q.dtype)
    if bias is not None:
        _check("bias", bias, (B, S), q.device)
    return B, H, S, D


def _ptr(t):
    return None if t is None else t.data_ptr()


def _call(base, dtype, args, device):
    """Launches kernel ``base``'s build for ``dtype`` and counts it."""
    lib = _lib()
    name = kernel_name(base, dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"{base}_{_BUILDS[dtype][0]}")(*args, stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    registry.note_launch(name)


def flash_attention_fwd(q, k, v, bias, causal, sm_scale):
    """K1: (O, LSE) of contiguous float32, bf16 or float16 CUDA tensors
    (the bias float32)."""
    B, H, S, D = _checked_shapes(q, k, v, bias)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _call("flash_attention_fwd", q.dtype,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), out.data_ptr(),
           lse.data_ptr(), B * H, H, S, D, float(sm_scale), int(causal)),
          q.device)
    return out, lse


def _check_bwd(q, dout, lse, delta):
    B, H, S, D = q.shape
    _check("dout", dout, (B, H, S, D), q.device, q.dtype)
    _check("lse", lse, (B, H, S), q.device)
    _check("delta", delta, (B, H, S), q.device)


def flash_attention_bwd_dkdv(q, k, v, bias, dout, lse, delta, causal, sm_scale,
                             want_dbias=True):
    """K2a: (dk, dv, per-head dbias ``[B, H, S]``); dbias is None, and the
    kernel writes none, without a bias or when ``want_dbias`` is false."""
    B, H, S, D = _checked_shapes(q, k, v, bias)
    _check_bwd(q, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
             if bias is not None and want_dbias else None)
    _call("flash_attention_bwd_dkdv", q.dtype,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), dout.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           _ptr(dbias), B * H, H, S, D, float(sm_scale), int(causal)),
          q.device)
    return dk, dv, dbias


def flash_attention_bwd_dq(q, k, v, bias, dout, lse, delta, causal, sm_scale):
    """K2b: dq."""
    B, H, S, D = _checked_shapes(q, k, v, bias)
    _check_bwd(q, dout, lse, delta)
    dq = torch.empty_like(q)
    _call("flash_attention_bwd_dq", q.dtype,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), dout.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H, H, S, D,
           float(sm_scale), int(causal)),
          q.device)
    return dq


class FlashAttention(torch.autograd.Function):
    """O = attention(q, k, v, bias); backward from the saved O and LSE. The
    CUDA kernels for CUDA tensors, the plain versions for CPU ones."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale):
        fwd = (flash_attention_fwd if q.device.type == "cuda"
               else flash_attention_composite)
        out, lse = fwd(q, k, v, bias, causal, sm_scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            fns = (flash_attention_bwd_dkdv, flash_attention_bwd_dq)
        else:
            fns = (flash_attention_bwd_dkdv_composite,
                   flash_attention_bwd_dq_composite)
        # a bias nobody differentiates (BERT's padding mask) gets no dbias
        grads = _backward(*fns, q, k, v, bias, out, lse, dout.contiguous(),
                          ctx.causal, ctx.sm_scale, ctx.needs_input_grad[3])
        return (*grads, None, None)


def flash_attention(q, k, v, bias=None, causal=False, sm_scale=None):
    """Fused attention over ``[B, H, S, D]`` tensors, differentiable: the
    CUDA kernels for CUDA tensors, the plain versions for CPU ones. A
    failed build or launch raises."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    # mixed operand types are promoted once, as the JAX op does
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    q, k, v = (t.to(dt).contiguous() for t in (q, k, v))
    if bias is not None:
        bias = bias.contiguous()
    return FlashAttention.apply(q, k, v, bias, bool(causal), float(sm_scale))
