"""Threefry random bits and the fused dropout forward — K8, the kernel
behind the port's random-key stream.

The JAX package draws its random numbers through ``jax.random``, which
XLA compiles to threefry2x32: no Pallas kernel, so K8 replaces XLA's
generated code, not a TPU kernel of the repository. Its bytes are
``jax.random``'s (``core/prng.py`` holds the host copy the CPU tests hold
equal to JAX). Here:

* ``random_bits_plain`` / ``random_bits`` — ``jax.random.bits(key, (n,),
  uint32)`` as an int32 ``[n]`` (the uint32 words' bits);
* ``dropout_fwd_plain`` / ``dropout_fwd`` — the dropout op's forward:
  ``Out`` and ``Mask`` (in ``x.dtype``), with the mask of
  ``jax.random.bernoulli(key, 1 - p, x.shape)`` and, with ``upscale``,
  ``Out = x / (1 - p)`` where kept (a division, as the op's source
  divides), else ``Out = x * Mask``.

Every function takes a counter ``base`` (default 0): element ``i`` draws
the counter ``base + i``, so a call at ``base`` gives the slice ``[base,
base + n)`` of a larger draw (a data-parallel rank's rows of the global
batch's mask, ``parallel/data_parallel.py``).

A key is a pair of Python ints (``core/prng.py``); the kernel takes its
two words and the base as launch arguments, so a launch makes no device
sync. Each
wrapper launches K8 (``csrc/threefry.cu``) on a CUDA device or tensor and
counts the launch, or raises; on the CPU it computes the plain version.
The plain versions run on any device and are what the ``off`` mode runs.
"""

import ctypes

import numpy as np
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import registry

__all__ = ["random_bits", "random_bits_plain", "dropout_fwd",
           "dropout_fwd_plain", "keep_threshold"]

_SOURCE = "threefry.cu"
_fns = {}


def keep_threshold(p):
    """``1 - p`` as the float32 that ``jax.random.bernoulli`` compares the
    uniform draws with, and that upscaling divides by."""
    return prng.f32(1.0 - float(p))


def random_bits_plain(key, n, device, base=0):
    """``jax.random.bits(key, (n,), uint32)`` as int32 ``[n]`` on
    ``device``, in plain torch (int64 arithmetic masked to 32 bits)."""
    return prng.random_bits_torch(key, n, device, base)


def dropout_fwd_plain(x, key, p, upscale, base=0):
    """The dropout forward in plain torch: ``(Out, Mask)``."""
    keep = prng.bernoulli(random_bits_plain(key, x.numel(), x.device, base),
                          keep_threshold(p)).reshape(x.shape)
    mask = keep.to(x.dtype)
    if upscale:
        # a 0-d tensor divisor: torch multiplies by the reciprocal of a
        # Python scalar divisor on CUDA, which is not the same rounding
        scale = torch.full((), keep_threshold(p), dtype=x.dtype,
                           device=x.device)
        out = torch.where(keep, x / scale, torch.zeros_like(scale))
    else:
        out = x * mask
    return out, mask


def _fn(name, argtypes):
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = build.function(_SOURCE, name, argtypes)
    return fn


def _check(err, what):
    if err:
        msg = build.function(_SOURCE, "threefry_error_string",
                             [ctypes.c_int], ctypes.c_char_p)(err).decode()
        raise RuntimeError(f"threefry {what} launch failed: {msg} ({err})")


def _words(key):
    return ctypes.c_uint(int(key[0])), ctypes.c_uint(int(key[1]))


def random_bits(key, n, device, base=0):
    """K8's ``random_bits``: int32 ``[n]`` on ``device``. A CUDA device:
    one launch, no sync; the CPU: the plain version."""
    device = torch.device(device)
    if device.type != "cuda":
        return random_bits_plain(key, n, device, base)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    out = torch.empty(int(n), dtype=torch.int32, device=device)
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    fn = _fn("threefry_random_bits",
             [ctypes.c_int, p, ll, ctypes.c_uint, ctypes.c_uint,
              ctypes.c_ulonglong, p])
    k0, k1 = _words(key)
    _check(fn(index, out.data_ptr(), int(n), k0, k1, int(base),
              build.raw_stream_getter()(index)), "random_bits")
    registry.note_launch("threefry_random_bits")
    return out


def dropout_fwd(x, key, p, upscale, base=0):
    """K8's fused dropout forward: ``(Out, Mask)`` of float32 ``x``. A
    CUDA tensor: one launch, no sync (any other dtype raises); the CPU:
    the plain version."""
    if not x.is_cuda:
        return dropout_fwd_plain(x, key, p, upscale, base)
    if x.dtype != torch.float32:
        raise ValueError(f"the dropout kernel takes float32, got {x.dtype}")
    x = x.contiguous()
    out, mask = torch.empty_like(x), torch.empty_like(x)
    p_, ll, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    fn = _fn("threefry_dropout_f32",
             [ctypes.c_int, p_, p_, p_, ll, ctypes.c_uint, ctypes.c_uint,
              ctypes.c_ulonglong, f, f, ctypes.c_int, p_])
    keep = np.float32(keep_threshold(p))
    k0, k1 = _words(key)
    index = x.get_device()
    _check(fn(index, x.data_ptr(), out.data_ptr(), mask.data_ptr(),
              x.numel(), k0, k1, int(base), f(keep), f(keep),
              int(bool(upscale)),
              build.raw_stream_getter()(index)), "dropout")
    registry.note_launch("threefry_dropout")
    return out, mask
