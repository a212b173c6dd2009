"""Blocked top-k of |x|: the DGC wire builder (K7).

``blocked_topk_abs(x, k, block)`` returns the top ``k`` values of ``|x|``
of a 1-D ``x`` and their indices, exactly ``lax.top_k``'s result:
descending value, ties by lower index; float32 values, int32 indices. It
replaces the JAX package's ``paddle_tpu/ops/pallas/topk.py`` (the Pallas
kernel's ``pl.pallas_call`` at :66), with the same contract:

* below ``n <= 2k`` or ``n <= block`` it is the exact top-k of the whole
  vector, without the kernel (``topk_abs_exact``);
* otherwise a per-block stage keeps each block's top ``min(k, block)``
  entries (pad lanes past ``n`` count as -1 and are never chosen), and an
  exact selection over those candidates, outside the kernel as in JAX,
  gives the result. Every global top-k element is in its own block's top
  ``min(k, block)``, so the result stays exact for any ``k``, also for
  ``k > block`` (the Pallas body's ``lax.top_k(v, k)`` cannot trace that).

The stage lists each block's candidates in index order, blocks in order,
so the candidates are in global index order and a stable descending sort
over them (``_select``) breaks ties by lower index. Here:

* ``blocked_topk_stage_plain`` — the plain version of the stage: pad to
  ``[nb, block]`` with -1, a stable descending sort per row, the first
  ``min(k, block)``, put back in index order;
* ``blocked_topk_stage`` — the wrapper of the hand-written CUDA kernel in
  ``csrc/topk.cu``: on a CUDA ``x`` it launches the kernel (or raises) and
  counts the launch; on a CPU ``x`` it computes the plain version;
* ``blocked_topk_abs`` / ``blocked_topk_abs_plain`` — the whole function
  through the one or the other stage.
"""

import ctypes

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import registry

__all__ = ["blocked_topk_abs", "blocked_topk_abs_plain", "blocked_topk_stage",
           "blocked_topk_stage_plain", "topk_abs_exact", "launch",
           "DEFAULT_BLOCK"]

_SOURCE = "topk.cu"
DEFAULT_BLOCK = 131072


def _checked(x, k, block):
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    if not 1 <= int(k) <= x.shape[0]:
        raise ValueError(f"k = {k} outside [1, {x.shape[0]}]")
    if int(block) < 1:
        raise ValueError(f"block must be positive, got {block}")
    return int(k), int(block)


def _sort_desc(v):
    """Stable descending sort: ties keep index order (lower index first)."""
    return torch.sort(v, descending=True, stable=True)


def topk_abs_exact(x, k):
    """The top ``k`` of ``|x|`` over the whole vector: (values f32, indices
    int32), descending value, ties by lower index (``lax.top_k``'s
    order)."""
    vals, order = _sort_desc(x.abs().to(torch.float32))
    return vals[:k], order[:k].to(torch.int32)


def blocked_topk_stage_plain(x, k, block=DEFAULT_BLOCK):
    """Each ``block``-element block's top ``min(k, block)`` of ``|x|`` (pad
    lanes -1), in index order: (values [nb * kk] f32, indices [nb * kk]
    int32 global)."""
    k, block = _checked(x, k, block)
    n = x.shape[0]
    nb = -(-n // block)
    kk = min(k, block)
    padded = torch.full((nb * block,), -1.0, dtype=torch.float32,
                        device=x.device)
    padded[:n] = x.abs().to(torch.float32)
    rows = padded.view(nb, block)
    chosen = _sort_desc(rows)[1][:, :kk]
    chosen = torch.sort(chosen, dim=1).values          # back to index order
    vals = torch.gather(rows, 1, chosen)
    base = torch.arange(nb, device=x.device, dtype=torch.int64)[:, None] * block
    return vals.reshape(-1), (chosen + base).to(torch.int32).reshape(-1)


def _lib():
    lib = build.load(_SOURCE)
    fn = lib.blocked_topk_abs_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
        lib.blocked_topk_error_string.argtypes = [ctypes.c_int]
        lib.blocked_topk_error_string.restype = ctypes.c_char_p
    return lib


def launch(x, k, block=DEFAULT_BLOCK):
    """Launch K7 on a contiguous float32 CUDA ``x``, counting the launch.
    Returns the stage's (values, indices), as ``blocked_topk_stage_plain``."""
    k, block = _checked(x, k, block)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous float32 x")
    n = x.shape[0]
    nb = -(-n // block)
    if nb * block >= 2**31:
        raise ValueError("the kernel indexes x with int32")
    kk = min(k, block)
    vals = torch.empty(nb * kk, dtype=torch.float32, device=x.device)
    idx = torch.empty(nb * kk, dtype=torch.int32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.blocked_topk_abs_f32(x.data_ptr(), vals.data_ptr(),
                                       idx.data_ptr(), n, block, kk, stream)
    if err != 0:
        msg = lib.blocked_topk_error_string(err).decode()
        raise RuntimeError(f"blocked_topk_abs kernel launch failed: {msg} "
                           f"({err})")
    registry.note_launch("blocked_topk_abs")
    return vals, idx


def blocked_topk_stage(x, k, block=DEFAULT_BLOCK):
    """K7's wrapper: the per-block stage. CUDA ``x``: the kernel; CPU: the
    plain version."""
    if x.device.type != "cuda":
        return blocked_topk_stage_plain(x, k, block)
    return launch(x.to(torch.float32).contiguous(), k, block)


def _select(vals, idx, k):
    """The exact top ``k`` of the candidates, which lie in global index
    order: a stable descending sort breaks ties by lower index."""
    order = _sort_desc(vals)[1][:k]
    return vals[order], idx[order]


def _blocked(x, k, block, stage):
    k, block = _checked(x, k, block)
    n = x.shape[0]
    if n <= 2 * k or n <= block:
        return topk_abs_exact(x, k)
    return _select(*stage(x, k, block), k)


def blocked_topk_abs(x, k, block=DEFAULT_BLOCK):
    """(top ``k`` values of ``|x|``, their int32 indices) of a 1-D ``x``,
    exact, descending value, ties by lower index; the per-block stage runs
    on K7 for a CUDA ``x``."""
    return _blocked(x, k, block, blocked_topk_stage)


def blocked_topk_abs_plain(x, k, block=DEFAULT_BLOCK):
    """``blocked_topk_abs`` through the plain stage on any device."""
    return _blocked(x, k, block, blocked_topk_stage_plain)
