"""Sparse row update: ``param[ids[i]] += rows[i]`` for distinct ids, in
place — the row write of ``sgd_sparse`` under
``FLAGS_pallas_sparse_update``.

The JAX package serves it with a Pallas kernel
(``paddle_tpu/ops/pallas/sparse_update.py``) that walks a sequential grid
over the unique ids, padded with fill rows that repeat id 0 and ordered
pads-first so a fill row cannot overwrite the real id-0 update. Here:

* ``sparse_row_update_plain`` — the plain version, ``param.index_add_``
  over the first ``n_unique`` rows;
* ``sparse_row_update`` — the wrapper of the hand-written CUDA kernel in
  ``csrc/sparse_update.cu`` (K6): on a CUDA ``param`` it launches the
  kernel (or raises) and counts the launch; on a CPU ``param`` it computes
  the plain version. CUDA blocks run in no order, so the kernel never
  touches a row at or past ``n_unique``: the caller passes the real unique
  count, and fill rows past it are ignored (no pads-first trick).

Both check on the host that the first ``n_unique`` ids lie in ``[0, V)``
and raise otherwise (one sync with the card): an id outside is a caller's
bug, which ``index_add_`` reports and the kernel would otherwise skip, or
write to another row after the cast to int32.

Both update the caller's ``param`` tensor in place (the counterpart of the
JAX kernel's aliased output) and return it; they give the same bits, since
each element gets exactly one add.
"""

import ctypes

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import registry

__all__ = ["sparse_row_update", "sparse_row_update_plain", "launch"]

_SOURCE = "sparse_update.cu"


def _checked(param, ids, rows, n_unique):
    if param.dim() != 2:
        raise ValueError(f"param must be [V, D], got {tuple(param.shape)}")
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids must be a 1-D int32/int64 tensor, got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    n = ids.shape[0]
    if tuple(rows.shape) != (n, param.shape[1]):
        raise ValueError(f"rows have shape {tuple(rows.shape)}, expected "
                         f"{(n, param.shape[1])}")
    n_unique = n if n_unique is None else int(n_unique)
    if not 0 <= n_unique <= n:
        raise ValueError(f"n_unique {n_unique} outside [0, {n}]")
    if n_unique:
        lo, hi = torch.stack(torch.aminmax(ids[:n_unique])).tolist()
        if lo < 0 or hi >= param.shape[0]:
            raise ValueError(f"sparse row update: id outside [0, "
                             f"{param.shape[0]}): min {lo}, max {hi}")
    return n_unique


def sparse_row_update_plain(param, ids, rows, n_unique=None):
    """``param[ids[i]] += rows[i]`` for ``i < n_unique`` (default: every
    row), in place, by ``index_add_``. Returns ``param``."""
    n = _checked(param, ids, rows, n_unique)
    return param.index_add_(0, ids[:n].to(torch.int64),
                            rows[:n].to(param.dtype))


def _lib():
    lib = build.load(_SOURCE)
    fn = lib.sparse_row_update_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        ll = ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, ll, p]
        fn.restype = ctypes.c_int
        lib.sparse_row_update_error_string.argtypes = [ctypes.c_int]
        lib.sparse_row_update_error_string.restype = ctypes.c_char_p
    return lib


def launch(param, ids, rows, n_unique):
    """Launch K6 on CUDA tensors (``ids`` int32 ``[N]``, the first
    ``n_unique`` distinct and in ``[0, V)``, which ``sparse_row_update``
    checks; ``rows`` contiguous float32 ``[N, D]``), counting the launch.
    Returns ``param``."""
    if param.dtype != torch.float32 or not param.is_contiguous():
        raise ValueError("the kernel takes a contiguous float32 param")
    if param.shape[0] >= 2**31:
        raise ValueError("the kernel indexes param rows with int32")
    if ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous int32 tensor")
    if rows.dtype != torch.float32 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous float32 tensor")
    if ids.device != param.device or rows.device != param.device:
        raise ValueError("ids and rows must be on param's device")
    lib = _lib()
    with torch.cuda.device(param.device):
        stream = torch.cuda.current_stream(param.device).cuda_stream
        err = lib.sparse_row_update_f32(
            param.data_ptr(), ids.data_ptr(), rows.data_ptr(), n_unique,
            param.shape[0], param.shape[1], stream)
    if err != 0:
        msg = lib.sparse_row_update_error_string(err).decode()
        raise RuntimeError(f"sparse_row_update kernel launch failed: "
                           f"{msg} ({err})")
    registry.note_launch("sparse_row_update")
    return param


def sparse_row_update(param, ids, rows, n_unique=None):
    """K6's wrapper: ``param[ids[i]] += rows[i]`` in place for
    ``i < n_unique`` (the first ``n_unique`` ids distinct; rows past it are
    fill rows and are never touched). CUDA ``param``: the kernel; CPU: the
    plain version. An id outside ``[0, V)`` raises. Returns ``param``."""
    if param.device.type != "cuda":
        return sparse_row_update_plain(param, ids, rows, n_unique)
    n = _checked(param, ids, rows, n_unique)
    return launch(param, ids.to(torch.int32).contiguous(), rows.to(
        torch.float32).contiguous(), n)
