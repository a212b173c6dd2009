"""Embedding admission on the device: the engine's gather and scatter.

The embedding engine (``embedding/store.py``) admits a batch's cache
misses by writing their host rows into slots of the device hot slab, and
reads back the rows of the slots it evicts. As in the JAX package's
``kernels/embedding.py``:

* ``read_rows(slab, slots)`` — gather ONLY the eviction victims' rows and
  copy them to the host (the write-back payload; an ``index_select``, as
  the JAX package's is a ``jnp.take`` outside any Pallas kernel). The copy
  syncs with the card, so it runs on the training thread before the
  scatter reuses the slots, and only host numpy goes to the push pool.
* ``admit_rows(slab, slots, rows)`` — pad the admission to a power-of-two
  bucket (``slot == capacity`` writes nowhere) and scatter the rows into
  the slab IN PLACE: the scope's own tensor is updated, the counterpart of
  the JAX package's donated buffer. Kernel mode ``off`` computes the plain
  version on the slab's device.

``scatter_rows`` is the wrapper of the hand-written CUDA kernel in
``csrc/embedding_admission.cu`` (K5, replacing ``_scatter_pallas``): on a
CUDA slab it launches the kernel or raises; on a CPU slab it computes the
plain version ``scatter_rows_plain``. Rows move byte for byte on every
path, so admission is bit-identical across devices, modes and capacities.

``roundtrips()`` counts reads of a whole slab to the host, as the JAX
package's ``admission_roundtrip_counter`` does for its legacy admission
path (the full ``[capacity, dim]`` slab through host numpy per batch).
The port has no such path (ROADMAP M11 brings the mesh-sharded slab and
its host branch), so the count stays 0: callers assert that it does.
"""

import ctypes

import numpy as np
import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import registry

__all__ = ["admit_bucket", "pad_slots", "read_rows", "admit_rows",
           "scatter_rows", "scatter_rows_plain", "launch", "roundtrips"]

_SOURCE = "embedding_admission.cu"
_roundtrips = 0


def roundtrips():
    """Whole-slab copies to the host since the process started."""
    return _roundtrips


def admit_bucket(n):
    """Power-of-2 admission bucket (>= 1)."""
    b = 1
    while b < n:
        b <<= 1
    return b


def pad_slots(slots, rows, capacity, dim, dtype):
    """Pad (slots, rows) to the bucket size; padded entries write
    NOWHERE (slot == capacity)."""
    n = len(slots)
    b = admit_bucket(max(n, 1))
    s = np.full((b,), capacity, dtype=np.int32)
    s[:n] = np.asarray(slots, dtype=np.int32)
    r = np.zeros((b, dim), dtype=dtype)
    if n:
        r[:n] = np.asarray(rows, dtype=dtype)
    return s, r


def read_rows(slab, slots):
    """``slab[slots]`` as a host array: only the victims' rows cross to
    the host (one sync with the card)."""
    idx = torch.as_tensor(np.asarray(slots, dtype=np.int64), device=slab.device)
    return slab.index_select(0, idx).cpu().numpy()


def admit_rows(slab, slots, rows):
    """Scatter the admitted ``rows`` (host ``[n, dim]``) into ``slab`` at
    ``slots`` (host ints), padded to the bucket, in place. Kernel mode
    ``off`` takes the plain version. Returns ``slab``."""
    s, r = pad_slots(slots, rows, slab.shape[0], slab.shape[1],
                     np.float32)
    if registry.mode() == "off":
        return scatter_rows_plain(slab, s, r)
    return scatter_rows(slab, s, r)


def _host_slots(slots, capacity):
    """The slots as a host int32 array, every one in ``[0, capacity]``:
    slots are built on the host, and a slot outside that range is a host
    bug that would write outside the slab."""
    if isinstance(slots, torch.Tensor):
        if slots.device.type != "cpu":
            raise ValueError("admission slots are built on the host: pass "
                             "them as a numpy array or a CPU tensor")
        slots = slots.numpy()
    s = np.asarray(slots)
    if s.ndim != 1 or s.dtype.kind not in "iu":
        raise ValueError(f"slots must be a 1-D integer array, got "
                         f"{s.dtype} {s.shape}")
    if s.size and (int(s.min()) < 0 or int(s.max()) > capacity):
        raise ValueError(f"admission slot outside [0, {capacity}]: "
                         f"min {int(s.min())}, max {int(s.max())}")
    return np.ascontiguousarray(s, dtype=np.int32)


def _device_rows(rows, m, slab):
    r = torch.as_tensor(rows)
    if tuple(r.shape) != (m, slab.shape[1]):
        raise ValueError(f"rows have shape {tuple(r.shape)}, expected "
                         f"{(m, slab.shape[1])}")
    if r.dtype != slab.dtype:
        raise TypeError(f"rows have dtype {r.dtype}, the slab {slab.dtype}")
    return r.to(slab.device).contiguous()


def scatter_rows_plain(slab, slots, rows):
    """The plain version: ``slab[kept] = rows[kept]`` over the entries
    whose slot is below the capacity, in place. ``slots`` are host ints
    (checked as ``scatter_rows`` checks them) or a tensor on the slab's
    device. Returns ``slab``."""
    if isinstance(slots, torch.Tensor) and slots.device == slab.device \
            and slab.device.type != "cpu":
        s = slots.to(torch.int64)
    else:
        s = torch.from_numpy(_host_slots(slots, slab.shape[0]).astype(
            np.int64)).to(slab.device)
    r = _device_rows(rows, len(s), slab)
    kept = s < slab.shape[0]
    slab[s[kept]] = r[kept]
    return slab


def _lib():
    lib = build.load(_SOURCE)
    fn = lib.embedding_admission_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        ll = ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, ll, p]
        fn.restype = ctypes.c_int
        lib.embedding_admission_error_string.argtypes = [ctypes.c_int]
        lib.embedding_admission_error_string.restype = ctypes.c_char_p
    return lib


def launch(slab, slots, rows):
    """Launch K5 on CUDA tensors (``slots`` int32 ``[M]`` in ``[0, C]``,
    which ``scatter_rows`` checks on the host before it uploads them;
    ``rows`` ``[M, D]``), counting the launch. Returns ``slab``."""
    if not slab.is_contiguous() or slab.dtype != torch.float32:
        raise ValueError("the slab must be a contiguous float32 tensor")
    if slots.dtype != torch.int32 or slots.device != slab.device:
        raise ValueError("slots must be int32 on the slab's device")
    if rows.device != slab.device or not rows.is_contiguous():
        raise ValueError("rows must be contiguous on the slab's device")
    lib = _lib()
    with torch.cuda.device(slab.device):
        stream = torch.cuda.current_stream(slab.device).cuda_stream
        err = lib.embedding_admission_f32(
            slab.data_ptr(), slots.data_ptr(), rows.data_ptr(),
            slots.numel(), slab.shape[0], slab.shape[1], stream)
    if err != 0:
        msg = lib.embedding_admission_error_string(err).decode()
        raise RuntimeError(f"embedding_admission kernel launch failed: "
                           f"{msg} ({err})")
    registry.note_launch("embedding_admission")
    return slab


def scatter_rows(slab, slots, rows):
    """K5's wrapper: ``slab[slots[i]] = rows[i]`` in place, ``slots``
    host ints in ``[0, C]`` (``C`` writes nowhere; anything outside raises
    before the launch), ``rows`` ``[M, D]``. On a CUDA slab it uploads
    slots and rows and launches the kernel (or raises); on a CPU slab it
    computes the plain version. Returns ``slab``."""
    if slab.device.type != "cuda":
        return scatter_rows_plain(slab, slots, rows)
    s = _host_slots(slots, slab.shape[0])
    r = _device_rows(rows, len(s), slab)
    return launch(slab, torch.from_numpy(s).to(slab.device), r)
