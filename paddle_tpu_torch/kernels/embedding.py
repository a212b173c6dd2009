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
* ``admit_rows(slab, slots, rows, staging)`` — scatter the admitted rows
  into the slab IN PLACE: the scope's own tensor is updated, the
  counterpart of the JAX package's donated buffer. The JAX package pads
  the admission to a power-of-two bucket (``pad_slots``; ``slot ==
  capacity`` writes nowhere) to bound its compiled shapes; nothing here
  compiles per shape, so only the real rows go up. Kernel mode ``off``
  computes the plain version on the slab's device.

``scatter_rows`` is the wrapper of the hand-written CUDA kernel in
``csrc/embedding_admission.cu`` (K5, replacing ``_scatter_pallas``): on a
CUDA slab it checks the host slots, packs slots and rows into the pinned
buffer of a ``Staging`` (``pack_admission``; the caller's, else the
card's own), and uploads and launches in one call, with no sync; on a
CPU slab it computes the plain version ``scatter_rows_plain``. Rows move byte for byte on every path, so
admission is bit-identical across devices, modes and capacities, and a
padded bucket gives the same bytes as its real rows.

``staging_waits()`` counts the uploads that had to wait for the last
upload through the same ``Staging`` (the one case in which admission
syncs); the engine's path makes none, and callers assert that.

``roundtrips()`` counts reads of a whole slab to the host, as the JAX
package's ``admission_roundtrip_counter`` does for its legacy admission
path (the full ``[capacity, dim]`` slab through host numpy per batch).
The port has no such path (ROADMAP M11 brings the mesh-sharded slab and
its host branch), so the count stays 0: callers assert that it does.
"""

import ctypes
import threading

import numpy as np
import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import registry

__all__ = ["admit_bucket", "pad_slots", "read_rows", "admit_rows",
           "scatter_rows", "scatter_rows_plain", "launch", "roundtrips",
           "Staging", "staging_waits", "admission_layout", "pack_admission"]

_SOURCE = "embedding_admission.cu"
_F32 = torch.float32
_roundtrips = 0
_waits = 0
_waits_lock = threading.Lock()


def roundtrips():
    """Whole-slab copies to the host since the process started."""
    return _roundtrips


def staging_waits():
    """Uploads since the process started that waited for the last upload
    through their ``Staging``."""
    return _waits


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


def admission_layout(m, dim):
    """K5's staging layout for ``m`` entries of ``dim`` floats: (byte
    offset of the rows, total bytes). The ``m`` int32 slots come first,
    the ``[m, dim]`` float32 rows at the next 16-byte boundary (the
    kernel's vector loads need it)."""
    off = -(-4 * m // 16) * 16
    return off, off + 4 * m * dim


def pack_admission(slots, rows, out=None):
    """Slots (int ``[m]``) and float32 rows (``[m, dim]``) in one byte
    buffer, as ``admission_layout`` lays them out: into ``out`` (a uint8
    array at least that long; its first bytes are returned) or a new
    array. The bytes between the slots and the rows are left as they
    are."""
    m, dim = rows.shape
    off, size = admission_layout(m, dim)
    buf = np.empty(size, np.uint8) if out is None else out[:size]
    buf[:4 * m].view(np.int32)[:] = slots
    buf[off:size].view(np.float32).reshape(m, dim)[:] = rows
    return buf


def read_rows(slab, slots):
    """``slab[slots]`` as a host array: only the victims' rows cross to
    the host (one sync with the card)."""
    idx = torch.as_tensor(np.asarray(slots, dtype=np.int64), device=slab.device)
    return slab.index_select(0, idx).cpu().numpy()


def admit_rows(slab, slots, rows, staging=None):
    """Scatter the admitted ``rows`` (host ``[n, dim]``) into ``slab`` at
    ``slots`` (host ints), in place: on a CUDA slab through ``staging``
    (the caller's, reused call after call, else the card's; see
    ``scatter_rows``) with no sync. Kernel mode ``off`` takes the plain version. Returns ``slab``."""
    s = np.asarray(slots, dtype=np.int32)
    r = np.asarray(rows, dtype=np.float32)
    if not len(s):
        return slab
    if registry.mode() == "off":
        return scatter_rows_plain(slab, s, r)
    return scatter_rows(slab, s, r, staging)


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


def _check_rows(r, m, slab):
    if tuple(r.shape) != (m, slab.shape[1]):
        raise ValueError(f"rows have shape {tuple(r.shape)}, expected "
                         f"{(m, slab.shape[1])}")


def _device_rows(rows, m, slab):
    r = torch.as_tensor(rows)
    _check_rows(r, m, slab)
    if r.dtype != slab.dtype:
        raise TypeError(f"rows have dtype {r.dtype}, the slab {slab.dtype}")
    return r.to(slab.device).contiguous()


def _host_rows(rows, m, slab):
    """The rows as a host float32 array of shape ``[m, dim]``: admitted
    rows come from the host tier."""
    if isinstance(rows, torch.Tensor):
        if rows.device.type != "cpu":
            raise ValueError("admission rows come from the host tier: pass "
                             "them as a numpy array or a CPU tensor (or "
                             "call launch with device tensors)")
        rows = rows.numpy()
    r = np.asarray(rows)
    _check_rows(r, m, slab)
    if r.dtype != np.float32:
        raise TypeError(f"rows have dtype {r.dtype}, the kernel takes "
                        "float32")
    return r


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


class Staging:
    """K5's upload buffers (the engine keeps one a table; ``scatter_rows``
    keeps one a card for callers that pass none): a pinned host buffer
    that ``pack_admission`` fills, a device buffer of the same size, and
    the event recorded after the last upload's launch (which read the
    device buffer). The buffers are refilled, regrown or freed only once
    that event is done: PyTorch's caching allocators know nothing of the
    copy and the launch that the C entry point queues, and would hand a
    freed buffer out again while they still read it. When the event is not
    done (two uploads closer together than one copy and launch), the
    refill waits for it — the one case in which an upload syncs, counted by
    ``staging_waits``. Buffers are allocated at the first upload on a card
    and grow, doubling, when an admission does not fit. ``lock`` is held
    from the refill to the launch, so threads may share one."""

    def __init__(self):
        self._host = self._dev = self._event = None
        self._index = -1
        self.view = None            # numpy view of the pinned host buffer
        self.lock = threading.Lock()

    def _wait(self):
        global _waits
        if self._event is not None and not self._event.query():
            with _waits_lock:
                _waits += 1
            self._event.synchronize()

    def reserve(self, nbytes, index):
        """Make room for ``nbytes`` on card ``index``, once the last upload
        and its launch are done."""
        self._wait()
        if self._index != index or self.view.size < nbytes:
            size = max(nbytes, 4096,
                       0 if self.view is None else 2 * self.view.size)
            dev = torch.device("cuda", index)
            self._host = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            self.view = self._host.numpy()
            self._dev = torch.empty(size, dtype=torch.uint8, device=dev)
            with torch.cuda.device(dev):
                # created on its card by a first record: the C entry
                # point records it after each copy by its handle
                self._event = torch.cuda.Event()
                self._event.record()
            self._index = index
            self.host_ptr, self.dev_ptr = (self._host.data_ptr(),
                                           self._dev.data_ptr())
            self.event_ptr = self._event.cuda_event

    def __del__(self):
        # the buffers go back to the allocators only after their last use
        if self._event is not None and not self._event.query():
            self._event.synchronize()


_card_staging = {}
_card_staging_lock = threading.Lock()


def _staging_of(index):
    """The staging kept for card ``index``'s callers that pass none."""
    staging = _card_staging.get(index)
    if staging is None:
        with _card_staging_lock:
            staging = _card_staging.setdefault(index, Staging())
    return staging


_fn = None


def _function():
    """(the C entry point, the stream getter), resolved at the first
    launch."""
    global _fn
    if _fn is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        _fn = (build.function(_SOURCE, "embedding_admission_f32",
                              [ctypes.c_int, p, p, p, ll, ll, ll, p, p, ll,
                               p]),
               build.raw_stream_getter())
    return _fn


def _launched(err):
    if err:
        msg = build.function(_SOURCE, "embedding_admission_error_string",
                             [ctypes.c_int], ctypes.c_char_p)(err).decode()
        raise RuntimeError(f"embedding_admission kernel launch failed: "
                           f"{msg} ({err})")
    registry.note_launch("embedding_admission")


def _slab_card(slab):
    index = slab.get_device()
    if index < 0 or slab.dtype != _F32 or not slab.is_contiguous():
        raise ValueError("the slab must be a contiguous float32 CUDA tensor")
    return index


def launch(slab, slots, rows):
    """Launch K5 on CUDA tensors (``slots`` int32 ``[M]`` in ``[0, C]``,
    which ``scatter_rows`` checks on the host before it uploads them;
    ``rows`` float32 ``[M, D]``; contiguous, on the slab's card), counting
    the launch. Returns ``slab``."""
    index = _slab_card(slab)
    m = slots.shape[0]
    if ((slots.dtype, rows.dtype, slots.get_device(), rows.get_device(),
         tuple(rows.shape)) != (torch.int32, _F32, index, index,
                                (m, slab.shape[1]))
            or not (slots.is_contiguous() and rows.is_contiguous())):
        raise ValueError("slots must be contiguous int32 [M] and rows "
                         "contiguous float32 [M, D], on the slab's card")
    if not m:
        return slab
    fn, stream = _function()
    cap, d = slab.shape
    _launched(fn(index, slab.data_ptr(), slots.data_ptr(), rows.data_ptr(),
                 m, cap, d, stream(index), None, 0, None))
    return slab


def scatter_rows(slab, slots, rows, staging=None):
    """K5's wrapper: ``slab[slots[i]] = rows[i]`` in place, ``slots``
    host ints in ``[0, C]`` (``C`` writes nowhere; anything outside raises
    before the upload), ``rows`` host float32 ``[M, D]``. On a CUDA slab it
    packs both into ``staging``'s pinned buffer (the card's own when none
    is given) and uploads them and launches the kernel in one call, with
    no sync (or raises); on a CPU slab it computes the plain version.
    Returns ``slab``."""
    if not slab.is_cuda:
        return scatter_rows_plain(slab, slots, rows)
    index = _slab_card(slab)
    s = _host_slots(slots, slab.shape[0])
    r = _host_rows(rows, len(s), slab)
    m, dim = r.shape
    if not m:
        return slab
    staging = staging if staging is not None else _staging_of(index)
    off, nbytes = admission_layout(m, dim)
    fn, stream = _function()
    with staging.lock:
        staging.reserve(nbytes, index)
        pack_admission(s, r, out=staging.view)
        _launched(fn(index, slab.data_ptr(), staging.dev_ptr,
                     staging.dev_ptr + off, m, slab.shape[0], dim,
                     stream(index), staging.host_ptr, nbytes,
                     staging.event_ptr))
    return slab
