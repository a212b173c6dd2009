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
  count, and fill rows past it are ignored (no pads-first trick). Ids go
  in as int32 or int64, as they come (``torch.unique`` gives int64).

An id outside ``[0, V)`` is a caller's bug, and both raise ``ValueError``
naming it, at different times:

* the plain version checks on the host before it touches ``param`` (one
  sync with the card for a CUDA ``param``), as ``index_add_`` would;
* the kernel path makes no sync: the kernel skips such an id (nothing
  outside ``param`` is ever written; the call's other rows are updated)
  and records it in host words mapped into the card's address space.
  ``raise_pending`` reads them without a sync and raises: the wrapper on
  its next call on that card, and ``Executor.run`` at its end (it is
  registered with ``registry.report_late``), after the copy of the
  fetches, the sync that the step already has, or after a wait on the
  stream when nothing was copied. The words are per card, so a run on
  another thread that checks first raises it there.

Both update the caller's ``param`` tensor in place (the counterpart of the
JAX kernel's aliased output) and return it; they give the same bits, since
each element gets exactly one add.
"""

import ctypes
import threading

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import registry

__all__ = ["sparse_row_update", "sparse_row_update_plain", "launch",
           "raise_pending"]

_SOURCE = "sparse_update.cu"
_ID_BITS = {torch.int32: 0, torch.int64: 1}
_F32 = torch.float32


def _checked(param, ids, rows, n_unique, check_range):
    if param.dim() != 2:
        raise ValueError(f"param must be [V, D], got {tuple(param.shape)}")
    if ids.dim() != 1 or ids.dtype not in _ID_BITS:
        raise ValueError(f"ids must be a 1-D int32/int64 tensor, got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    n = ids.shape[0]
    if tuple(rows.shape) != (n, param.shape[1]):
        raise ValueError(f"rows have shape {tuple(rows.shape)}, expected "
                         f"{(n, param.shape[1])}")
    n_unique = n if n_unique is None else int(n_unique)
    if not 0 <= n_unique <= n:
        raise ValueError(f"n_unique {n_unique} outside [0, {n}]")
    if check_range and n_unique:
        lo, hi = torch.stack(torch.aminmax(ids[:n_unique])).tolist()
        if lo < 0 or hi >= param.shape[0]:
            raise ValueError(f"sparse row update: id outside [0, "
                             f"{param.shape[0]}): min {lo}, max {hi}")
    return n_unique


def sparse_row_update_plain(param, ids, rows, n_unique=None):
    """``param[ids[i]] += rows[i]`` for ``i < n_unique`` (default: every
    row), in place, by ``index_add_``; an id outside ``[0, V)`` raises
    before ``param`` is touched. Returns ``param``."""
    n = _checked(param, ids, rows, n_unique, check_range=True)
    return param.index_add_(0, ids[:n].to(torch.int64),
                            rows[:n].to(param.dtype))


class _Card:
    """What a launch on one card needs, resolved once: the C function, the
    current-stream getter, and the error words — a device int that the
    first thread to find a bad id takes, and three pinned host words
    (set, id, row count) that the kernel writes through their device
    address and the host reads as a numpy array, without a sync."""

    def __init__(self, index):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.fn = build.function(_SOURCE, "sparse_row_update_f32",
                                 [i, p, p, i, p, ll, ll, ll, p, p, p])
        self.stream = build.raw_stream_getter()
        self.flag = torch.zeros(1, dtype=torch.int32,
                                device=torch.device("cuda", index))
        self._host = torch.zeros(3, dtype=torch.int64, pin_memory=True)
        self.words = self._host.numpy()
        mapped = ctypes.c_void_p()
        err = build.function(_SOURCE, "sparse_row_update_device_pointer",
                             [p, ctypes.POINTER(ctypes.c_void_p)])(
            self._host.data_ptr(), ctypes.byref(mapped))
        if err:
            _raise_on(err, "host word mapping")
        self.flag_ptr = self.flag.data_ptr()
        self.words_ptr = mapped.value
        self._lock = threading.Lock()

    def report(self):
        """Raise the recorded bad id and clear the words (the device flag
        is cleared on the current stream, after every launch before it)."""
        with self._lock:
            if not self.words[0]:
                return
            bad, vocab = int(self.words[1]), int(self.words[2])
            self.words[:] = 0
            self.flag.zero_()
        raise ValueError(f"sparse row update: id {bad} outside [0, {vocab}) "
                         "(the kernel skipped it; the launch's other rows "
                         "were updated)")


_cards = {}
_cards_lock = threading.Lock()


def _card(index):
    card = _cards.get(index)
    if card is None:
        with _cards_lock:
            card = _cards.get(index)
            if card is None:
                card = _cards[index] = _Card(index)
    return card


def _raise_on(err, what):
    msg = build.function(_SOURCE, "sparse_row_update_error_string",
                         [ctypes.c_int], ctypes.c_char_p)(err).decode()
    raise RuntimeError(f"sparse_row_update {what} failed: {msg} ({err})")


def raise_pending(device):
    """Raise the ``ValueError`` of an id outside the table that K6 met on
    ``device`` since the last report, if any. No sync: a launch that is
    still running is reported by a later check."""
    if device.type != "cuda":
        return
    card = _cards.get(device.index if device.index is not None
                      else torch.cuda.current_device())
    if card is not None and card.words[0]:
        card.report()


registry.report_late("sparse_row_update", raise_pending)


def launch(param, ids, rows, n_unique):
    """Launch K6 on CUDA tensors (``ids`` int32 or int64 ``[N]``, the first
    ``n_unique`` distinct; ``rows`` float32 ``[N, D]``; all contiguous, on
    ``param``'s card), counting the launch. Raises first a bad id that an
    earlier launch on this card recorded. Returns ``param``."""
    index = param.get_device()
    if index < 0:
        raise ValueError("the kernel takes a CUDA param")
    card = _cards.get(index) or _card(index)
    if card.words[0]:
        card.report()
    bits = _ID_BITS.get(ids.dtype)
    if ((param.dtype, rows.dtype, ids.get_device(), rows.get_device())
            != (_F32, _F32, index, index) or bits is None
            or not (param.is_contiguous() and ids.is_contiguous()
                    and rows.is_contiguous())):
        raise ValueError("the kernel takes a contiguous float32 param and "
                         "rows and contiguous int32/int64 ids, all on "
                         "param's card")
    if not n_unique:
        return param
    vocab, d = param.shape
    err = card.fn(index, param.data_ptr(), ids.data_ptr(), bits,
                  rows.data_ptr(), n_unique, vocab, d, card.stream(index),
                  card.flag_ptr, card.words_ptr)
    if err:
        _raise_on(err, "kernel launch")
    registry.note_launch("sparse_row_update")
    return param


def sparse_row_update(param, ids, rows, n_unique=None):
    """K6's wrapper: ``param[ids[i]] += rows[i]`` in place for
    ``i < n_unique`` (the first ``n_unique`` ids distinct; rows past it are
    fill rows and are never touched). CUDA ``param``: the kernel, no sync;
    CPU: the plain version. An id outside ``[0, V)`` raises ``ValueError``
    (see the module's docstring for when). Returns ``param``."""
    if not param.is_cuda:
        return sparse_row_update_plain(param, ids, rows, n_unique)
    n = _checked(param, ids, rows, n_unique, check_range=False)
    if rows.dtype != _F32 or not rows.is_contiguous():
        rows = rows.to(_F32).contiguous()
    return launch(param, ids if ids.is_contiguous() else ids.contiguous(),
                  rows, n)
