"""Shared helpers for op lowering rules."""

import contextlib
import threading

import torch

from paddle_tpu_torch.core import prng


def first(ins, slot):
    return ins[slot][0]


def maybe(ins, slot, default=None):
    vals = ins.get(slot)
    return vals[0] if vals else default


def rng_key(ins):
    """The key the executor gave a stateful op (two Python ints)."""
    key = ins.get("__rng_key__")
    if key is None:
        raise RuntimeError("stateful op executed without an rng key")
    return key[0]


def rng_counter_base(ins, n):
    """The counter base of a stateful op's draw of ``n`` elements: 0, or,
    where the executor names this rank's block of a data-parallel draw
    (``ins["__rng_block__"]``, a rank ``r`` of a dense data-parallel run
    drawing rows of the batch), ``r * n``, so that the rank's ``n``
    elements are its rows of the global draw
    (``parallel/data_parallel.py``)."""
    block = ins.get("__rng_block__")
    return int(block[0]) * int(n) if block else 0


def seeded_rng_key(ins, attrs):
    """The op's key, honouring a fixed per-op ``seed`` attribute while
    still advancing between executor runs: ``fold_in(PRNGKey(seed),
    k[0] ^ k[1])`` of the executor's key ``k`` (the JAX package's
    ``paddle_tpu/ops/common.py`` ``seeded_rng_key``)."""
    seed = attrs.get("seed", 0)
    if not seed:
        return rng_key(ins)
    base = prng.prng_key(seed)
    injected = ins.get("__rng_key__")
    if injected is None:
        return base
    k = injected[0]
    return prng.fold_in(base, int(k[0]) ^ int(k[1]))


def broadcast_y(x, y, axis):
    """Reference elementwise broadcast semantics: Y aligns into X starting at
    `axis` (reference: paddle/fluid/operators/elementwise/
    elementwise_op_function.h). axis=-1 aligns trailing dims (numpy rule)."""
    if axis is None or axis == -1 or x.dim() == y.dim():
        return y
    trailing = x.dim() - axis - y.dim()
    if trailing < 0:
        return y
    return y.reshape((1,) * axis + tuple(y.shape) + (1,) * trailing)


def reduce_axes(attrs, ndim):
    if attrs.get("reduce_all", False):
        return tuple(range(ndim))
    dims = attrs.get("dim", [0])
    if isinstance(dims, int):
        dims = [dims]
    return tuple(d % ndim for d in dims)


def normalize_padding(attrs, spatial_dims, ksize, strides, in_shape):
    """Resolve the reference's padding attrs (explicit list / SAME / VALID)
    into ``((lo, hi), ...)`` pairs, one a spatial dim (the JAX package's
    ``paddle_tpu/ops/common.py`` ``normalize_padding``). SAME pads
    ``total // 2`` before and the rest after, so an odd total is
    asymmetric; a 4-element ``paddings`` is ``[lo0, hi0, lo1, hi1]``."""
    algo = attrs.get("padding_algorithm", "EXPLICIT")
    pads = attrs.get("paddings", [0] * spatial_dims)
    if algo == "VALID":
        return ((0, 0),) * spatial_dims
    if algo == "SAME":
        out = []
        for i in range(spatial_dims):
            out_size = -(-in_shape[i] // strides[i])
            total = max(0, (out_size - 1) * strides[i] + ksize[i] - in_shape[i])
            out.append((total // 2, total - total // 2))
        return tuple(out)
    if len(pads) == spatial_dims:
        return tuple((p, p) for p in pads)
    return tuple((pads[2 * i], pads[2 * i + 1]) for i in range(spatial_dims))


def xshape(x):
    """The ``XShape`` output of the ``*2`` reshape ops: an empty tensor
    whose shape records ``x``'s, as the JAX package emits it."""
    return x.new_empty((0,) + tuple(x.shape))


def segment_sum(rows, index, n):
    """``out[k] = sum of rows[i] with index[i] == k`` for ``k < n``, rows
    ``[N, D]`` -> ``[n, D]`` in ``rows``' dtype: the duplicate-id merge of
    the sparse updates (the JAX package's ``zeros.at[inv].add(rows)``).

    One accumulating ``index_put_``. On the CPU it sums each segment in
    occurrence order; on CUDA it sorts the indices (a stable radix sort)
    and sums each segment in one thread or warp in a fixed order, with no
    floating-point atomics — so the result is the same bits on every run
    (``index_add_`` on CUDA adds with atomics, in an order that varies).
    ``chip_smoke.py`` checks the Wide&Deep run for that, bit for bit."""
    out = torch.zeros((n,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_put_((index.to(torch.int64),), rows, accumulate=True)


class SettingGuard:
    """A process-wide PyTorch setting held inside ``with guard.on(x):``
    for the tensors ``applies(x)`` accepts, and put back after. The
    setting is process-wide, so nested and concurrent users share one save
    and restore: the first in saves and sets it (``_set``, which returns
    what to restore), the last out puts it back (``_restore``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    def __enter__(self):
        with self._lock:
            if self._depth == 0:
                self._saved = self._set()
            self._depth += 1

    def __exit__(self, *exc):
        with self._lock:
            self._depth -= 1
            if self._depth == 0:
                self._restore(self._saved)

    def on(self, x):
        """This guard where ``applies(x)``, else nothing to set."""
        return self if self.applies(x) else contextlib.nullcontext()
