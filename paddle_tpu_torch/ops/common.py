"""Shared helpers for op lowering rules."""


def first(ins, slot):
    return ins[slot][0]


def maybe(ins, slot, default=None):
    vals = ins.get(slot)
    return vals[0] if vals else default


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


def xshape(x):
    """The ``XShape`` output of the ``*2`` reshape ops: an empty tensor
    whose shape records ``x``'s, as the JAX package emits it."""
    return x.new_empty((0,) + tuple(x.shape))
