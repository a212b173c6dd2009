"""Tensor creation / manipulation / comparison / random op lowerings,
with the semantics of the JAX package's ``ops/tensor.py``."""

import math

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.dtypes import to_torch_dtype
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.kernels import random as random_kernels
from paddle_tpu_torch.kernels import registry as kernel_registry
from paddle_tpu_torch.ops.common import (
    first, maybe, rng_counter_base, seeded_rng_key, xshape)
from paddle_tpu_torch.utils.enforce import EnforceError


@register_op("fill_constant", creates=True)
def _fill_constant(ins, attrs):
    return {"Out": [torch.full(
        tuple(attrs.get("shape", [1])), attrs.get("value", 0.0),
        dtype=to_torch_dtype(attrs.get("dtype", "float32")),
        device=first(ins, "__device__"))]}


@register_op("fill_zeros_like")
def _fill_zeros_like(ins, attrs):
    return {"Out": [torch.zeros_like(first(ins, "X"))]}


@register_op("assign_value", creates=True)
def _assign_value(ins, attrs):
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    device = first(ins, "__device__")
    shape = tuple(attrs["shape"])
    if device.type == "meta":
        return {"Out": [torch.empty(shape, dtype=dtype, device=device)]}
    values = torch.tensor(attrs["values"], dtype=dtype).reshape(shape)
    return {"Out": [values.to(device)]}


@register_op("concat")
def _concat(ins, attrs):
    axis = int(maybe(ins, "AxisTensor", attrs.get("axis", 0)))
    return {"Out": [torch.cat(ins["X"], dim=axis)]}


@register_op("assign")
def _assign(ins, attrs):
    # the output aliases the input, as in the JAX package; nothing else
    # mutates a tensor in place except an ``_inplace`` scatter, whose
    # target the executor proves is read by nobody but that scatter
    return {"Out": [first(ins, "X")]}


@register_op("reshape2")
def _reshape2(ins, attrs):
    x = first(ins, "X")
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(attrs["shape"])]
    return {"Out": [x.reshape(tuple(int(s) for s in shape))],
            "XShape": [xshape(x)]}


@register_op("reshape")
def _reshape(ins, attrs):
    """``reshape2`` without its ``XShape`` (``multihead_matmul_fuse``
    flattens a ``[B, 1, 1, S]`` key bias with it)."""
    return {"Out": _reshape2(ins, attrs)["Out"]}


@register_op("squeeze2")
def _squeeze2(ins, attrs):
    x = first(ins, "X")
    axes = attrs.get("axes", [])
    axes = [a % x.dim() for a in axes] if axes else [
        i for i, s in enumerate(x.shape) if s == 1
    ]
    out = x
    for a in sorted({a for a in axes if x.shape[a] == 1}, reverse=True):
        out = out.squeeze(a)
    return {"Out": [out], "XShape": [xshape(x)]}


@register_op("unsqueeze2")
def _unsqueeze2(ins, attrs):
    x = first(ins, "X")
    out = x
    # reference inserts axes in DECLARATION order, each against the rank
    # grown so far (unsqueeze_op.cc GetOutputShape) — do not sort
    for a in attrs.get("axes", []):
        out = out.unsqueeze(a)
    return {"Out": [out], "XShape": [xshape(x)]}


@register_op("transpose2")
def _transpose2(ins, attrs):
    # a strided view: consumers that need contiguous memory (the flash
    # attention wrapper) copy it themselves
    x = first(ins, "X")
    return {"Out": [x.permute(*attrs["axis"])], "XShape": [xshape(x)]}


@register_op("slice")
def _slice(ins, attrs):
    x = first(ins, "Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    return {"Out": [x[tuple(idx)]]}


@register_op("batched_gather", nondiff_inputs=("Index",))
def _batched_gather(ins, attrs):
    """Per-row gather along axis 1: X [B, S, ...] + Index [B, P] ->
    [B, P, ...]. Indices must lie in [0, S): torch raises on one outside
    it (the JAX package clamps)."""
    x = first(ins, "X")
    idx = first(ins, "Index").to(torch.int64)
    idx_e = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
    return {"Out": [torch.gather(
        x, 1, idx_e.expand(tuple(idx.shape) + tuple(x.shape[2:])))]}


@register_op("cast")
def _cast(ins, attrs):
    return {"Out": [first(ins, "X").to(to_torch_dtype(attrs["out_dtype"]))]}


@register_op("where", nondiff_inputs=("Condition",))
def _where(ins, attrs):
    return {"Out": [torch.where(first(ins, "Condition"), first(ins, "X"),
                                first(ins, "Y"))]}


def _compare(name, fn):
    @register_op(name, nondiff_inputs=("X", "Y"))
    def _lower(ins, attrs, _fn=fn):
        return {"Out": [_fn(first(ins, "X"), first(ins, "Y"))]}


_compare("equal", torch.eq)
_compare("not_equal", torch.ne)
_compare("less_than", torch.lt)
_compare("less_equal", torch.le)
_compare("greater_than", torch.gt)
_compare("greater_equal", torch.ge)
_compare("logical_and", torch.logical_and)
_compare("logical_or", torch.logical_or)


@register_op("logical_not", nondiff_inputs=("X",))
def _logical_not(ins, attrs):
    return {"Out": [torch.logical_not(first(ins, "X"))]}


@register_op("gather", nondiff_inputs=("Index",))
def _gather(ins, attrs):
    x, index = first(ins, "X"), first(ins, "Index")
    return {"Out": [torch.index_select(x, attrs.get("axis", 0),
                                       index.reshape(-1))]}


@register_op("scatter", nondiff_inputs=("Ids",))
def _scatter(ins, attrs):
    """Row scatter into ``X``. Negative ids count from the end; with
    ``mode="drop"`` ids outside ``[0, R)`` write nowhere — the paged
    arena's "this batch slot writes nowhere" encoding (feed row R).
    Selecting the kept rows reads the mask on the host (one device sync
    per call). ``_inplace`` (set by the executor's plan) writes into
    ``X``'s own tensor instead of a copy."""
    x, ids, updates = first(ins, "X"), first(ins, "Ids"), first(ins, "Updates")
    if x.is_meta:
        return {"Out": [torch.empty_like(x)]}
    n = x.shape[0]
    ids = ids.reshape(-1)
    ids = torch.where(ids < 0, ids + n, ids)
    updates = updates.reshape((ids.shape[0],) + tuple(x.shape[1:]))
    if attrs.get("mode") == "drop":
        keep = ((ids >= 0) & (ids < n)).nonzero().squeeze(1)
        ids, updates = ids.index_select(0, keep), updates.index_select(0, keep)
    out = x if attrs.get("_inplace") else x.clone()
    if attrs.get("overwrite", True):
        out.index_copy_(0, ids, updates.to(out.dtype))
    else:
        out.index_add_(0, ids, updates.to(out.dtype))
    return {"Out": [out]}


# -- M12a: creation, shape and indexing -------------------------------------
#
# Index tensors are int64 (the JAX package's int32 values). Where a sum
# over duplicate indices happens (``scatter_nd_add``, and the autograd
# grads of ``gather_nd`` and ``index_select``), it goes through advanced
# indexing, whose accumulating ``index_put_`` sorts the indices and sums
# each run in one fixed order on CUDA: the same bits on every run, where
# ``index_add_``'s atomics add in an order that varies. The grads of
# ``expand``, ``expand_as`` and ``tile`` are reductions, which are
# run-to-run stable on the card too.


def batch_size_like_shape(ins, attrs):
    """The declared ``shape`` with its ``output_dim_idx`` dimension taken
    from ``Input``'s ``input_dim_idx`` one (the ``*_batch_size_like``
    ops)."""
    shape = [int(d) for d in attrs["shape"]]
    shape[attrs.get("output_dim_idx", 0)] = int(
        first(ins, "Input").shape[attrs.get("input_dim_idx", 0)])
    return tuple(shape)


@register_op("fill_constant_batch_size_like")
def _fill_constant_bsl(ins, attrs):
    x = first(ins, "Input")
    return {"Out": [torch.full(
        batch_size_like_shape(ins, attrs), attrs.get("value", 0.0),
        dtype=to_torch_dtype(attrs.get("dtype", "float32")), device=x.device)]}


def _host_scalar(t):
    """A 1-element tensor's value, read on the host (a device sync for a
    tensor on the card)."""
    return t.reshape(()).item()


@register_op("range", nondiff_inputs=("Start", "End", "Step"))
def _range(ins, attrs):
    """``jnp.arange(start, end, step)`` in float32 (float64 for float64
    bounds), cast to Start's dtype; the bounds are read on the host, so
    the output's length is known there."""
    start, end, step = first(ins, "Start"), first(ins, "End"), first(ins, "Step")
    wide = np.float64 if start.dtype == torch.float64 else np.float32
    values = np.arange(float(_host_scalar(start)), float(_host_scalar(end)),
                       float(_host_scalar(step)), dtype=wide)
    return {"Out": [torch.from_numpy(values).to(start.device, start.dtype)]}


@register_op("linspace")
def _linspace(ins, attrs):
    """``jnp.linspace(start, stop, num)``, float32; the bounds and the
    count are read on the host."""
    start, stop, num = first(ins, "Start"), first(ins, "Stop"), first(ins, "Num")
    return {"Out": [torch.linspace(
        float(_host_scalar(start)), float(_host_scalar(stop)),
        int(_host_scalar(num)), dtype=torch.float32, device=start.device)]}


@register_op("eye", creates=True)
def _eye(ins, attrs):
    rows = attrs["num_rows"]
    cols = attrs.get("num_columns")
    return {"Out": [torch.eye(
        rows, rows if cols is None else cols,
        dtype=to_torch_dtype(attrs.get("dtype", "float32")),
        device=first(ins, "__device__"))]}


@register_op("transpose")
def _transpose(ins, attrs):
    """``transpose2`` without its ``XShape``."""
    return {"Out": _transpose2(ins, attrs)["Out"]}


@register_op("flatten2")
def _flatten2(ins, attrs):
    """X as a matrix: the axes before ``axis`` make its rows."""
    x = first(ins, "X")
    axis = attrs.get("axis", 1)
    lead = math.prod(x.shape[:axis]) if axis else 1
    return {"Out": [x.reshape(lead, -1)], "XShape": [xshape(x)]}


@register_op("split")
def _split(ins, attrs):
    """``sections`` sizes (the last may be -1) or ``num`` equal parts
    along ``axis``, split where ``jnp.split`` splits."""
    x = first(ins, "X")
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        cuts = np.cumsum(sections[:-1]).tolist()
    else:
        num = attrs.get("num", 0)
        if not num or x.shape[axis] % num:
            raise EnforceError(
                f"split: axis {axis} of size {x.shape[axis]} does not "
                f"divide into {num} equal parts")
        step = x.shape[axis] // num
        cuts = [step * i for i in range(1, num)]
    return {"Out": list(torch.tensor_split(x, [int(c) for c in cuts],
                                           dim=axis))}


@register_op("stack")
def _stack(ins, attrs):
    return {"Y": [torch.stack(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("unstack")
def _unstack(ins, attrs):
    return {"Y": list(torch.unbind(first(ins, "X"), dim=attrs.get("axis", 0)))}


def _strided(x, axis, start, end, step):
    """``x[start:end:step]`` along ``axis`` with Python's slice rules,
    negative steps too (torch slices take none: those flip first)."""
    dim = x.shape[axis]
    picked = range(*slice(start, end, step).indices(dim))
    idx = [slice(None)] * x.dim()
    if step > 0:
        idx[axis] = slice(picked.start, picked.stop, step)
        return x[tuple(idx)]
    if not len(picked):
        idx[axis] = slice(0, 0)
        return x[tuple(idx)]
    first_at = dim - 1 - picked[0]
    idx[axis] = slice(first_at, first_at + (len(picked) - 1) * -step + 1, -step)
    return torch.flip(x, (axis,))[tuple(idx)]


@register_op("strided_slice")
def _strided_slice(ins, attrs):
    x = first(ins, "Input")
    for a, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                           attrs["strides"]):
        x = _strided(x, a, s, e, st)
    return {"Out": [x]}


@register_op("expand")
def _expand(ins, attrs):
    """``jnp.tile(x, expand_times)``."""
    return {"Out": [torch.tile(first(ins, "X"),
                               tuple(attrs.get("expand_times")))]}


@register_op("expand_as")
def _expand_as(ins, attrs):
    return {"Out": [torch.broadcast_to(
        first(ins, "X"), tuple(first(ins, "target_tensor").shape))]}


@register_op("tile")
def _tile(ins, attrs):
    return {"Out": [torch.tile(first(ins, "X"), tuple(attrs["repeat_times"]))]}


def _nd_index(index):
    """``tuple(moveaxis(index, -1, 0))``: one int64 index tensor a leading
    axis of X."""
    return tuple(index.to(torch.int64).unbind(-1))


@register_op("gather_nd", nondiff_inputs=("Index",))
def _gather_nd(ins, attrs):
    """``X[index[..., 0], index[..., 1], ...]``. Indices must lie in X
    (torch raises on one outside; the JAX package clamps)."""
    return {"Out": [first(ins, "X")[_nd_index(first(ins, "Index"))]]}


@register_op("scatter_nd_add", nondiff_inputs=("Index",))
def _scatter_nd_add(ins, attrs):
    """X with ``Updates`` added at the rows ``Index`` names, duplicates
    summed (sorted and in one order on the card)."""
    x, index, updates = first(ins, "X"), first(ins, "Index"), first(ins, "Updates")
    return {"Out": [x.index_put(_nd_index(index), updates.to(x.dtype),
                                accumulate=True)]}


@register_op("index_select", nondiff_inputs=("Index",))
def _index_select(ins, attrs):
    """``jnp.take(x, index, axis=dim)``."""
    x, index = first(ins, "X"), first(ins, "Index")
    dim = attrs.get("dim", 0) % x.dim()
    return {"Out": [x[(slice(None),) * dim + (index.to(torch.int64),)]]}


@register_op("flip")
def _flip(ins, attrs):
    return {"Out": [torch.flip(first(ins, "X"), tuple(attrs["axis"]))]}


@register_op("roll")
def _roll(ins, attrs):
    return {"Out": [torch.roll(first(ins, "X"), tuple(attrs["shifts"]),
                               tuple(attrs.get("axis", [0])))]}


@register_op("pad")
def _pad(ins, attrs):
    """Constant padding, ``paddings`` = ``[lo0, hi0, lo1, hi1, ...]`` over
    every axis."""
    x = first(ins, "X")
    p = attrs["paddings"]
    pads = [v for i in reversed(range(x.dim())) for v in (p[2 * i], p[2 * i + 1])]
    return {"Out": [F.pad(x, pads, value=attrs.get("pad_value", 0.0))]}


@register_op("pad2d")
def _pad2d(ins, attrs):
    """NCHW H and W padding, ``paddings`` = ``[top, bottom, left,
    right]``: ``constant``, ``reflect`` or ``edge``."""
    x = first(ins, "X")
    top, bottom, left, right = attrs["paddings"]
    mode = attrs.get("mode", "constant")
    pads = (left, right, top, bottom)
    if mode == "constant":
        return {"Out": [F.pad(x, pads, value=attrs.get("pad_value", 0.0))]}
    return {"Out": [F.pad(x, pads, mode={"reflect": "reflect",
                                         "edge": "replicate"}[mode])]}


@register_op("shape", nondiff_inputs=("Input",))
def _shape_op(ins, attrs):
    """X's shape, int32."""
    x = first(ins, "Input")
    return {"Out": [torch.tensor(tuple(x.shape), dtype=torch.int32).to(
        x.device)]}


@register_op("where_index", nondiff_inputs=("Condition",))
def _where_index(ins, attrs):
    """The ``[n, rank]`` int64 coordinates of Condition's true elements,
    in row-major order. ``n`` depends on the data: on the card the call
    syncs with the host."""
    return {"Out": [torch.nonzero(first(ins, "Condition"))]}


@register_op("isfinite", nondiff_inputs=("X",))
def _isfinite(ins, attrs):
    """One bool, ``[1]``: every element of X finite (reference:
    paddle/fluid/operators/isfinite_op.cc)."""
    return {"Out": [torch.isfinite(first(ins, "X")).all().reshape((1,))]}


@register_op("isfinite_v2", nondiff_inputs=("X",))
def _isfinite_v2(ins, attrs):
    return {"Out": [torch.isfinite(first(ins, "X"))]}


# -- random (stateful) -------------------------------------------------------
#
# ``jax.random``'s values from the op's key (``seeded_rng_key``): the bits
# come from K8's ``random_bits`` on the card (its plain version on the CPU
# or with the kernels off), the float conversion is plain torch
# (``core/prng.py``): these ops run in startup programs, once.


def _bits(key, n, device, base=0):
    if kernel_registry.mode() == "off":
        return random_kernels.random_bits_plain(key, n, device, base)
    return random_kernels.random_bits(key, n, device, base)


def _shape(ins, attrs):
    shape = maybe(ins, "ShapeTensor")
    if shape is None:
        return tuple(int(d) for d in attrs.get("shape"))
    return tuple(int(d) for d in shape.reshape(-1).tolist())


def draw(ins, attrs, shape, convert, device):
    """``convert(bits)`` of ``numel(shape)`` draws from the op's key, in
    the op's dtype (default float32) on ``device`` (an empty meta tensor
    under shape inference)."""
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    n = math.prod(shape)
    out = convert(_bits(seeded_rng_key(ins, attrs), n, device,
                        rng_counter_base(ins, n)))
    return out.reshape(shape).to(dtype)


@register_op("gaussian_random", stateful=True, creates=True)
def _gaussian_random(ins, attrs):
    """``mean + std * jax.random.normal(key, shape)``."""
    z = draw(ins, attrs, _shape(ins, attrs), prng.normal,
             first(ins, "__device__"))
    return {"Out": [mean_std(z, attrs)]}


def mean_std(z, attrs):
    """``mean + std * z`` in float32, as the JAX op computes it (the
    Python scalars are float32 there)."""
    if z.is_meta:
        return z
    std = torch.full((), prng.f32(attrs.get("std", 1.0)), dtype=torch.float32,
                     device=z.device)
    mean = torch.full((), prng.f32(attrs.get("mean", 0.0)),
                      dtype=torch.float32, device=z.device)
    return (mean + std * z.to(torch.float32)).to(z.dtype)


@register_op("uniform_random", stateful=True, creates=True)
def _uniform_random(ins, attrs):
    """``jax.random.uniform(key, shape, float32, min, max)``; the shape
    from ``ShapeTensor`` where given (a host read)."""
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    return {"Out": [draw(ins, attrs, _shape(ins, attrs),
                         lambda b: prng.uniform(b, lo, hi),
                         first(ins, "__device__"))]}


@register_op("truncated_gaussian_random", stateful=True, creates=True)
def _truncated_gaussian_random(ins, attrs):
    """``mean + std * jax.random.truncated_normal(key, -2, 2, shape)``."""
    z = draw(ins, attrs, tuple(int(d) for d in attrs.get("shape")),
             lambda b: prng.truncated_normal(b, -2.0, 2.0),
             first(ins, "__device__"))
    return {"Out": [mean_std(z, attrs)]}


@register_op("randint", stateful=True, creates=True)
def _randint(ins, attrs):
    """``jax.random.randint(key, shape, low, high)``: two bit draws from
    ``split(key)``, int64 out (the JAX package's int32 values)."""
    shape = tuple(int(d) for d in attrs.get("shape"))
    device = first(ins, "__device__")
    dtype = to_torch_dtype(attrs.get("dtype", "int64"))
    if device.type == "meta":
        return {"Out": [torch.empty(shape, dtype=dtype, device=device)]}
    k1, k2 = prng.split(seeded_rng_key(ins, attrs))
    n = math.prod(shape)
    out = prng.randint_from(_bits(k1, n, device), _bits(k2, n, device),
                            attrs.get("low", 0), attrs.get("high", 100))
    return {"Out": [out.reshape(shape).to(dtype)]}


@register_op("randperm", stateful=True, creates=True)
def _randperm(ins, attrs):
    """``jax.random.permutation(key, n)``."""
    n = int(attrs["n"])
    device = first(ins, "__device__")
    dtype = to_torch_dtype(attrs.get("dtype", "int64"))
    if device.type == "meta":
        return {"Out": [torch.empty((n,), dtype=dtype, device=device)]}
    out = prng.permutation(seeded_rng_key(ins, attrs), n, bits_fn=_bits,
                           device=device)
    return {"Out": [out.to(dtype)]}


@register_op("bernoulli", stateful=True)
def _bernoulli(ins, attrs):
    """``jax.random.bernoulli(key, X)`` elementwise, in ``X``'s dtype."""
    x = first(ins, "X")
    if x.is_meta:
        return {"Out": [torch.empty_like(x)]}
    u = prng.uniform(_bits(seeded_rng_key(ins, attrs), x.numel(), x.device,
                           rng_counter_base(ins, x.numel())))
    return {"Out": [(u.reshape(x.shape) < x.to(torch.float32)).to(x.dtype)]}
