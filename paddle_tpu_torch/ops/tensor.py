"""Tensor creation / manipulation / random op lowerings, with the
semantics of the JAX package's ``ops/tensor.py``."""

import torch

from paddle_tpu_torch.core.dtypes import to_torch_dtype
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import first, xshape


@register_op("fill_constant", creates=True)
def _fill_constant(ins, attrs):
    return {"Out": [torch.full(
        tuple(attrs.get("shape", [1])), attrs.get("value", 0.0),
        dtype=to_torch_dtype(attrs.get("dtype", "float32")),
        device=first(ins, "__device__"))]}


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


@register_op("gather")
def _gather(ins, attrs):
    x, index = first(ins, "X"), first(ins, "Index")
    return {"Out": [torch.index_select(x, attrs.get("axis", 0),
                                       index.reshape(-1))]}


@register_op("scatter")
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


@register_op("uniform_random", stateful=True, creates=True)
def _uniform_random(ins, attrs):
    """Uniform draws from the executor's ``torch.Generator``. The stream
    differs from the JAX package's threefry keys for the same seed; the
    distribution is the same."""
    shape = tuple(attrs.get("shape"))
    out = torch.empty(shape, dtype=torch.float32,
                      device=first(ins, "__device__"))
    gen = first(ins, "__generator__")
    if not out.is_meta:
        out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                     generator=gen)
    return {"Out": [out.to(to_torch_dtype(attrs.get("dtype", "float32")))]}
