"""Neural-network op lowerings: activation, softmax, embedding, and the
two decode-attention ops, with the semantics of the JAX package's
``ops/nn.py``.

``cached_attention`` and ``paged_attention`` register their plain
composite as ``lower`` (what shape inference and the ``off`` mode run)
and a ``kernel`` lowering that goes through the CUDA kernel wrappers in
``kernels/attention.py``.
"""

import torch

from paddle_tpu_torch.core.registry import OpDef, OpRegistry, register_op
from paddle_tpu_torch.kernels import attention as fused
from paddle_tpu_torch.kernels import registry as kernel_registry
from paddle_tpu_torch.ops.common import first


@register_op("relu")
def _relu(ins, attrs):
    return {"Out": [torch.relu(first(ins, "X"))]}


@register_op("softmax")
def _softmax(ins, attrs):
    return {"Out": [torch.softmax(first(ins, "X"), dim=attrs.get("axis", -1))]}


@register_op("lookup_table_v2")
def _lookup_table(ins, attrs):
    """reference: paddle/fluid/operators/lookup_table_op.cc. A dense row
    gather; ids at ``padding_idx`` read zeros."""
    w, ids = first(ins, "W"), first(ins, "Ids")
    out = w.index_select(0, ids.reshape(-1)).reshape(
        tuple(ids.shape) + tuple(w.shape[1:]))
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids == padding_idx).unsqueeze(-1),
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return {"Out": [out]}


def _cached_attention_reference(ins, attrs):
    q, k, v = first(ins, "Q"), first(ins, "KCache"), first(ins, "VCache")
    return {"Out": [fused.cached_attention_composite(
        q, k, v, first(ins, "Bias"), attrs.get("sm_scale", 1.0))]}


def _cached_attention_kernel(ins, attrs):
    if kernel_registry.mode() == "off":
        return _cached_attention_reference(ins, attrs)
    q, k, v = first(ins, "Q"), first(ins, "KCache"), first(ins, "VCache")
    return {"Out": [fused.decode_attention(
        q, k, v, first(ins, "Bias"), attrs.get("sm_scale", 1.0))]}


OpRegistry.register(OpDef(
    "cached_attention", _cached_attention_reference,
    kernel=_cached_attention_kernel,
))


def _paged_args(ins, attrs):
    return (first(ins, "Q"), first(ins, "KArena"), first(ins, "VArena"),
            first(ins, "Rows"), first(ins, "Bias"), attrs["seqs"],
            attrs["length"], attrs.get("sm_scale", 1.0))


def _paged_attention_reference(ins, attrs):
    return {"Out": [fused.paged_attention_composite(*_paged_args(ins, attrs))]}


def _paged_attention_kernel(ins, attrs):
    if kernel_registry.mode() == "off":
        return _paged_attention_reference(ins, attrs)
    return {"Out": [fused.paged_attention(*_paged_args(ins, attrs))]}


OpRegistry.register(OpDef(
    "paged_attention", _paged_attention_reference,
    kernel=_paged_attention_kernel,
))
