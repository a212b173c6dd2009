"""Elementwise / matmul op lowerings, with the semantics of the JAX
package's ``ops/math.py``. Matrix products go to ``torch.matmul``: the
JAX package leaves them to XLA, outside any Pallas kernel."""

import math

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import broadcast_y, first


@register_op("elementwise_add")
def _elementwise_add(ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    y = broadcast_y(x, y, attrs.get("axis", -1))
    return {"Out": [torch.add(x, y)]}


@register_op("matmul")
def _matmul(ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register_op("mul")
def _mul(ins, attrs):
    """FC-style matmul with input flattening
    (reference: paddle/fluid/operators/mul_op.cc)."""
    x, y = first(ins, "X"), first(ins, "Y")
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(math.prod(xs[:xnc]), -1)
    y2 = y.reshape(math.prod(ys[:ync]), -1)
    out = x2 @ y2
    return {"Out": [out.reshape(xs[:xnc] + ys[ync:])]}
