"""Optimizer update op lowerings, with the semantics of the JAX package's
``ops/optimizers.py``: the arithmetic runs in float32 and the updated
parameter is cast back to its own dtype. Each op returns new tensors for
``ParamOut`` and the accumulators (whose names equal the inputs'); the
executor writes them back to the scope. The port carries ``adam``."""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import first, maybe


def _f32(x):
    return x.to(torch.float32)


@register_op("adam")
def _adam(ins, attrs):
    p = _f32(first(ins, "Param"))
    g = _f32(first(ins, "Grad"))
    m1, m2 = _f32(first(ins, "Moment1")), _f32(first(ins, "Moment2"))
    b1p, b2p = _f32(first(ins, "Beta1Pow")), _f32(first(ins, "Beta2Pow"))
    lr = _f32(first(ins, "LearningRate"))
    b1 = float(maybe(ins, "Beta1Tensor", attrs.get("beta1", 0.9)))
    b2 = float(maybe(ins, "Beta2Tensor", attrs.get("beta2", 0.999)))
    eps = attrs.get("epsilon", 1e-8)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_out = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return {
        "ParamOut": [p_out.to(first(ins, "Param").dtype)],
        "Moment1Out": [m1n],
        "Moment2Out": [m2n],
        "Beta1PowOut": [b1p * b1],
        "Beta2PowOut": [b2p * b2],
    }
