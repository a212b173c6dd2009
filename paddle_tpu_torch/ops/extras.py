"""Ops of the JAX package's ``ops/extras.py`` that the common surface
reaches, with its semantics: ``hinge_loss`` and ``norm``."""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import first


@register_op("hinge_loss")
def _hinge_loss(ins, attrs):
    """reference: paddle/fluid/operators/hinge_loss_op.cc —
    ``max(0, 1 - (2 label - 1) logits)``, labels in {0, 1}. A ``maximum``,
    so a margin of exactly 0 splits its grad as ``jnp.maximum`` does; the
    labels get a grad too, as in the JAX package."""
    logits = first(ins, "Logits")
    labels = first(ins, "Labels").to(logits.dtype)
    margin = 1.0 - (2.0 * labels - 1.0) * logits
    return {"Loss": [torch.maximum(torch.zeros_like(margin), margin)]}


@register_op("norm")
def _norm(ins, attrs):
    """reference: paddle/fluid/operators/norm_op.cc — l2-normalize along
    ``axis`` (the sum of squares in float32), emitting the norm as a saved
    output."""
    x = first(ins, "X")
    axis = attrs.get("axis", -1)
    eps = attrs.get("epsilon", 1e-10)
    sq = torch.sum(torch.square(x.to(torch.float32)), dim=axis, keepdim=True)
    norm = torch.sqrt(sq + eps)
    return {"Out": [(x / norm).to(x.dtype)], "Norm": [norm]}
