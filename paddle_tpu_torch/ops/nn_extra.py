"""Ops of the JAX package's ``ops/nn_extra.py`` that the common surface
reaches, with its semantics: four activations, the tensor utilities
``argsort``, ``diag``, ``reverse``, ``rank``, ``size`` and
``crop_tensor``, the losses ``log_loss`` and ``label_smooth``, and
``adaptive_pool2d`` (MobileNet's global pool). Each is XLA code there,
plain torch here."""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import first, jnp_clip, maybe, unary_op
from paddle_tpu_torch.utils.enforce import EnforceError


def _selu(x, a):
    # exp sees no positive value: the branch ``where`` drops stays finite
    neg = a.get("alpha", 1.6732632423543772) * (
        torch.exp(torch.minimum(x, torch.zeros_like(x))) - 1)
    return a.get("scale", 1.0507009873554805) * torch.where(x > 0, x, neg)


def _soft_relu(x, a):
    t = a.get("threshold", 40.0)
    return torch.log(1 + torch.exp(jnp_clip(x, -t, t)))


# reference: paddle/fluid/operators/activation_op.cc; ``brelu`` is a clip
# (``jnp_clip``: a tie at either end splits its grad, as in the JAX package)
unary_op("selu", _selu)
unary_op("brelu", lambda x, a: jnp_clip(x, a.get("t_min", 0.0),
                                        a.get("t_max", 24.0)))
unary_op("soft_relu", _soft_relu)
unary_op("stanh", lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
    a.get("scale_a", 0.67) * x))


@register_op("argsort", nondiff_inputs=("X",))
def _argsort(ins, attrs):
    """A stable sort along ``axis``, of ``-X`` when ``descending`` (the
    JAX lowering's ``jnp.argsort(-x)``): tied elements keep their
    ascending index order either way, on the card too, where torch's
    default sort is not stable. ``Indices`` int64."""
    x = first(ins, "X")
    axis = attrs.get("axis", -1)
    key = -x if attrs.get("descending", False) else x
    _, idx = torch.sort(key, dim=axis, stable=True)
    return {"Out": [torch.gather(x, axis, idx)], "Indices": [idx]}


@register_op("diag")
def _diag(ins, attrs):
    """``jnp.diag``: a vector's diagonal matrix, a matrix's diagonal."""
    return {"Out": [torch.diag(first(ins, "Diagonal"))]}


@register_op("reverse")
def _reverse(ins, attrs):
    out = first(ins, "X")
    for axis in attrs.get("axis", [0]):
        out = torch.flip(out, (axis,))
    return {"Out": [out]}


@register_op("rank", nondiff_inputs=("Input",))
def _rank(ins, attrs):
    """X's rank, a 0-d int32."""
    x = first(ins, "Input")
    return {"Out": [torch.full((), x.dim(), dtype=torch.int32,
                               device=x.device)]}


@register_op("size", nondiff_inputs=("Input",))
def _size(ins, attrs):
    """X's element count, a 0-d int64 (the JAX package's int32 value)."""
    x = first(ins, "Input")
    return {"Out": [torch.full((), x.numel(), dtype=torch.int64,
                               device=x.device)]}


@register_op("crop_tensor")
def _crop_tensor(ins, attrs):
    """``X[o:o + s]`` over the leading axes the attributes name."""
    x = first(ins, "X")
    return {"Out": [x[tuple(slice(o, o + s) for o, s in zip(
        attrs.get("offsets"), attrs.get("shape")))]]}


@register_op("log_loss", nondiff_inputs=("Labels",))
def _log_loss(ins, attrs):
    p, y = first(ins, "Predicted"), first(ins, "Labels")
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-y * torch.log(p + eps)
                     - (1 - y) * torch.log(1 - p + eps)]}


@register_op("label_smooth")
def _label_smooth(ins, attrs):
    """``(1 - eps) X + eps prior``, the prior uniform over X's last axis
    unless ``PriorDist`` gives it."""
    x = first(ins, "X")
    eps = attrs.get("epsilon", 0.1)
    prior = maybe(ins, "PriorDist")
    uniform = prior if prior is not None else 1.0 / x.shape[-1]
    return {"Out": [(1 - eps) * x + eps * uniform]}


@register_op("adaptive_pool2d")
def _adaptive_pool2d(ins, attrs):
    """Average or max over an NCHW plane cut into ``pooled_height`` x
    ``pooled_width`` equal cells. H and W must divide by the output size,
    as in the JAX package (reference: pool_op.cc adaptive=True); torch's
    uneven adaptive regions are not used."""
    x = first(ins, "X")
    oh, ow = attrs["pooled_height"], attrs["pooled_width"]
    n, c, h, w = x.shape
    if h % oh or w % ow:
        raise EnforceError(
            f"adaptive_pool2d needs H({h})%out_h({oh})==0 and "
            f"W({w})%out_w({ow})==0 (static shapes, as in the JAX package)")
    cells = x.reshape(n, c, oh, h // oh, ow, w // ow)
    if attrs.get("pooling_type", "avg") == "max":
        return {"Out": [cells.amax(dim=(3, 5))]}
    return {"Out": [cells.mean(dim=(3, 5))]}
