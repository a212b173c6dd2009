"""Neural-network op lowerings: activation, softmax, normalisation,
loss, embedding, and the three attention ops, with the semantics of the
JAX package's ``ops/nn.py``.

``scaled_dot_product_attention``, ``cached_attention``,
``paged_attention`` and ``dropout`` register their plain composite as
``lower`` (what shape inference and the ``off`` mode run) and a ``kernel``
lowering that goes through the CUDA kernel wrappers in ``kernels/``.
"""

import math

import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.registry import (
    OpDef, OpRegistry, register_grad, register_op)
from paddle_tpu_torch.kernels import attention as fused
from paddle_tpu_torch.kernels import flash_attention as flash
from paddle_tpu_torch.kernels import random as random_kernels
from paddle_tpu_torch.kernels import registry as kernel_registry
from paddle_tpu_torch.ops.common import first, maybe, seeded_rng_key


@register_op("relu")
def _relu(ins, attrs):
    return {"Out": [torch.relu(first(ins, "X"))]}


@register_op("sigmoid")
def _sigmoid(ins, attrs):
    return {"Out": [torch.sigmoid(first(ins, "X"))]}


@register_op("tanh")
def _tanh(ins, attrs):
    return {"Out": [torch.tanh(first(ins, "X"))]}


@register_op("gelu")
def _gelu(ins, attrs):
    approximate = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [torch.nn.functional.gelu(first(ins, "X"),
                                             approximate=approximate)]}


@register_op("softmax")
def _softmax(ins, attrs):
    return {"Out": [torch.softmax(first(ins, "X"), dim=attrs.get("axis", -1))]}


@register_op("log_softmax")
def _log_softmax(ins, attrs):
    return {"Out": [torch.log_softmax(first(ins, "X"),
                                      dim=attrs.get("axis", -1))]}


@register_op("layer_norm")
def _layer_norm(ins, attrs):
    """Statistics in float32 over the axes from ``begin_norm_axis`` on,
    ``(x - mean) / sqrt(var + eps)`` with the biased variance."""
    x = first(ins, "X")
    begin = attrs.get("begin_norm_axis", 1)
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(begin, x.dim()))
    compute = x.to(torch.float32)
    mean = compute.mean(dim=axes, keepdim=True)
    var = (compute - mean).square().mean(dim=axes, keepdim=True)
    y = (compute - mean) / torch.sqrt(var + eps)
    scale, bias = maybe(ins, "Scale"), maybe(ins, "Bias")
    norm_shape = tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape(norm_shape).to(torch.float32)
    if bias is not None:
        y = y + bias.reshape(norm_shape).to(torch.float32)
    stat_shape = tuple(x.shape[:begin])
    return {"Y": [y.to(x.dtype)], "Mean": [mean.reshape(stat_shape)],
            "Variance": [var.reshape(stat_shape)]}


@register_op("softmax_with_cross_entropy", nondiff_inputs=("Label",))
def _softmax_with_ce(ins, attrs):
    """Numerically stable through log-softmax. A label equal to
    ``ignore_index`` (-1 in BERT's MLM head) gives a zero loss and a zero
    grad: it is replaced by class 0 before the gather (``torch.gather``
    raises on -1, where the JAX package wraps it) and its loss zeroed
    after."""
    logits, label = first(ins, "Logits"), first(ins, "Label")
    axis = attrs.get("axis", -1) % logits.dim()
    log_probs = torch.log_softmax(logits, dim=axis)
    softmax = torch.exp(log_probs)
    if attrs.get("soft_label", False):
        loss = -(label * log_probs).sum(dim=axis, keepdim=True)
    else:
        squeezed = label.squeeze(axis) if label.dim() == logits.dim() else label
        ignored = (squeezed == attrs.get("ignore_index", -100)).unsqueeze(axis)
        idx = torch.where(ignored, torch.zeros_like(squeezed.unsqueeze(axis)),
                          squeezed.unsqueeze(axis)).to(torch.int64)
        picked = torch.gather(log_probs, axis, idx)
        loss = torch.where(ignored, torch.zeros_like(picked), -picked)
    return {"Softmax": [softmax], "Loss": [loss]}


@register_op("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ins, attrs):
    """``max(x, 0) - x * label + log1p(exp(-|x|))``, zero where the label
    equals ``ignore_index``. ``torch.maximum`` splits its grad at a tie as
    ``jnp.maximum`` does."""
    x, label = first(ins, "X"), first(ins, "Label")
    loss = (torch.maximum(x, torch.zeros_like(x)) - x * label
            + torch.log1p(torch.exp(-torch.abs(x))))
    ignore = attrs.get("ignore_index", -100)
    loss = torch.where(label == ignore, torch.zeros_like(loss), loss)
    if attrs.get("normalize", False):
        norm = torch.clamp_min((label != ignore).sum().to(loss.dtype), 1.0)
        loss = loss / norm
    return {"Out": [loss]}


@register_op("lookup_table_v2", nondiff_inputs=("Ids",))
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
    kernel=_cached_attention_kernel, nondiff_inputs=("Bias",),
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
    kernel=_paged_attention_kernel, nondiff_inputs=("Rows", "Bias"),
))


def _sdpa_args(ins, attrs):
    q, k, v = first(ins, "Q"), first(ins, "K"), first(ins, "V")
    scale = attrs.get("sm_scale") or 1.0 / math.sqrt(q.shape[-1])
    return q, k, v, maybe(ins, "Bias"), bool(attrs.get("causal", False)), scale


def _sdpa_reference(ins, attrs):
    """Unfused attention: q, k, v ``[B, H, S, D]``, optional additive key
    bias ``[B, S]``, causal fill -1e30 — the flash kernels' plain version."""
    return {"Out": [flash.flash_attention_composite(*_sdpa_args(ins, attrs))[0]]}


def _sdpa_kernel(ins, attrs):
    if kernel_registry.mode() == "off":
        return _sdpa_reference(ins, attrs)
    q, k, v, bias, causal, scale = _sdpa_args(ins, attrs)
    return {"Out": [flash.flash_attention(q, k, v, bias=bias, causal=causal,
                                          sm_scale=scale)]}


OpRegistry.register(OpDef(
    "scaled_dot_product_attention", _sdpa_reference, kernel=_sdpa_kernel,
))


# -- dropout (stateful: the executor's key) ---------------------------------


def _dropout_lowering(fwd):
    """The dropout op (reference: paddle/fluid/operators/dropout_op.cc;
    the JAX package's ``paddle_tpu/ops/nn.py`` ``_dropout``) over
    ``fwd(x, key, p, upscale) -> (Out, Mask)``. ``Mask`` (``x.dtype``) is
    a saved output that the grad reuses, so the backward never draws
    again. ``is_test`` draws nothing."""

    def lower(ins, attrs):
        x = first(ins, "X")
        p = attrs.get("dropout_prob", 0.5)
        upscale = (attrs.get("dropout_implementation", "downgrade_in_infer")
                   == "upscale_in_train")
        if attrs.get("is_test", False):
            out = x if upscale else x * _f32_scalar(1.0 - p, x)
            return {"Out": [out], "Mask": [torch.ones_like(x)]}
        if x.is_meta:
            return {"Out": [torch.empty_like(x)], "Mask": [torch.empty_like(x)]}
        out, mask = fwd(x, seeded_rng_key(ins, attrs), p, upscale)
        return {"Out": [out], "Mask": [mask]}

    return lower


def _f32_scalar(v, like):
    """``v`` as a 0-d tensor of the float32 nearest it, beside ``like``:
    the JAX op's Python scalar is a float32 operand, and a 0-d tensor
    divisor divides (torch multiplies by the reciprocal of a Python
    scalar divisor on CUDA)."""
    return torch.full((), prng.f32(v), dtype=like.dtype, device=like.device)


_dropout_reference = _dropout_lowering(random_kernels.dropout_fwd_plain)
_dropout_fused = _dropout_lowering(random_kernels.dropout_fwd)


def _dropout_kernel(ins, attrs):
    if kernel_registry.mode() == "off":
        return _dropout_reference(ins, attrs)
    return _dropout_fused(ins, attrs)


OpRegistry.register(OpDef("dropout", _dropout_reference,
                          kernel=_dropout_kernel, stateful=True))


@register_grad("dropout")
def _dropout_grad(ins, attrs):
    """``dOut * Mask``, divided by ``1 - p`` (float32, a true division)
    when upscaling; ``is_test`` passes ``dOut`` through (scaled by
    ``1 - p`` for ``downgrade_in_infer``)."""
    dout = first(ins, "Out@GRAD")
    p = attrs.get("dropout_prob", 0.5)
    upscale = (attrs.get("dropout_implementation", "downgrade_in_infer")
               == "upscale_in_train")
    if attrs.get("is_test", False):
        return {"X@GRAD": [dout if upscale else dout * _f32_scalar(1.0 - p, dout)]}
    dx = dout * first(ins, "Mask")
    if upscale:
        dx = dx / _f32_scalar(1.0 - p, dx)
    return {"X@GRAD": [dx]}
