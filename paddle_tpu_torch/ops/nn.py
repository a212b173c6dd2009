"""Neural-network op lowerings: activation, softmax, convolution and
pooling, normalisation, losses and metrics, embedding, and the three
attention ops, with the semantics of the JAX package's ``ops/nn.py``.

``conv2d``, ``pool2d`` and ``batch_norm`` are XLA code in the JAX package
(``lax.conv_general_dilated``, ``reduce_window``, a composite), outside
any Pallas kernel, so here they are ``torch.nn.functional`` calls (cuDNN
on the card) and plain torch ops.

``scaled_dot_product_attention``, ``cached_attention``,
``paged_attention`` and ``dropout`` register their plain composite as
``lower`` (what shape inference and the ``off`` mode run) and a ``kernel``
lowering that goes through the CUDA kernel wrappers in ``kernels/``.
"""

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.backward import make_generic_grad_lowering
from paddle_tpu_torch.core.registry import (
    OpDef, OpRegistry, register_grad, register_op)
from paddle_tpu_torch.kernels import attention as fused
from paddle_tpu_torch.kernels import flash_attention as flash
from paddle_tpu_torch.kernels import random as random_kernels
from paddle_tpu_torch.kernels import registry as kernel_registry
from paddle_tpu_torch.ops.common import (
    SettingGuard, first, maybe, normalize_padding, rng_counter_base,
    segment_sum, seeded_rng_key)


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


# -- conv / pool ------------------------------------------------------------


class _Float32Convolutions(SettingGuard):
    """Full float32 cuDNN convolutions inside ``with FLOAT32_CONVS.on(x):``
    for a CUDA ``x``, whatever the process's TF32 setting: PyTorch's
    default (``torch.backends.cudnn.allow_tf32``, or
    ``torch.backends.cudnn.conv.fp32_precision`` where torch has it) runs
    float32 convolutions in TF32, with a 10-bit mantissa, where the JAX
    package computes them in float32."""

    @staticmethod
    def _conv_api():
        conv = getattr(torch.backends.cudnn, "conv", None)
        return conv if hasattr(conv, "fp32_precision") else None

    def _set(self):
        conv = self._conv_api()
        if conv is not None:
            saved, conv.fp32_precision = conv.fp32_precision, "ieee"
        else:
            saved = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
        return saved

    def _restore(self, saved):
        conv = self._conv_api()
        if conv is not None:
            conv.fp32_precision = saved
        else:
            torch.backends.cudnn.allow_tf32 = saved

    @staticmethod
    def applies(x):
        return x.is_cuda


FLOAT32_CONVS = _Float32Convolutions()


def _pad_spatial(x, padding, value, ksize=None):
    """``x`` NCHW and the padding the torch call takes: the symmetric pads
    as they are (for pooling only up to half the window, torch's limit),
    anything else through ``F.pad`` with ``value`` first."""
    (hl, hh), (wl, wh) = padding
    if hl == hh and wl == wh and (ksize is None or (
            2 * hl <= ksize[0] and 2 * wl <= ksize[1])):
        return x, (hl, wl)
    return F.pad(x, (wl, wh, hl, hh), value=value), (0, 0)


@register_op("conv2d")
def _conv2d(ins, attrs):
    """reference: paddle/fluid/operators/conv_op.cc. NCHW input with OIHW
    filters, or NHWC with HWIO (the JAX package's dimension numbers),
    strides, dilations and groups; the padding as ``normalize_padding``
    resolves it (asymmetric pads go through ``F.pad``, since ``F.conv2d``
    pads both sides alike). Full float32 on the card (``FLOAT32_CONVS``)."""
    x, w = first(ins, "Input"), first(ins, "Filter")
    strides = tuple(attrs.get("strides", [1, 1]))
    dilations = tuple(attrs.get("dilations", [1, 1]))
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    if nhwc:
        x, w = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    padding = normalize_padding(attrs, 2, tuple(w.shape[2:4]), strides,
                                tuple(x.shape[2:4]))
    x, pad = _pad_spatial(x, padding, 0.0)
    with FLOAT32_CONVS.on(x):
        out = F.conv2d(x, w, None, strides, pad, dilations,
                       attrs.get("groups", 1))
    return {"Output": [out.permute(0, 2, 3, 1) if nhwc else out]}


_conv2d_generic_grad = make_generic_grad_lowering(OpRegistry.get("conv2d"))


@register_grad("conv2d")
def _conv2d_grad(ins, attrs):
    """The generic grad (the forward rerun under ``torch.autograd``), with
    the backward convolutions in full float32 too: autograd runs them when
    ``torch.autograd.grad`` is called, after the forward's scope ends."""
    with FLOAT32_CONVS.on(first(ins, "Input")):
        return _conv2d_generic_grad(ins, attrs)


def _window_sum(x, ksize, strides, pad):
    return F.avg_pool2d(x, ksize, strides, pad, count_include_pad=True,
                        divisor_override=1)


@register_op("pool2d")
def _pool2d(ins, attrs):
    """reference: paddle/fluid/operators/pool_op.cc. Max or average over
    ``ksize`` windows (-inf, or zero, padding); ``exclusive`` averages
    divide by the count of unpadded elements, and only when there is
    padding. ``global_pooling`` (or ``adaptive`` to 1x1) reduces the whole
    plane; ``adaptive`` to ``ksize`` cells uses uniform regions (exact when
    the plane divides)."""
    x = first(ins, "X")
    is_max = attrs.get("pooling_type", "max") == "max"
    nhwc = attrs.get("data_format", "NCHW") != "NCHW"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    adaptive = attrs.get("adaptive", False)
    if attrs.get("global_pooling", False) or (
            adaptive and list(attrs.get("ksize", [1, 1])) == [1, 1]):
        out = (x.amax(dim=(2, 3), keepdim=True) if is_max
               else x.mean(dim=(2, 3), keepdim=True))
    elif adaptive:
        oh, ow = attrs["ksize"]
        n, c, h, wd = x.shape
        cells = x[:, :, :(h // oh) * oh, :(wd // ow) * ow].reshape(
            n, c, oh, h // oh, ow, wd // ow)
        out = cells.amax(dim=(3, 5)) if is_max else cells.mean(dim=(3, 5))
    else:
        ksize = tuple(attrs.get("ksize", [2, 2]))
        strides = tuple(attrs.get("strides", ksize))
        padding = normalize_padding(attrs, 2, ksize, strides,
                                    tuple(x.shape[2:4]))
        if is_max:
            x, pad = _pad_spatial(x, padding, -math.inf, ksize)
            out = F.max_pool2d(x, ksize, strides, pad)
        else:
            padded, pad = _pad_spatial(x, padding, 0.0, ksize)
            out = _window_sum(padded, ksize, strides, pad)
            if attrs.get("exclusive", True) and any(p != (0, 0)
                                                    for p in padding):
                ones, _ = _pad_spatial(torch.ones_like(x), padding, 0.0, ksize)
                out = out / _window_sum(ones, ksize, strides, pad)
            else:
                out = out / (ksize[0] * ksize[1])
    return {"Out": [out.permute(0, 2, 3, 1) if nhwc else out]}


# -- normalisation -----------------------------------------------------------


@register_op("batch_norm", nondiff_inputs=("Mean", "Variance"))
def _batch_norm(ins, attrs):
    """reference: paddle/fluid/operators/batch_norm_op.cc, as the JAX
    package computes it: statistics in float32 (float64 for a float64
    input, which the JAX package never runs), the biased variance from
    the mean (two passes); Paddle's ``momentum`` weights the OLD running
    statistic (``MeanOut = m * Mean + (1 - m) * batch mean``, the
    variance's with the biased batch variance), and ``SavedVariance`` is
    the inverse std ``1 / sqrt(var + eps)``. The running statistics are
    outputs, not side effects: ``MeanOut``/``VarianceOut`` carry the names
    of ``Mean``/``Variance``, so the executor writes them back to the
    scope. A grad op's rerun computes them again and writes nothing.
    ``is_test`` or ``use_global_stats`` normalises with the running
    statistics and passes them through."""
    x = first(ins, "X")
    scale, bias = first(ins, "Scale"), first(ins, "Bias")
    mean, var = first(ins, "Mean"), first(ins, "Variance")
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    compute_dtype = torch.promote_types(x.dtype, torch.float32)
    if attrs.get("data_layout", "NCHW") == "NCHW":
        axes = tuple(i for i in range(x.dim()) if i != 1)
        shape = (1, -1) + (1,) * (x.dim() - 2)
    else:
        axes, shape = tuple(range(x.dim() - 1)), (-1,)
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        use_mean, use_var = mean, var
        mean_out, var_out = mean, var
        saved_mean, saved_var = torch.zeros_like(mean), torch.zeros_like(var)
    else:
        compute = x.to(compute_dtype)
        use_mean = compute.mean(dim=axes)
        use_var = (compute - use_mean.reshape(shape)).square().mean(dim=axes)
        mean_out = momentum * mean + (1.0 - momentum) * use_mean.to(mean.dtype)
        var_out = momentum * var + (1.0 - momentum) * use_var.to(var.dtype)
        saved_mean = use_mean
        saved_var = 1.0 / torch.sqrt(use_var + eps)
    inv = 1.0 / torch.sqrt(use_var.to(compute_dtype) + eps)
    y = (x.to(compute_dtype) - use_mean.reshape(shape)) * inv.reshape(shape)
    y = y * scale.reshape(shape) + bias.reshape(shape)
    return {"Y": [y.to(x.dtype)], "MeanOut": [mean_out],
            "VarianceOut": [var_out], "SavedMean": [saved_mean],
            "SavedVariance": [saved_var]}


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


@register_op("cross_entropy", nondiff_inputs=("Label",))
def _cross_entropy(ins, attrs):
    """``-log(p[label] + 1e-8)`` over probabilities ``X`` (or ``-sum(label
    * log(X + 1e-8))`` with soft labels); zero where the label equals
    ``ignore_index``, which is replaced by class 0 before the gather."""
    x, label = first(ins, "X"), first(ins, "Label")
    eps = 1e-8
    if attrs.get("soft_label", False):
        return {"Y": [-(label * torch.log(x + eps)).sum(dim=-1, keepdim=True)]}
    if label.dim() == x.dim():
        label = label[..., 0]
    label = label.unsqueeze(-1)
    ignored = label == attrs.get("ignore_index", -100)
    idx = torch.where(ignored, torch.zeros_like(label), label).to(torch.int64)
    loss = -torch.log(torch.gather(x, -1, idx) + eps)
    return {"Y": [torch.where(ignored, torch.zeros_like(loss), loss)]}


@register_op("square_error_cost")
def _square_error_cost(ins, attrs):
    return {"Out": [torch.square(first(ins, "X") - first(ins, "Y"))]}


@register_op("accuracy", nondiff_inputs=("Out", "Indices", "Label"))
def _accuracy(ins, attrs):
    """reference: paddle/fluid/operators/metrics/accuracy_op.cc: a row is
    correct when any of its top-k ``Indices`` is its label. ``Accuracy``
    float32 ``[1]``, ``Correct`` and ``Total`` int32 ``[1]``."""
    idx, label = first(ins, "Indices"), first(ins, "Label")
    if label.dim() == 1:
        label = label[:, None]
    correct = (idx == label).any(dim=1).to(torch.float32).sum()
    total = torch.full((), idx.shape[0], dtype=torch.float32,
                       device=idx.device)
    return {"Accuracy": [(correct / total).reshape((1,))],
            "Correct": [correct.to(torch.int32).reshape((1,))],
            "Total": [total.to(torch.int32).reshape((1,))]}


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


@register_grad("lookup_table_v2")
def _lookup_table_grad(ins, attrs):
    """``W@GRAD``: each row the sum of the cotangents of the positions that
    read it (none from ids at ``padding_idx``). The gather's autograd sums
    them with ``index_add_``, which on the card adds with atomics in an
    order that changes from run to run; on the card the sum runs through
    ``index_put_(accumulate=True)``, which sorts the ids first (one order
    every run), so ranks that compute one replicated table's grad apart
    hold the same bits. On the CPU ``index_add_`` adds in id order."""
    w, ids = first(ins, "W"), first(ins, "Ids")
    flat = ids.reshape(-1)
    g = first(ins, "Out@GRAD").reshape((flat.numel(),) + tuple(w.shape[1:]))
    g = g.to(w.dtype)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        g = torch.where((flat == padding_idx).reshape((-1,) + (1,) * (
            g.dim() - 1)), torch.zeros((), dtype=g.dtype, device=g.device), g)
    dw = torch.zeros_like(w)
    if dw.device.type == "cuda":
        dw.index_put_((flat,), g, accumulate=True)
    else:
        dw.index_add_(0, flat, g)
    return {"W@GRAD": [dw]}


@register_op("lookup_table_ps", nondiff_inputs=("Idx",))
def _lookup_table_ps(ins, attrs):
    """PS-backed embedding lookup: `Rows` are the batch's unique embedding
    vectors pulled from the parameter server by the worker (host side,
    fleet/parameter_server.py), `Idx` maps each id occurrence to its row
    (the JAX package's ``ops/nn.py`` ``lookup_table_ps``)."""
    rows, idx = first(ins, "Rows"), first(ins, "Idx")
    out = rows.index_select(0, idx.reshape(-1).to(torch.int64))
    return {"Out": [out.reshape(tuple(idx.shape) + tuple(rows.shape[1:]))]}


@register_grad("lookup_table_ps")
def _lookup_table_ps_grad(ins, attrs):
    """Rows@GRAD: the occurrences' grads summed into their rows — the
    SelectedRows grad aggregation of the reference's lookup_table_grad
    (reference: paddle/fluid/operators/lookup_table_op.h
    LookupTableGradKernel), the JAX package's gather vjp. A segment sum
    (``ops/common.py``): the same bits on every run, on the card too."""
    rows, idx = first(ins, "Rows"), first(ins, "Idx")
    og = first(ins, "Out@GRAD")
    d = rows.shape[-1]
    return {"Rows@GRAD": [segment_sum(og.reshape(-1, d).to(rows.dtype),
                                      idx.reshape(-1), rows.shape[0])]}


@register_op("auc", nondiff_inputs=("Predict", "Label"))
def _auc(ins, attrs):
    """Streaming AUC via fixed histogram buckets (reference:
    paddle/fluid/operators/metrics/auc_op.cc), the JAX package's ``auc``:
    the same bucket of each prediction, so the same accumulators (the JAX
    package keeps them int32, the port int64), and the trapezoid over the
    descending threshold in float32."""
    pred, label = first(ins, "Predict"), first(ins, "Label")
    stat_pos, stat_neg = first(ins, "StatPos"), first(ins, "StatNeg")
    num_thresholds = attrs.get("num_thresholds", 4095)
    pos_score = pred[:, -1] if pred.dim() == 2 else pred
    bucket = torch.clamp((pos_score * num_thresholds).to(torch.int64), 0,
                         num_thresholds)
    lab = label.reshape(-1).to(stat_pos.dtype)
    new_pos = stat_pos.index_add(0, bucket, lab)
    new_neg = stat_neg.index_add(0, bucket, 1 - lab)
    # integrate trapezoid over descending threshold
    tp = torch.cumsum(new_pos.flip(0), 0)
    fp = torch.cumsum(new_neg.flip(0), 0)
    tpr = tp.to(torch.float32) / torch.clamp(tp[-1], min=1).to(torch.float32)
    fpr = fp.to(torch.float32) / torch.clamp(fp[-1], min=1).to(torch.float32)
    auc = 0.5 * ((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1])).sum()
    return {"AUC": [auc.reshape((1,))], "StatPosOut": [new_pos],
            "StatNegOut": [new_neg]}


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
        out, mask = fwd(x, seeded_rng_key(ins, attrs), p, upscale,
                        rng_counter_base(ins, x.numel()))
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


# -- the layers dygraph reaches ----------------------------------------------
#
# XLA code in the JAX package (``paddle_tpu/ops/nn.py``), with no Pallas
# kernel: plain torch here, and their grads are the generic one.


@register_op("prelu")
def _prelu(ins, attrs):
    """``x`` where positive, else ``alpha * x``; ``mode="channel"``
    broadcasts a ``[C]`` alpha over NCHW."""
    x, alpha = first(ins, "X"), first(ins, "Alpha")
    if attrs.get("mode", "all") == "channel" and alpha.dim() == 1:
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return {"Out": [torch.where(x > 0, x, alpha * x)]}


@register_op("conv2d_transpose")
def _conv2d_transpose(ins, attrs):
    """Transposed convolution with the reference's filter layout
    ``[in_c, out_c/groups, kh, kw]`` (``torch``'s own), the strides and
    groups; the JAX lowering takes no dilation, so neither does this one.
    Pads of two values are symmetric; four are (top, bottom, left, right),
    cropped from the unpadded output. Full float32 on the card."""
    x, w = first(ins, "Input"), first(ins, "Filter")
    strides = tuple(attrs.get("strides", [1, 1]))
    groups = attrs.get("groups", 1)
    pads = list(attrs.get("paddings", [0, 0]))
    if len(pads) == 2:
        pads = [pads[0], pads[0], pads[1], pads[1]]
    top, bottom, left, right = pads
    symmetric = top == bottom and left == right
    with FLOAT32_CONVS.on(x):
        out = F.conv_transpose2d(
            x, w, None, strides, (top, left) if symmetric else 0, 0, groups)
    if not symmetric:
        out = out[:, :, top:out.shape[2] - bottom, left:out.shape[3] - right]
    return {"Output": [out]}


def _affine_channels(y, ins):
    """``y * Scale + Bias`` with ``[C]`` parameters broadcast over NCHW."""
    scale, bias = maybe(ins, "Scale"), maybe(ins, "Bias")
    shape = (1, -1) + (1,) * (y.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


@register_op("instance_norm")
def _instance_norm(ins, attrs):
    """Each (sample, channel) plane normalised by its own mean and biased
    variance, then scaled and shifted per channel."""
    x = first(ins, "X")
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    y = _affine_channels((x - mean) / torch.sqrt(var + eps), ins)
    return {"Y": [y], "SavedMean": [mean], "SavedVariance": [var]}


@register_op("group_norm")
def _group_norm(ins, attrs):
    """The channels cut into ``groups``; each (sample, group) normalised
    by its own mean and biased variance, then scaled and shifted per
    channel. ``Mean``/``Variance`` are ``[N, groups]``."""
    x = first(ins, "X")
    groups = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    g = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, g.dim()))
    mean = g.mean(dim=axes, keepdim=True)
    var = (g - mean).square().mean(dim=axes, keepdim=True)
    y = _affine_channels(((g - mean) / torch.sqrt(var + eps)).reshape(x.shape),
                         ins)
    return {"Y": [y], "Mean": [mean.reshape(n, groups)],
            "Variance": [var.reshape(n, groups)]}
