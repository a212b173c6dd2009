"""Elementwise / matmul / reduction op lowerings, with the semantics of
the JAX package's ``ops/math.py`` (Paddle's ``axis`` broadcasting for the
elementwise ops). Matrix products go to ``torch.matmul``: the JAX package
leaves them to XLA, outside any Pallas kernel. A bf16 or float16 product
(AMP's white list) sums in float32 on the card, as XLA's does
(``FLOAT32_REDUCTIONS``)."""

import math

import torch

from paddle_tpu_torch.core.backward import make_generic_grad_lowering
from paddle_tpu_torch.core.registry import OpRegistry, register_grad, register_op
from paddle_tpu_torch.ops.common import (
    SettingGuard, broadcast_y, first, maybe, reduce_axes)
from paddle_tpu_torch.parallel import env as penv

_LOW = (torch.bfloat16, torch.float16)


class _Float32Reductions(SettingGuard):
    """bf16 and float16 cuBLAS products that sum in float32 inside ``with
    FLOAT32_REDUCTIONS.on(x):`` for a CUDA ``x`` of a 16-bit type. PyTorch
    lets cuBLAS reduce such products in the low type by default
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    and ``allow_fp16_reduced_precision_reduction`` are True), where XLA,
    on a TPU and on a GPU, accumulates a bf16 dot in float32. The guard
    turns both off, and float16 accumulation (``allow_fp16_accumulation``,
    where torch has it) too, as ``ops/nn.py``'s ``FLOAT32_CONVS`` holds
    convolutions in float32."""

    _FLAGS = ("allow_bf16_reduced_precision_reduction",
              "allow_fp16_reduced_precision_reduction",
              "allow_fp16_accumulation")

    def _set(self):
        matmul, saved = torch.backends.cuda.matmul, {}
        for name in self._FLAGS:
            try:
                saved[name] = getattr(matmul, name)
            except AttributeError:   # a torch without the flag
                continue
            setattr(matmul, name, False)
        return saved

    def _restore(self, saved):
        for name, value in saved.items():
            setattr(torch.backends.cuda.matmul, name, value)

    @staticmethod
    def applies(x):
        return x.is_cuda and x.dtype in _LOW


FLOAT32_REDUCTIONS = _Float32Reductions()


def _elementwise(name, fn):
    @register_op(name)
    def _lower(ins, attrs, _fn=fn):
        x, y = first(ins, "X"), first(ins, "Y")
        y = broadcast_y(x, y, attrs.get("axis", -1))
        return {"Out": [_fn(x, y)]}


_elementwise("elementwise_add", torch.add)
_elementwise("elementwise_sub", torch.sub)
_elementwise("elementwise_mul", torch.mul)
_elementwise("elementwise_div", torch.div)
_elementwise("elementwise_max", torch.maximum)
_elementwise("elementwise_min", torch.minimum)


@register_op("square")
def _square(ins, attrs):
    return {"Out": [torch.square(first(ins, "X"))]}


@register_op("sign")
def _sign(ins, attrs):
    return {"Out": [torch.sign(first(ins, "X"))]}


@register_op("top_k")
def _top_k(ins, attrs):
    """The k largest values along the last axis, largest first, and their
    int64 indices (``jax.lax.top_k``; tied values may come in another
    order)."""
    x = first(ins, "X")
    k = int(maybe(ins, "K", attrs.get("k", 1)))
    vals, idx = torch.topk(x, k, dim=-1)
    return {"Out": [vals], "Indices": [idx]}


@register_op("pow")
def _pow(ins, attrs):
    factor = maybe(ins, "FactorTensor", attrs.get("factor", 1.0))
    return {"Out": [torch.pow(first(ins, "X"), factor)]}


@register_op("matmul")
def _matmul(ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    with FLOAT32_REDUCTIONS.on(x):
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
    with FLOAT32_REDUCTIONS.on(x):
        out = x2 @ y2
    return {"Out": [out.reshape(xs[:xnc] + ys[ync:])]}


def _float32_reduction_grad(op_type):
    """The generic grad of ``op_type`` (its forward rerun under
    ``torch.autograd``) with the backward products under
    ``FLOAT32_REDUCTIONS`` too: autograd runs them when
    ``torch.autograd.grad`` is called, after the forward's scope ends."""
    generic = make_generic_grad_lowering(OpRegistry.get(op_type))

    @register_grad(op_type)
    def grad(ins, attrs):
        with FLOAT32_REDUCTIONS.on(first(ins, "X")):
            return generic(ins, attrs)

    return grad


_float32_reduction_grad("matmul")
_float32_reduction_grad("mul")


@register_op("scale")
def _scale(ins, attrs):
    x = first(ins, "X")
    scale = maybe(ins, "ScaleTensor", attrs.get("scale", 1.0))
    bias = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * scale + bias]}
    return {"Out": [(x + bias) * scale]}


@register_op("sum")
def _sum(ins, attrs):
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register_op("clip")
def _clip(ins, attrs):
    return {"Out": [torch.clamp(first(ins, "X"), attrs.get("min"),
                                attrs.get("max"))]}


def _batch_axis(attrs):
    """The data axis a batch reduction all-reduces over: that of a dense
    data-parallel run, for the ops its plan marks ``_dp_batch`` (their
    ``X`` holds this rank's rows of the batch; ``parallel/
    data_parallel.py``), else None."""
    return penv.current_data_axis() if attrs.get("_dp_batch") else None


def _batch_total(x, attrs, axis):
    """The global sum of this rank's partial sum ``x``. The rerun of the
    reduction in its generic grad (``_dp_batch`` == "rerun") keeps the
    local sum: its value is never read, and the backward of the global
    sum to this rank's rows is the identity."""
    if attrs["_dp_batch"] == "rerun":
        return x
    return penv.psum(x, axis)


@register_op("mean")
def _mean(ins, attrs):
    """The mean of ``X``; of the global batch under a dense data-parallel
    run: the ranks' sums all-reduced, over the global count."""
    x = first(ins, "X")
    axis = _batch_axis(attrs)
    if axis is None:
        return {"Out": [x.mean().reshape((1,))]}
    total = _batch_total(x.sum(), attrs, axis)
    # a 0-d divisor: torch multiplies by the reciprocal of a Python
    # scalar divisor on CUDA
    count = torch.full((), x.numel() * axis.size, dtype=total.dtype,
                       device=total.device)
    return {"Out": [(total / count).reshape((1,))]}


@register_op("reduce_sum")
def _reduce_sum(ins, attrs):
    x = first(ins, "X")
    out = torch.sum(x, dim=reduce_axes(attrs, x.dim()),
                    keepdim=attrs.get("keep_dim", False))
    axis = _batch_axis(attrs)
    if axis is not None:
        out = _batch_total(out, attrs, axis)
    if out.dim() == 0 and not attrs.get("keep_scalar", False):
        out = out.reshape((1,))
    return {"Out": [out]}
