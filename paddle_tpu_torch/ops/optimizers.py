"""Optimizer update op lowerings, with the semantics of the JAX package's
``ops/optimizers.py``: the arithmetic runs in float32 and the updated
parameter is cast back to its own dtype. ``sgd`` and ``adam`` return new
tensors for ``ParamOut`` and the accumulators (whose names equal the
inputs'); the executor writes them back to the scope. ``sgd_sparse``
updates its parameter in place (the counterpart of the JAX package's
donated buffer): an optimizer op runs after every op that reads the
parameter, and rewriting a whole ``[V, D]`` table to touch a few thousand
rows would cost far more than the update."""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.kernels import registry as kernel_registry
from paddle_tpu_torch.kernels import sparse_update
from paddle_tpu_torch.ops.common import first, maybe, segment_sum
from paddle_tpu_torch.utils.flags import flags


def _f32(x):
    return x.to(torch.float32)


@register_op("sgd")
def _sgd(ins, attrs):
    p, g, lr = first(ins, "Param"), first(ins, "Grad"), first(ins, "LearningRate")
    out = _f32(p) - _f32(lr) * _f32(g)
    return {"ParamOut": [out.to(p.dtype)]}


@register_op("sgd_sparse", nondiff_inputs=("Ids",))
def _sgd_sparse(ins, attrs):
    """SelectedRows-analog row update (reference: paddle/fluid/operators/
    optimizers/sgd_op.h sparse branch), emitted by the
    ``sparse_weight_update`` pass in place of lookup_table_v2_grad + sgd:
    the looked-up rows' cotangent scatter-subtracts straight into the
    touched parameter rows, in place.

    Flag off: one accumulating ``index_put_`` (duplicate ids combine inside
    it, deterministically on every device). Flag on
    (``FLAGS_pallas_sparse_update``): the duplicates are merged first
    (``torch.unique`` — a sync with the card — and a segment-sum of the
    scaled rows), then the sparse-row kernel K6 adds each merged row once
    (``kernels/sparse_update.py``; kernel mode ``off`` takes its plain
    version). ``torch.unique`` returns exactly the unique ids, so no fill
    rows reach the kernel."""
    p = first(ins, "Param")
    ids = first(ins, "Ids").reshape(-1)
    rows = first(ins, "RowGrad")
    lr = _f32(first(ins, "LearningRate")).reshape(())
    d = p.shape[-1]
    rows2 = rows.reshape(-1, d).to(p.dtype)
    pi = attrs.get("padding_idx", -1)
    if pi is not None and pi >= 0:
        # the forward zeroed padding rows, so their grads must not land
        rows2 = torch.where((ids == pi)[:, None], 0.0, rows2)
    scaled = -(lr.to(p.dtype)) * rows2
    if flags.pallas_sparse_update:
        uniq, inv = torch.unique(ids, sorted=True, return_inverse=True)
        merged = segment_sum(scaled, inv, uniq.shape[0])
        update = (sparse_update.sparse_row_update_plain
                  if kernel_registry.mode() == "off"
                  else sparse_update.sparse_row_update)
        return {"ParamOut": [update(p, uniq, merged)]}
    return {"ParamOut": [p.index_put_((ids.to(torch.int64),), scaled,
                                      accumulate=True)]}


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
