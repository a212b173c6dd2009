"""The inference fusions' target ops, with the semantics of the JAX
package's ``ops/fused.py``:

* ``fc`` — what ``fc_fuse`` collapses mul + elementwise_add [+ act] into
  (reference: paddle/fluid/operators/fc_op.cc). A matrix product: the JAX
  op is an XLA dot, so ``torch.matmul`` (a bf16 product sums in float32
  on the card, ``FLOAT32_REDUCTIONS``).
* ``multihead_matmul`` — packed q|k|v projections into attention
  (reference: fused/multihead_matmul_op.cc). Without ``BiasQK`` the
  attention runs on the hand-written flash kernel K1
  (``kernels/flash_attention.py``); the full ``[B, H, S, S]`` bias form,
  which the flash kernel does not take, is the composite, as in the JAX
  op.
"""

import math

import torch

from paddle_tpu_torch.core.registry import OpDef, OpRegistry, register_op
from paddle_tpu_torch.kernels import flash_attention as flash
from paddle_tpu_torch.kernels import registry as kernel_registry
from paddle_tpu_torch.ops.common import first, maybe
from paddle_tpu_torch.ops.math import FLOAT32_REDUCTIONS
from paddle_tpu_torch.utils.enforce import EnforceError

_FC_ACTS = {
    "": lambda x: x,
    "identity": lambda x: x,
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    # exact (erf) form — the gelu op's default (fc_fuse refuses to fold an
    # approximate gelu)
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="none"),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


@register_op("fc")
def _fc(ins, attrs):
    x, w = first(ins, "Input"), first(ins, "W")
    b = maybe(ins, "Bias")
    k = attrs.get("in_num_col_dims", 1)
    x2 = x.reshape(math.prod(x.shape[:k]), -1)
    with FLOAT32_REDUCTIONS.on(x2):
        out = x2 @ w
    if b is not None:
        out = out + b.reshape(1, -1)
    act = attrs.get("activation_type", "") or ""
    if act not in _FC_ACTS:
        raise EnforceError(f"fc: unsupported activation_type {act!r}")
    out = _FC_ACTS[act](out)
    return {"Out": [out.reshape(tuple(x.shape[:k]) + (w.shape[1],))]}


def _split_qkv(ins, attrs):
    """``Input [B, S, 3*H*D]`` (+ ``Bias [3*H*D]``) as q, k, v
    ``[B, H, S, D]``."""
    x = first(ins, "Input")
    bias = maybe(ins, "Bias")
    H = attrs.get("head_number", 1)
    B, S, C3 = x.shape
    D = C3 // 3 // H
    if bias is not None:
        x = x + bias.reshape(1, 1, -1)
    qkv = x.reshape(B, S, 3, H, D)
    return [qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3)]


def _merge_heads(out):
    B, H, S, D = out.shape
    return {"Out": [out.permute(0, 2, 1, 3).reshape(B, S, H * D)]}


def _multihead_composite(q, k, v, bias_qk, scale):
    with FLOAT32_REDUCTIONS.on(q):
        s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias_qk is not None:
        s = s + bias_qk
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    with FLOAT32_REDUCTIONS.on(p):
        return torch.matmul(p, v)


def _multihead_reference(ins, attrs):
    q, k, v = _split_qkv(ins, attrs)
    return _merge_heads(_multihead_composite(
        q, k, v, maybe(ins, "BiasQK"), attrs.get("alpha", 1.0)))


def _multihead_kernel(ins, attrs):
    if kernel_registry.mode() == "off" or maybe(ins, "BiasQK") is not None:
        return _multihead_reference(ins, attrs)
    q, k, v = _split_qkv(ins, attrs)
    return _merge_heads(flash.flash_attention(
        q, k, v, sm_scale=attrs.get("alpha", 1.0)))


OpRegistry.register(OpDef(
    "multihead_matmul", _multihead_reference, kernel=_multihead_kernel,
    nondiff_inputs=("BiasQK",),
))
