"""Sharded-embedding ops: dedup slab gather + fused row-sparse update, with
the semantics of the JAX package's ``ops/sharded_embedding.py``.

The host engine (``embedding/store.py``) resolves ids -> hot-cache slots
once per batch; these ops only see cache-sized tensors. The lookup's
generic grad (``core/backward.py`` emits ``sharded_embedding_lookup_grad``
with inputs Table, Slots, Inv, Out, Out@GRAD and output Table@GRAD) would
materialize a dense ``[capacity, D]`` table grad for the dense optimizer;
the deferred ``sharded_embedding_update`` pass (``passes.py``) fuses grad
and optimizer into ``sharded_embedding_sgd``, which segment-sums over the
dedup inverse index and then applies ``-lr * rowgrad`` at the slots.
"""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import first, segment_sum


@register_op("sharded_embedding_lookup", nondiff_inputs=("Slots", "Inv"))
def _sharded_embedding_lookup(ins, attrs):
    """Out[b, s, :] = Table[Slots[Inv[b, s]], :]: one gather of the unique
    rows from the slab, then the fan-out to the id occurrences."""
    table = first(ins, "Table")
    slots = first(ins, "Slots").to(torch.int64)
    inv = first(ins, "Inv").to(torch.int64)
    rows = table.index_select(0, slots)                      # [U_pad, D]
    out = rows.index_select(0, inv.reshape(-1))
    return {"Out": [out.reshape(tuple(inv.shape) + (table.shape[-1],))]}


@register_op("sharded_embedding_sgd", nondiff_inputs=("Slots", "Inv"))
def _sharded_embedding_sgd(ins, attrs):
    """Fused dedup-grad + SGD row update on the hot slab.

    OutGrad is the lookup output's cotangent; the segment-sum over Inv
    merges duplicate-id grads into per-unique-row grads (deterministic on
    every device, ``ops/common.py``). Bucket rows past the true unique
    count get no grad, so their update is ``-lr * 0.0 == -0.0``; they
    repeat a real slot, and adding -0.0 leaves every float unchanged, so
    the order of those adds cannot matter. Rows the batch never touched
    are not read or written — the property behind cache-size-invariant
    training. Returns a new slab tensor, which the executor binds to the
    slab's name."""
    table = first(ins, "Table")
    slots = first(ins, "Slots").to(torch.int64)
    inv = first(ins, "Inv").reshape(-1)
    og = first(ins, "OutGrad")
    d = table.shape[-1]
    rowg = segment_sum(og.reshape(-1, d).to(torch.float32), inv,
                       slots.shape[0])
    upd = (-float(attrs["lr"]) * rowg).to(table.dtype)
    return {"TableOut": [table.index_add(0, slots, upd)]}
