"""Per-step deduplicated gather: unique ids + inverse index, bucketed (a
copy of ``next_bucket`` and ``dedup_ids`` from the JAX package's
``embedding/gather.py``; its StableHLO evidence scan has no counterpart
here).

A CTR batch repeats feature ids heavily (the head of the zipfian slot
distribution appears in most samples). The dedup happens ONCE per batch
on the host — ``np.unique`` gives the sorted unique ids and the inverse
index — and the step gathers the slab exactly once at the unique slots:

    rows = table[slots]          # [U_pad, D]  — the ONLY table-wide gather
    out  = rows[inv]             # [B, S, D]   — local fan-out, cache-sized

and the backward's segment-sum over ``inv`` merges duplicate-id gradients
before the row scatter. Unique counts vary per batch; ``next_bucket`` pads
the slot vector to a power-of-two bucket (padding repeats slot[0]: its
forward rows are never indexed by ``inv`` and its backward segments are
zero, so padding is bit-invisible).
"""

import numpy as np

__all__ = ["dedup_ids", "next_bucket"]


def next_bucket(n, min_bucket=8):
    """Smallest power-of-two >= max(n, min_bucket)."""
    b = max(int(min_bucket), 1)
    n = max(int(n), 1)
    while b < n:
        b *= 2
    return b


def dedup_ids(ids, min_bucket=8, dedup=True):
    """(uniq u64 [U], slots_pad_len U_pad, inv int32 ids.shape).

    The batch's unique ids (sorted — np.unique order, so the slot vector
    is deterministic for a given id set), the padded bucket length, and
    the inverse index mapping every occurrence back to its unique row.
    ``dedup=False`` is the bench control: every occurrence becomes its own
    "unique" entry (inv = arange)."""
    arr = np.asarray(ids)
    flat = arr.reshape(-1).astype(np.uint64)
    if dedup:
        uniq, inv = np.unique(flat, return_inverse=True)
    else:
        uniq, inv = flat, np.arange(flat.size)
    u_pad = next_bucket(len(uniq), min_bucket)
    return uniq, u_pad, inv.reshape(arr.shape).astype(np.int32)
