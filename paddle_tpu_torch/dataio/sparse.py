"""Sparse CTR batch assembly: the ``sparse_batch`` sample transform, a
copy of the JAX package's ``dataio/sparse.py`` (numpy only).

A click-log record carries VARIABLE-length feature-id lists per slot; the
transform gives a dense (ids, weights) pair per slot:

* ids pad to ``ids_per_slot`` by REPEATING the slot's first id — the
  padding id is one the batch already contains, so the engine's dedup
  admits no extra unique row for padding;
* weights carry 1.0 for real ids and 0.0 for padding — the model
  multiplies the looked-up rows by the weight, so padding contributes
  exactly 0.0 to the pooled slot embedding;
* an EMPTY slot emits ids of 0 with all-zero weights.

The JAX package runs the transform on its DataLoader's worker pool; the
port has no DataLoader yet (ROADMAP M9), so callers stack transformed
records into a batch themselves (``models/wide_deep.py`` ``make_batch``).
"""

import numpy as np

__all__ = ["make_sparse_batch_transform", "pad_slot"]


def pad_slot(ids, ids_per_slot, id_dtype="int64"):
    """(ids [S], weights [S]) from a variable-length id list: truncate
    past S, pad by repeating ids[0] at weight 0; empty -> zeros."""
    s = int(ids_per_slot)
    ids = list(ids)[:s]
    n = len(ids)
    if n == 0:
        return (np.zeros(s, dtype=id_dtype),
                np.zeros(s, dtype=np.float32))
    out = np.full(s, ids[0], dtype=id_dtype)
    out[:n] = np.asarray(ids, dtype=id_dtype)
    w = np.zeros(s, dtype=np.float32)
    w[:n] = 1.0
    return out, w


def make_sparse_batch_transform(slots, ids_per_slot, dense=(),
                                label="click", id_dtype="int64"):
    """Per-sample transform for CTR records shaped
    ``{"slots": {name: [ids...]}, <dense fields...>, label: x}``.

    Returns a tuple in feed order — for each slot name: ids [S],
    weights [S]; then each dense field as float32; then the label as
    float32 [1]. Samples missing a slot get the empty-slot encoding."""
    slots = list(slots)
    dense = list(dense)

    def transform(sample):
        rec_slots = sample.get("slots", {})
        out = []
        for name in slots:
            ids, w = pad_slot(rec_slots.get(name, ()), ids_per_slot,
                              id_dtype)
            out.append(ids)
            out.append(w)
        for name in dense:
            out.append(np.asarray(sample[name], dtype=np.float32))
        out.append(np.asarray([sample[label]], dtype=np.float32))
        return tuple(out)

    return transform
