"""Sharded embedding engine: hash-partitioned tables with a device hot
cache over a host-RAM tier, ported from the JAX package's ``embedding/``.

* ``table.py``  — per-table config, the feature-hash partition and the
  deterministic per-id row initializer (numpy; the same bytes as the JAX
  package's).
* ``gather.py`` — per-batch dedup: unique ids + inverse index, bucketed.
* ``store.py``  — the two-tier store: host-RAM tier, device slab with
  per-shard LRU admission and write-back eviction. Misses are admitted by
  the hand-written admission kernel (``kernels/embedding.py``).

``layers.sharded_embedding`` is the graph entry point; ``EmbeddingEngine``
is the host-side controller (``prepare_feed`` per step, ``flush`` before
reads).
"""

from paddle_tpu_torch.embedding.table import TableConfig, hash_shard, init_rows
from paddle_tpu_torch.embedding.gather import dedup_ids, next_bucket
from paddle_tpu_torch.embedding.store import EmbeddingEngine, HostStore

__all__ = [
    "TableConfig",
    "hash_shard",
    "init_rows",
    "dedup_ids",
    "next_bucket",
    "EmbeddingEngine",
    "HostStore",
]
