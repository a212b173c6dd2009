"""The data engine: deterministic multi-worker input pipelines, the port's
copy of the JAX package's ``dataio/``.

* ``source``   — deterministic sharded sources: per-rank epoch shards as
  a pure function of (seed, epoch) via a local ``random.Random``.
* ``engine``   — ``DataEngine``: a worker pool with round-robin
  reassembly, so the emitted order is independent of worker timing;
  plus ``parallel_map_ordered``, the same pool as a reusable map.
* ``prefetch`` — ``DevicePrefetcher``: bounded double-buffer of batches
  staged on the card from pinned buffers on a side stream; a feed the
  host reads stays on the host; a data-parallel rank stages its rows.
* ``state``    — checkpointable iterator position (epoch, shard cursor,
  emitted-batch count) riding ``incubate/checkpoint.py`` manifests, plus
  the elastic translation (``elastic_resume``) for a resized gang.
* ``sparse``   — the ``sparse_batch`` transform (variable-length id
  lists to fixed ids and weights).

DataLoader (``from_generator(num_workers=...)``) and
``Dataset.set_num_workers`` ride this layer; queue-depth gauges and
producer/consumer wait histograms go to the port's registry, and source
reads are the ``dataio.read`` fault site of the port's injector. The
JAX package's ``dataio::`` spans wait for the port's tracer (ROADMAP
M12).
"""

from paddle_tpu_torch.dataio.engine import DataEngine, parallel_map_ordered
from paddle_tpu_torch.dataio.prefetch import DevicePrefetcher
from paddle_tpu_torch.dataio.source import FileSource, ListSource, ShardedSource
from paddle_tpu_torch.dataio.sparse import make_sparse_batch_transform, pad_slot
from paddle_tpu_torch.dataio.state import (
    STATE_KEY,
    IteratorState,
    decode_state,
    elastic_resume,
    encode_state,
)

__all__ = [
    "DataEngine",
    "make_sparse_batch_transform",
    "pad_slot",
    "parallel_map_ordered",
    "DevicePrefetcher",
    "ShardedSource",
    "ListSource",
    "FileSource",
    "IteratorState",
    "STATE_KEY",
    "encode_state",
    "decode_state",
    "elastic_resume",
]
