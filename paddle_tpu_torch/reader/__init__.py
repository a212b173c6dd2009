"""Reader stack: decorators + device-prefetching DataLoader (the port's
copy of the JAX package's ``reader/``).

Reference: python/paddle/reader/ (decorators) and
python/paddle/fluid/reader.py (DataLoader/PyReader).
"""

from paddle_tpu_torch.reader.dataloader import DataLoader, PyReader
from paddle_tpu_torch.reader.decorator import (
    batch,
    buffered,
    cache,
    chain,
    compose,
    firstn,
    map_readers,
    robust,
    shuffle,
    xmap_readers,
)

__all__ = [
    "DataLoader",
    "PyReader",
    "batch",
    "buffered",
    "cache",
    "chain",
    "compose",
    "firstn",
    "map_readers",
    "robust",
    "shuffle",
    "xmap_readers",
]
