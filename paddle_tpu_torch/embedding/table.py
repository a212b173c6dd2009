"""Table config, feature-hash partition, and deterministic row init: a
copy of the JAX package's ``embedding/table.py`` (numpy only). Host rows
materialize from ``init_rows`` in both packages, so the two must give the
same bytes; ``tests/test_torch_embedding.py`` holds them to it.

The reference shards a distributed lookup table by ``id % n_pservers``
(reference: python/paddle/fluid/transpiler/distribute_transpiler.py
slice_variable round-robin); raw CTR ids are hash-clustered (consecutive
ids from one slot), so the engine partitions by a mixed hash instead:
``shard(id) = splitmix64(id ^ seed) % ep`` spreads any id distribution
evenly over the ``ep`` mesh axis, the way DLRM/Monolith hash tables do.

Row initialization is a pure function of (table seed, id): the initial
row is derived per (id, lane) from the same splitmix64 stream. A row can
therefore materialize lazily in EITHER tier — first touch on the host
store, first admission to the device cache, or after an N->M checkpoint
restore that re-partitions every id — and the bytes are identical every
time. That purity is what makes the two-tier engine's bit-exactness
guarantees (store.py) possible at all.
"""

import numpy as np

from paddle_tpu_torch.utils.enforce import enforce

__all__ = ["TableConfig", "hash_shard", "init_rows", "splitmix64"]

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def splitmix64(x):
    """Vectorized splitmix64 finalizer over uint64 ndarrays (wrapping
    arithmetic; numpy uint64 ops wrap mod 2^64 natively)."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = (x + _GOLDEN) & _U64
        x = ((x ^ (x >> np.uint64(30))) * _MIX1) & _U64
        x = ((x ^ (x >> np.uint64(27))) * _MIX2) & _U64
        return x ^ (x >> np.uint64(31))


def hash_shard(ids, n_shards, seed=0):
    """Owner shard on the ep axis for each id: splitmix64(id ^ seed) mod
    n_shards — NOT ``id % n`` (CTR ids arrive hash-clustered per slot;
    the mix keeps shard load even for any id distribution)."""
    ids = np.asarray(ids, dtype=np.uint64)
    if n_shards <= 1:
        return np.zeros(ids.shape, dtype=np.int64)
    h = splitmix64(ids ^ np.uint64(seed))
    return (h % np.uint64(n_shards)).astype(np.int64)


def init_rows(ids, dim, init_range, seed=0):
    """[len(ids), dim] float32 initial rows, a pure function of
    (seed, id, lane): uniform in [-init_range, init_range). init_range=0
    gives zero rows (the wide/linear-term convention in models/ctr.py)."""
    ids = np.asarray(ids, dtype=np.uint64).reshape(-1)
    if init_range == 0.0 or dim == 0:
        return np.zeros((len(ids), dim), dtype=np.float32)
    with np.errstate(over="ignore"):
        base = splitmix64(ids ^ np.uint64(seed))[:, None]
        lanes = (np.arange(dim, dtype=np.uint64) * _GOLDEN)[None, :]
        bits = splitmix64((base + lanes) & _U64)
    unit = (bits >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    return ((unit * 2.0 - 1.0) * float(init_range)).astype(np.float32)


class TableConfig:
    """One sharded table's static configuration.

    capacity      total device hot-cache rows, split evenly over the ep
                  shards (must divide); the slab var is [capacity, dim].
    ep            hash-partition count == the ep mesh axis size the slab
                  is row-sharded over (1 = single-shard, still cached).
    vocab_size    advisory only (ids span the full u64 space; the host
                  store grows on demand like the reference's pservers).
    init_range    uniform init half-width; 0 = zero-init (wide tables).
    lr            the table's own SGD rate — embedding tables train with
                  their own sparse rule, never the dense optimizer (an
                  Adam step on an un-touched cached row would drift it,
                  breaking cache-size invariance).
    min_bucket    smallest padded unique-id bucket (gather.py).
    """

    __slots__ = ("name", "dim", "capacity", "ep", "vocab_size",
                 "init_range", "lr", "seed", "min_bucket")

    def __init__(self, name, dim, capacity, ep=1, vocab_size=None,
                 init_range=0.01, lr=0.1, seed=0, min_bucket=8):
        self.name = str(name)
        self.dim = int(dim)
        self.capacity = int(capacity)
        self.ep = int(ep)
        self.vocab_size = vocab_size
        self.init_range = float(init_range)
        self.lr = float(lr)
        self.seed = int(seed)
        self.min_bucket = int(min_bucket)
        enforce(self.dim > 0, f"table {name}: dim must be > 0")
        enforce(self.ep >= 1, f"table {name}: ep must be >= 1")
        enforce(
            self.capacity >= self.ep and self.capacity % self.ep == 0,
            f"table {name}: capacity {self.capacity} must be a positive "
            f"multiple of ep={self.ep} (the slab row-shards evenly over "
            "the ep axis)",
        )

    @property
    def cap_per_shard(self):
        return self.capacity // self.ep

    @property
    def slab_name(self):
        return f"{self.name}__slab"

    def shard_of(self, ids):
        return hash_shard(ids, self.ep, self.seed)

    def init_for(self, ids):
        return init_rows(ids, self.dim, self.init_range, self.seed)

    def digest(self):
        """Content digest folded into the lookup op's attrs — engine
        config that changes lookup semantics joins the compile-cache
        program fingerprint through the serialized block desc."""
        return (
            f"v1:dim={self.dim}:cap={self.capacity}:ep={self.ep}"
            f":init={self.init_range!r}:lr={self.lr!r}:seed={self.seed}"
            f":minb={self.min_bucket}"
        )

    def to_attrs(self):
        return {
            "table_name": self.name,
            "dim": self.dim,
            "capacity": self.capacity,
            "ep": self.ep,
            "lr": self.lr,
            "engine_digest": self.digest(),
        }

    @classmethod
    def from_entry(cls, entry):
        """Rebuild from a program's ``_sharded_tables`` registry entry."""
        return cls(
            entry["table_name"], entry["dim"], entry["capacity"],
            ep=entry.get("ep", 1), vocab_size=entry.get("vocab_size"),
            init_range=entry.get("init_range", 0.01),
            lr=entry.get("lr", 0.1), seed=entry.get("seed", 0),
            min_bucket=entry.get("min_bucket", 8),
        )
