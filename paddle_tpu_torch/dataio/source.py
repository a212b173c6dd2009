"""Deterministic sharded sample sources.

Reference: paddle/fluid/framework/data_set.cc assigns filelist slices to
trainers and data_feed.cc channels shuffle inside each trainer — but both
draw on process-global RNG, so two runs of the same job see different
streams. Here the epoch order is a PURE FUNCTION of (seed, epoch): a
local ``random.Random((seed, epoch))`` permutes the global index space,
then each rank takes a strided slice. Resuming, re-running, or adding
workers can therefore reconstruct the exact stream from three integers
(seed, epoch, cursor) — the contract `state.py` checkpoints.

The port's copy of the JAX package's ``dataio/source.py``: the same
``mix_seed`` and the same orders, so both packages cut the same shards.
Shard geometry comes from ``parallel.env.ParallelEnv`` (the
PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM the fleet launcher exports) or
an explicit fleet role, and ragged tails wrap around so every rank's
epoch shard has identical length — collective steps never deadlock on a
rank that ran out of data one batch early.
"""

import random

from paddle_tpu_torch.utils.enforce import enforce

__all__ = ["ShardedSource", "ListSource", "FileSource", "mix_seed"]


def mix_seed(*parts):
    """Fold (seed, epoch[, idx]) into one deterministic integer seed —
    arithmetic, not hash(): stable across processes, interpreters, and
    PYTHONHASHSEED. Fixed 64-bit lanes keep the mix injective for any
    realistic part (no multiplier wraparound where a huge sample index
    could alias the next epoch's stream); python ints are arbitrary
    precision, and random.Random seeds from big ints natively."""
    acc = 0
    for p in parts:
        acc = (acc << 64) | (int(p) & 0xFFFFFFFFFFFFFFFF)
    return acc


def _discover_rank_world(fleet=None):
    """rank/world from an explicit fleet role, else the launcher env."""
    if fleet is not None:
        try:
            return int(fleet.worker_index()), int(fleet.worker_num())
        except Exception:
            pass
    from paddle_tpu_torch.parallel.env import ParallelEnv

    env = ParallelEnv()
    return env.rank, env.world_size


class ShardedSource:
    """Base class: deterministic per-epoch order + per-rank shard.

    Subclasses implement ``__len__`` (global sample count, identical on
    every rank) and ``item(idx)`` (fetch/parse global sample ``idx``).
    """

    def __init__(self, seed=0, shuffle=True, rank=None, world=None,
                 fleet=None):
        if rank is None or world is None:
            d_rank, d_world = _discover_rank_world(fleet)
            rank = d_rank if rank is None else rank
            world = d_world if world is None else world
        enforce(world >= 1, f"world must be >= 1, got {world}")
        enforce(0 <= rank < world, f"rank {rank} outside world {world}")
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.rank = int(rank)
        self.world = int(world)

    # -- subclass surface --------------------------------------------------
    def __len__(self):
        raise NotImplementedError

    def item(self, idx):
        raise NotImplementedError

    # -- deterministic order ----------------------------------------------
    def epoch_order(self, epoch):
        """Global index permutation for `epoch` — same on every rank.
        A LOCAL Random seeded from (seed, epoch): no dependence on the
        module-global RNG or on call history."""
        order = list(range(len(self)))
        if self.shuffle:
            random.Random(mix_seed(self.seed, epoch)).shuffle(order)
        return order

    def epoch_shard(self, epoch, base=0):
        """This rank's slice of the epoch order. The order is first
        padded by cyclic tiling to a multiple of `world`, so every rank
        gets exactly ceil(n / world) samples — equal step counts keep
        data-parallel collectives in lockstep even when the dataset is
        smaller than the world size.

        ``base`` (elastic resume, state.py) cuts the shards from the
        stream SUFFIX ``order[base:]`` instead of the whole epoch: a
        gang resized mid-epoch re-shards exactly the positions the old
        geometry had not consumed, under the same padding rule (the
        suffix wraps onto itself so every rank stays equal-length).
        ``base=0`` is byte-identical to the pre-elastic behavior."""
        order = self.epoch_order(epoch)
        base = int(base)
        if base < 0:
            raise ValueError(f"base must be >= 0, got {base}")
        if base:
            # positions past the real epoch length are wrap-padding the
            # old geometry already consumed — nothing left to re-shard
            order = order[base:] if base < len(order) else []
        if self.world > 1 and order:
            per_rank = -(-len(order) // self.world)
            total = per_rank * self.world
            reps = -(-total // len(order))
            order = (order * reps)[:total]
            return order[self.rank::self.world]
        return order

    def state_dict(self):
        return {
            "seed": self.seed,
            "shuffle": self.shuffle,
            "rank": self.rank,
            "world": self.world,
            "size": len(self),
        }


class ListSource(ShardedSource):
    """In-memory samples (list/sequence)."""

    def __init__(self, items, **kwargs):
        super().__init__(**kwargs)
        self._items = list(items)

    def __len__(self):
        return len(self._items)

    def item(self, idx):
        return self._items[idx]


class FileSource(ShardedSource):
    """Line-record files (the MultiSlot text layout dataset.py consumes).

    The global sample space is the concatenation of all files' non-blank
    lines in filelist order; `parse` (optional) maps the raw line to a
    sample. Lines are indexed lazily on first access so constructing the
    source on every rank stays cheap.
    """

    def __init__(self, filelist, parse=None, **kwargs):
        super().__init__(**kwargs)
        self._filelist = list(filelist)
        self._parse = parse
        self._lines = None

    def _load(self):
        if self._lines is None:
            lines = []
            for path in self._filelist:
                with open(path) as f:
                    lines.extend(l for l in f.read().splitlines()
                                 if l.strip())
            self._lines = lines
        return self._lines

    def __len__(self):
        return len(self._load())

    def item(self, idx):
        line = self._load()[idx]
        return self._parse(line) if self._parse is not None else line
