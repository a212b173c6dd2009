"""Checkpointable iterator state: the data-position half of a checkpoint,
the port's copy of the JAX package's ``dataio/state.py`` (the same schema
and codec, so the blob's bytes are equal between the packages).

The schema — epoch, shard cursor, RNG state, emitted-batch count — rides
the ``incubate/checkpoint.py`` manifests: the state is serialized to a
JSON blob stored as a uint8 array under ``STATE_KEY`` inside
``state.npz``, so it inherits the per-array CRC32, the whole-file CRC,
the atomic rename, and the corrupt-walkback behavior for free.
``DataEngine`` (``engine.py``) produces such a state and
``DevicePrefetcher`` proxies it; any object with ``state_dict()`` /
``load_state_dict()`` can be attached.

Elastic translation: a per-rank cursor is only meaningful under the
shard geometry that produced it, but the GLOBAL stream position is
geometry-free. Ranks consume the epoch's padded order round-robin
(position p belongs to rank ``p % world`` at shard index ``p // world``),
so a gang whose ranks all sit at shard cursor ``c`` has consumed exactly
the first ``base + c * world`` positions of the epoch stream.
``IteratorState.global_cursor()`` performs that projection and
``elastic_resume()`` re-bases a checkpointed state onto a NEW
(world, rank): the translated state starts a fresh shard slice of the
REMAINING stream (``base`` = the global cursor, ``cursor`` = 0).
"""

import json

import numpy as np

__all__ = [
    "STATE_KEY",
    "STATE_VERSION",
    "IteratorState",
    "encode_state",
    "decode_state",
    "elastic_resume",
]

# array name inside state.npz; dunder-prefixed so it can never collide
# with a program variable name (verifier rejects those)
STATE_KEY = "__dataio_state__"
# version 2 adds `base` (the epoch-global offset this geometry's shards
# started from — 0 except after an elastic resize); version-1 states
# decode with base=0, so pre-elastic checkpoints keep resuming exactly
STATE_VERSION = 2


class IteratorState:
    """Plain data-position record.

    epoch            current epoch number (0-based)
    cursor           samples of THIS RANK's epoch shard already consumed
                     by emitted batches (skipped records count: the
                     cursor is a position in shard order, not a count of
                     good samples)
    base             epoch-global position this geometry's shards were
                     cut from (0 except after an elastic resize: the
                     resumed geometry re-shards the stream suffix
                     starting at `base`)
    emitted_batches  lifetime batch count across epochs (monotonic)
    seed             base seed the per-epoch orders derive from
    world / rank     shard geometry the cursor is valid under
    rng              reserved: the engine derives every draw from
                     (seed, epoch, idx), so no live generator state
                     exists to save; custom sources that DO keep one can
                     round-trip it here (JSON-serializable form)
    """

    def __init__(self, epoch=0, cursor=0, emitted_batches=0, seed=0,
                 world=1, rank=0, rng=None, base=0):
        self.epoch = int(epoch)
        self.cursor = int(cursor)
        self.base = int(base)
        self.emitted_batches = int(emitted_batches)
        self.seed = int(seed)
        self.world = int(world)
        self.rank = int(rank)
        self.rng = rng

    def global_cursor(self):
        """Project the per-rank shard cursor to the epoch-global stream
        position: a gang whose ranks all sit at shard cursor `cursor`
        has consumed exactly the positions ``[0, base + cursor * world)``
        of the epoch stream (ranks consume the padded order
        round-robin). This is the geometry-free coordinate an elastic
        resize hands to the next gang generation."""
        return self.base + self.cursor * self.world

    def to_dict(self):
        return {
            "version": STATE_VERSION,
            "epoch": self.epoch,
            "cursor": self.cursor,
            "base": self.base,
            "emitted_batches": self.emitted_batches,
            "seed": self.seed,
            "world": self.world,
            "rank": self.rank,
            "rng": self.rng,
        }

    @classmethod
    def from_dict(cls, d):
        version = d.get("version", STATE_VERSION)
        if version > STATE_VERSION:
            raise ValueError(
                f"dataio state version {version} is newer than this "
                f"build understands ({STATE_VERSION})"
            )
        return cls(
            epoch=d.get("epoch", 0),
            cursor=d.get("cursor", 0),
            base=d.get("base", 0),
            emitted_batches=d.get("emitted_batches", 0),
            seed=d.get("seed", 0),
            world=d.get("world", 1),
            rank=d.get("rank", 0),
            rng=d.get("rng"),
        )


def elastic_resume(d, world, rank):
    """Translate a checkpointed state dict onto a NEW shard geometry.

    The old geometry's per-rank cursor projects to the epoch-global
    position ``g = base + cursor * old_world`` (every rank of a
    step-synchronized gang checkpoints the same ``cursor`` at the same
    step, so any rank's blob yields the same ``g``); the translated
    state re-bases rank ``rank`` of the NEW ``world`` at that position:
    the new gang's shards are cut from the stream suffix ``[g, ...)``
    and together consume it exactly once — zero samples lost or
    double-consumed across the resize. ``emitted_batches`` carries over
    as the gang-lifetime count; ``epoch``/``seed`` are untouched, so the
    suffix order is the same permutation the old gang was walking.
    """
    st = IteratorState.from_dict(d)
    world = int(world)
    rank = int(rank)
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside world {world}")
    return IteratorState(
        epoch=st.epoch,
        cursor=0,
        base=st.global_cursor(),
        emitted_batches=st.emitted_batches,
        seed=st.seed,
        world=world,
        rank=rank,
        rng=st.rng,
    ).to_dict()


def encode_state(d):
    """dict -> uint8 ndarray of JSON bytes (an npz-storable array, so the
    checkpoint manifest CRCs it like any parameter)."""
    raw = json.dumps(d, sort_keys=True).encode("utf-8")
    return np.frombuffer(raw, dtype=np.uint8).copy()


def decode_state(arr):
    """uint8 ndarray (or bytes) of JSON -> dict."""
    raw = bytes(np.asarray(arr, dtype=np.uint8).tobytes())
    return json.loads(raw.decode("utf-8"))
