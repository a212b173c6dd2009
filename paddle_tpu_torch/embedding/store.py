"""Two-tier embedding store: device hot-ID cache over a host-RAM tier,
ported from the JAX package's ``embedding/store.py``.

The full table lives in host RAM as hash-sharded (id -> row) maps (rows
materialize lazily from the deterministic initializer, so the u64 id space
costs nothing until touched), while the rows the traffic hits live in a
device slab (``<table>__slab``, ``[capacity, dim]``) managed by per-shard
LRU admission. The step reads and UPDATES only the slab
(``ops/sharded_embedding.py``); the host tier is reconciled by write-back:

  * admission — a missed id is pulled from the host tier and written into
    its hash-owner shard's slot range of the slab by the admission kernel
    (``kernels/embedding.py``), in place in the scope's slab tensor;
  * eviction  — the per-shard LRU victim's CURRENT device row is read back
    (on the training thread, before the scatter reuses its slot) and
    pushed to the host tier;
  * flush     — every dirty (device-updated, not yet pushed) row is pushed.

That write-back discipline is the bit-exactness contract: a row's value is
ALWAYS its last trained value, whether it sat on the device the whole run
or bounced through the host tier, so training is bit-identical across
cache capacities. Pushes run on a small pool (``flush`` is the barrier); a
pull of an id with an in-flight push waits for that push first.

Pulls and pushes fire the ``lookup.pull`` / ``lookup.push`` fault sites
(``resilience/faults.py``) under the JAX package's lookup retry policy,
as the JAX engine's do through its ``distributed/lookup.py``. Checkpoints (``incubate/checkpoint.py``,
``AutoCheckpoint(extra_state=engine)``) flush the hot cache and save the
host tier per ep shard in the format-2 manifest; a restore re-hashes the
ids under the current ep and cold-resets the slab, so the first batch
re-admits its rows through the admission kernel. Not ported yet: a
mesh-sharded slab (ROADMAP M9's remainder). Metrics are plain counters
behind the same ``stats()`` keys.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from paddle_tpu_torch.embedding.gather import dedup_ids
from paddle_tpu_torch.embedding.table import TableConfig
from paddle_tpu_torch.kernels import embedding as kemb
from paddle_tpu_torch.observability import lockdep
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience.retry import RetryPolicy
from paddle_tpu_torch.utils.enforce import EnforceError, enforce

__all__ = ["HostStore", "EmbeddingEngine", "STORE_PREFIX"]

# The write-back discipline: a table's HostStore lock comes before the
# engine's pending-push lock — a push worker finishes store.push() before
# touching the markers, and nothing pulls from the table while holding
# the marker map.
lockdep.declare_order("embedding.table", "embedding.pending")

#: checkpoint array-name prefix — names carrying it are engine state, not
#: scope variables (incubate/checkpoint.py routes them to the engine)
STORE_PREFIX = "__embedding_store__::"

# Transient host-tier failures (injected TransientFault) retry under the
# JAX package's lookup policy; pulls are idempotent and a push overwrites
# rows, so a retry repeats nothing.
_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.05, max_delay_s=1.0,
                     deadline_s=30.0)


class HostStore:
    """Host-RAM overflow tier: per-ep-shard (id -> float32 row) maps.

    Authoritative for every row NOT currently dirty on the device. Absent
    rows materialize from the deterministic initializer at pull time."""

    def __init__(self, cfg):
        self.cfg = cfg
        self._shards = [dict() for _ in range(cfg.ep)]
        self._lock = lockdep.named_lock("embedding.table")

    def __len__(self):
        with self._lock:
            return sum(len(s) for s in self._shards)

    def pull(self, ids):
        """[len(ids), dim] rows and the number materialized by this pull;
        fires the ``lookup.pull`` fault site and retries under the shared
        policy."""
        ids = np.asarray(ids, dtype=np.uint64).reshape(-1)
        owners = self.cfg.shard_of(ids)

        def do_pull():
            faults.fire("lookup.pull")
            rows = np.empty((len(ids), self.cfg.dim), dtype=np.float32)
            with self._lock:
                absent = [
                    i for i, (idv, k) in enumerate(zip(ids.tolist(),
                                                       owners.tolist()))
                    if idv not in self._shards[k]
                ]
                if absent:
                    # one vectorized init for every absent id (per-id init
                    # is a pure function, so batching is byte-identical)
                    init = self.cfg.init_for(ids[absent])
                    for j, i in enumerate(absent):
                        self._shards[owners[i]][int(ids[i])] = init[j]
                for i, (idv, k) in enumerate(zip(ids.tolist(),
                                                 owners.tolist())):
                    rows[i] = self._shards[k][idv]
            return rows, len(absent)

        return _RETRY.call(do_pull)

    def push(self, ids, rows):
        """Overwrite rows (write-back from the device tier); fires the
        ``lookup.push`` fault site under the shared retry policy."""
        ids = np.asarray(ids, dtype=np.uint64).reshape(-1)
        rows = np.asarray(rows, dtype=np.float32).reshape(len(ids), -1)
        owners = self.cfg.shard_of(ids)

        def do_push():
            faults.fire("lookup.push")
            with self._lock:
                for idv, k, row in zip(ids.tolist(), owners.tolist(), rows):
                    self._shards[k][idv] = row.copy()

        _RETRY.call(do_push)

    def snapshot_blocks(self):
        """Per-shard (ids u64 [n_k], rows f32 [n_k, dim]) with ids sorted
        inside each shard — the deterministic block layout the format-2
        checkpoint path records."""
        with self._lock:
            blocks = []
            for shard in self._shards:
                ids = np.fromiter(shard.keys(), dtype=np.uint64,
                                  count=len(shard))
                order = np.argsort(ids, kind="stable")
                ids = ids[order]
                rows = (
                    np.stack([shard[i] for i in ids.tolist()])
                    if len(ids) else
                    np.zeros((0, self.cfg.dim), dtype=np.float32)
                )
                blocks.append((ids, rows))
            return blocks

    def restore(self, ids, rows):
        """Rebuild from flat (ids, rows) — re-partitioned by the CURRENT
        hash config, so an N-shard save restores onto M shards with
        bit-identical row values."""
        ids = np.asarray(ids, dtype=np.uint64).reshape(-1)
        rows = np.asarray(rows, dtype=np.float32).reshape(len(ids), -1)
        owners = self.cfg.shard_of(ids)
        with self._lock:
            self._shards = [dict() for _ in range(self.cfg.ep)]
            for idv, k, row in zip(ids.tolist(), owners.tolist(), rows):
                self._shards[k][idv] = row.copy()

    def rows(self):
        """``{id: row}`` of every materialized row (copies)."""
        with self._lock:
            return {i: r.copy() for shard in self._shards
                    for i, r in shard.items()}


class _TableRuntime:
    """One table's host-side state: slot map, per-shard LRU, dirty set."""

    def __init__(self, cfg, scope, engine):
        self.cfg = cfg
        self.scope = scope
        self.engine = engine
        self.store = HostStore(cfg)
        self._slot = {}                      # id -> slab row index
        self._dirty = set()
        self._oldest_dirty = None            # monotonic ts of oldest dirty row
        self._pending_push = {}              # id -> Future (in-flight write-back)
        self._staging = kemb.Staging()       # K5's upload buffers
        self.hits = self.misses = 0
        self.evictions = self.writebacks = self.prefetched = 0
        self._reset_slots()

    def _reset_slots(self):
        cps = self.cfg.cap_per_shard
        self._slot.clear()
        self._lru = [dict() for _ in range(self.cfg.ep)]  # id -> slot, insert-ordered
        self._free = [list(range((k + 1) * cps - 1, k * cps - 1, -1))
                      for k in range(self.cfg.ep)]

    # -- slab access -------------------------------------------------------
    def slab(self):
        """The scope's slab tensor, looked up anew on every call: the
        executor rebinds the name each step (``sharded_embedding_sgd``
        writes ``TableOut`` under it)."""
        v = self.scope.find_var(self.cfg.slab_name)
        enforce(
            isinstance(v, torch.Tensor),
            f"table {self.cfg.name}: slab var {self.cfg.slab_name!r} not in "
            "scope (run the startup program before preparing feeds)",
        )
        return v

    def reset_slab(self):
        """Zero the slab on its device and forget every slot."""
        old = self.slab()
        self.scope.set(self.cfg.slab_name, torch.zeros(
            (self.cfg.capacity, self.cfg.dim), dtype=torch.float32,
            device=old.device))
        self._reset_slots()
        self._dirty.clear()
        self._oldest_dirty = None

    # -- the per-step path -------------------------------------------------
    def lookup(self, ids, train=True):
        """Resolve a batch: admit misses, evict victims (write-back),
        return (slots int32 [U_pad], inv int32 ids.shape) feeds.
        ``train=False`` (inference) marks no row dirty."""
        uniq, u_pad, inv = dedup_ids(ids, self.cfg.min_bucket)
        order = uniq.tolist()
        curr = set(order)
        owner = dict(zip(order, self.cfg.shard_of(uniq).tolist()))
        miss = [i for i in order if i not in self._slot]
        miss_set = set(miss)
        self.hits += len(order) - len(miss)
        self.misses += len(miss)

        if miss:
            self._wait_pushes(miss)
            rows, _fresh = self.store.pull(miss)
            # allocate a slot in each id's hash-owner shard, collecting LRU
            # victims (never a member of the current batch)
            evicted, evicted_slots, new_slots = [], [], []
            for idv in miss:
                k = owner[idv]
                if self._free[k]:
                    s = self._free[k].pop()
                else:
                    victim = next(
                        (c for c in self._lru[k] if c not in curr), None)
                    if victim is None:
                        raise EnforceError(
                            f"table {self.cfg.name}: shard {k} needs more "
                            f"than its {self.cfg.cap_per_shard} cache slots "
                            "for ONE batch's unique ids — raise capacity "
                            "or shrink the batch"
                        )
                    s = self._lru[k].pop(victim)
                    del self._slot[victim]
                    evicted.append(victim)
                    evicted_slots.append(s)
                self._slot[idv] = s
                self._lru[k][idv] = s
                new_slots.append(s)
            self.evictions += len(evicted)

            slab = self.slab()
            dirty_ev = [i for i in evicted if i in self._dirty]
            if dirty_ev:
                # read back BEFORE the scatter reuses the slots: the
                # victims' device values are the authoritative ones
                ev_slots = [s for i, s in zip(evicted, evicted_slots)
                            if i in self._dirty]
                self._async_push(dirty_ev, kemb.read_rows(slab, ev_slots))
                self._dirty.difference_update(dirty_ev)
            kemb.admit_rows(slab, new_slots, rows, self._staging)

        # LRU touch for hits (misses were appended above)
        for idv in order:
            if idv not in miss_set:
                lru = self._lru[owner[idv]]
                lru[idv] = lru.pop(idv)

        if train:
            self._dirty.update(curr)
            if self._oldest_dirty is None:
                self._oldest_dirty = time.monotonic()

        slots = np.fromiter((self._slot[i] for i in order), dtype=np.int32,
                            count=len(order))
        if len(slots) < u_pad:
            pad = slots[0] if len(slots) else np.int32(0)
            slots = np.concatenate(
                [slots, np.full(u_pad - len(slots), pad, dtype=np.int32)])
        return slots, inv

    def prefetch(self, ids):
        """Materialize the next batch's missing host-tier rows on the push
        pool (the async pull): by the time lookup() runs, its pull finds
        them resident."""
        uniq, _u, _inv = dedup_ids(ids, self.cfg.min_bucket)
        miss = [i for i in uniq.tolist() if i not in self._slot]
        if not miss:
            return None

        def warm():
            _rows, fresh = self.store.pull(miss)
            with self.engine._push_lock:
                self.prefetched += fresh

        return self.engine._pool.submit(warm)

    # -- write-back --------------------------------------------------------
    def _async_push(self, ids, rows):
        """Push host ``rows`` for ``ids`` on the pool."""
        self.writebacks += len(ids)
        done = threading.Event()

        def push():
            done.wait()  # marker registration precedes the write
            self.store.push(ids, rows)
            with self.engine._push_lock:
                for i in ids:
                    # pop ONLY our own marker: a newer in-flight push for
                    # the same id keeps its marker
                    if self._pending_push.get(i) is fut:
                        del self._pending_push[i]

        fut = self.engine._pool.submit(push)
        with self.engine._push_lock:
            for i in ids:
                self._pending_push[i] = fut
        done.set()
        return fut

    def _wait_pushes(self, ids):
        """A pull of an id with an in-flight write-back must observe the
        pushed value — wait for exactly those pushes."""
        with self.engine._push_lock:
            futs = {self._pending_push[i] for i in ids
                    if i in self._pending_push}
        for f in futs:
            f.result()

    def flush(self):
        """Push every dirty device row to the host tier, after draining
        every in-flight write-back. Reads only the dirty rows."""
        with self.engine._push_lock:
            pending = set(self._pending_push.values())
        for f in pending:
            f.result()
        dirty = sorted(self._dirty)
        if dirty:
            rows = kemb.read_rows(self.slab(), [self._slot[i] for i in dirty])
            self._async_push(dirty, rows).result()
            self._dirty.clear()
        self._oldest_dirty = None

    def staleness(self):
        """Seconds since the oldest device row not yet written back became
        dirty; 0 when every row is written back."""
        if not self._dirty:
            self._oldest_dirty = None
        return (0.0 if self._oldest_dirty is None
                else time.monotonic() - self._oldest_dirty)

    def stats(self):
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "writebacks": self.writebacks,
            "occupancy": len(self._slot),
            "store_rows": len(self.store),
            "hit_rate": self.hits / max(1, self.hits + self.misses),
        }


class EmbeddingEngine:
    """Host-side controller for every sharded table of a program.

        engine = EmbeddingEngine(scope=scope)
        for batch, nxt in pairwise(batches):
            feed = engine.prepare_feed(main, dict(batch))
            engine.prefetch(main, nxt)            # optional async pull
            exe.run(main, feed=feed, ...)
        engine.flush()                            # before external reads

    The slab of each table lives where the startup program (or a
    checkpoint's restore) put it; the raw ids stay on the host, only the
    int32 ``<t>__slots`` / ``<t>__inv`` feeds reach the device.

    Checkpointing: ``AutoCheckpoint(..., extra_state=engine)`` flushes
    the hot cache and saves the host tier through the format-2 per-shard
    manifest path; resume restores it bit-identically (N -> M re-hash
    included) and cold-resets the device cache.
    """

    def __init__(self, scope=None, push_workers=2):
        from paddle_tpu_torch.core.scope import global_scope

        self._scope = scope if scope is not None else global_scope()
        self._tables = {}
        self._pool = ThreadPoolExecutor(
            max_workers=push_workers, thread_name_prefix="embedding-push")
        self._pending_restore = {}   # checkpoint arrays for tables not
        #                              registered yet (resume() often runs
        #                              before the first prepare_feed)
        self._push_lock = lockdep.named_lock("embedding.pending")

    @property
    def tables(self):
        return dict(self._tables)

    def register(self, cfg):
        enforce(cfg.name not in self._tables,
                f"table {cfg.name!r} already registered")
        rt = _TableRuntime(cfg, self._scope, self)
        rt.reset_slab()
        self._tables[cfg.name] = rt
        if self._pending_restore:
            self._apply_restore(cfg.name, rt)
        return rt

    def _runtime_for(self, entry):
        rt = self._tables.get(entry["table_name"])
        if rt is None:
            rt = self.register(TableConfig.from_entry(entry))
        return rt

    # -- the step API ------------------------------------------------------
    def prepare_feed(self, program, feed, train=True):
        """Translate each table's raw id feed into the (slots, inv) feeds
        the step consumes. Mutates and returns ``feed``. Must run on the
        training thread, in step order — cache state advances with the
        stream."""
        tables = getattr(program, "_sharded_tables", None) or {}
        for entry in tables.values():
            ids = feed.get(entry["ids"])
            if ids is None:
                continue
            slots, inv = self._runtime_for(entry).lookup(ids, train=train)
            feed[entry["slots"]] = slots
            feed[entry["inv"]] = inv
        return feed

    def prefetch(self, program, next_feed):
        """Announce the NEXT batch's ids: missing host-tier rows
        materialize on the background pool."""
        tables = getattr(program, "_sharded_tables", None) or {}
        futs = []
        for entry in tables.values():
            ids = next_feed.get(entry["ids"])
            if ids is None:
                continue
            f = self._runtime_for(entry).prefetch(ids)
            if f is not None:
                futs.append(f)
        return futs

    def flush(self):
        for rt in self._tables.values():
            rt.flush()

    def stats(self):
        return {name: rt.stats() for name, rt in self._tables.items()}

    def host_rows(self):
        """``{table: {id: row}}`` of the host tier after a ``flush``: the
        whole trained table state."""
        self.flush()
        return {name: rt.store.rows() for name, rt in self._tables.items()}

    # -- checkpoint protocol (incubate/checkpoint.py extra_state) ----------
    def owns(self, name):
        return name.startswith(STORE_PREFIX)

    def checkpoint_arrays(self):
        """Hot cache flushed first, then the host tier per table as TWO
        logical arrays (ids u64, rows f32) blocked per ep shard — the
        format-2 per-shard manifest entries (``_ShardSnap``), so each shard
        carries its own CRC and bounds and N -> M restores stitch."""
        from paddle_tpu_torch.incubate.checkpoint import _ShardSnap

        self.flush()
        out = {}
        for name, rt in self._tables.items():
            blocks = rt.store.snapshot_blocks()
            total = sum(len(ids) for ids, _rows in blocks)
            dim = rt.cfg.dim
            if total == 0:
                out[STORE_PREFIX + name + "::ids"] = np.zeros(
                    (0,), dtype=np.uint64)
                out[STORE_PREFIX + name + "::rows"] = np.zeros(
                    (0, dim), dtype=np.float32)
                continue
            id_blocks, row_blocks, off = [], [], 0
            for ids, rows in blocks:
                if not len(ids):
                    continue
                id_blocks.append(((off,), (off + len(ids),), ids))
                row_blocks.append(((off, 0), (off + len(ids), dim), rows))
                off += len(ids)
            out[STORE_PREFIX + name + "::ids"] = _ShardSnap(
                (total,), "uint64", f"ep({rt.cfg.ep})", id_blocks)
            out[STORE_PREFIX + name + "::rows"] = _ShardSnap(
                (total, dim), "float32", f"ep({rt.cfg.ep})", row_blocks)
        return out

    def restore_arrays(self, arrays):
        """Rebuild each table's host tier from checkpoint arrays (ids
        re-hashed under the CURRENT ep config — N -> M restores are
        bit-identical in value) and cold-reset the device cache: the first
        batch re-admits its working set from the restored tier. Arrays for
        tables not registered yet are stashed and applied at
        registration."""
        self._pending_restore = dict(arrays)
        for name, rt in self._tables.items():
            self._apply_restore(name, rt)

    def _apply_restore(self, name, rt):
        ids = self._pending_restore.pop(STORE_PREFIX + name + "::ids", None)
        rows = self._pending_restore.pop(STORE_PREFIX + name + "::rows", None)
        rt.reset_slab()
        if ids is None or rows is None:
            rt.store.restore(np.zeros((0,), np.uint64),
                             np.zeros((0, rt.cfg.dim), np.float32))
        else:
            rt.store.restore(ids, rows)

    def close(self):
        self._pool.shutdown(wait=True)
