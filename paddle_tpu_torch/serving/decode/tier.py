"""Host-RAM KV block tier: the port of the JAX package's
``serving/decode/tier.py``.

The device arena (pool.py) is the hot tier — a fixed budget of
``num_blocks * block_size`` rows on the card. This module is the warm
tier: a byte-capacity-bounded host store of KV rows, keyed two ways:

* ``blk:<chain_hash>`` — a registered FULL block's rows, written back
  when the pool's LRU eviction recycles it (a registered block is
  immutable once written, so eviction time is the one moment its bytes
  leave the card; the pool calls ``put`` while holding its allocator
  lock, so the tier lock nests inside it, never the reverse). A later
  prompt walking the same chain re-injects these rows instead of
  recomputing them, so prefix-cache reach is bounded by host RAM.
* ``park:<request_id>:<hyp>`` — a preempted session's private rows
  ``[0:cursor)``, spilled when the scheduler parks it under arena
  exhaustion. Resume pops the entry and re-injects.

Entries hold numpy arrays on the host. The engine fills them from ONE
device-to-host copy per park (the rows of every layer gathered on the
card into one pinned buffer), so an entry's arrays may be views of that
buffer. Every entry carries a CRC32 over its row bytes as the host holds
them: ``get`` re-checksums and a mismatch QUARANTINES the entry (dropped
and counted, never served). That is safe because every row here is a
pure function of its token history under causal attention — a reader
that finds its entry quarantined (or LRU-evicted) recomputes the rows
from the tokens.

Capacity is a hard byte budget with LRU eviction; ``put`` refuses only
an entry larger than the WHOLE budget — "host tier exhausted", the one
condition that makes arena exhaustion loud again.
"""

import threading
import zlib
from collections import OrderedDict

import numpy as np

__all__ = ["HostKVTier", "TierEntry"]


def _rows_crc(kv_rows):
    crc = 0
    for k, v in kv_rows:
        # the arrays are C-contiguous: the CRC reads their buffers in place
        crc = zlib.crc32(k, crc)
        crc = zlib.crc32(v, crc)
    return crc & 0xFFFFFFFF


def _rows_bytes(kv_rows):
    return sum(k.nbytes + v.nbytes for k, v in kv_rows)


class TierEntry:
    """One spilled row run: per-layer ``[(k, v), ...]`` numpy arrays of
    shape ``[size_used, hidden]`` plus the token history that produced
    them (the recompute key for CRC walk-back)."""

    __slots__ = ("key", "tokens", "size_used", "kv_rows", "crc", "nbytes")

    def __init__(self, key, tokens, size_used, kv_rows):
        self.key = key
        self.tokens = tuple(int(t) for t in tokens)
        self.size_used = int(size_used)
        self.kv_rows = [(np.ascontiguousarray(k), np.ascontiguousarray(v))
                        for k, v in kv_rows]
        self.crc = _rows_crc(self.kv_rows)
        self.nbytes = _rows_bytes(self.kv_rows)


class HostKVTier:
    """LRU host store of spilled KV rows with CRC-verified reads.

    Thread-safety: one lock guards the map; the pool calls ``put`` under
    its allocator lock, the engine calls ``get``/``pop``/``put`` on its
    scheduler thread, and ``stats`` may be read from anywhere."""

    def __init__(self, capacity_bytes=64 << 20):
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.Lock()
        self._entries = OrderedDict()    # key -> TierEntry, LRU order
        self._bytes = 0
        self.spills = 0          # park-keyed puts
        self.writebacks = 0      # blk-keyed puts (pool eviction write-back)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.corrupt_dropped = 0
        self.rejected = 0        # entry larger than the whole budget

    def put(self, key, kv_rows, size_used, tokens=()):
        """Store (replacing any same-key entry). Returns False — host
        tier exhausted — only when the entry alone exceeds the byte
        budget; otherwise LRU-evicts until it fits."""
        ent = TierEntry(key, tokens, size_used, kv_rows)
        with self._lock:
            if ent.nbytes > self.capacity_bytes:
                self.rejected += 1
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            while self._bytes + ent.nbytes > self.capacity_bytes:
                _, lru = self._entries.popitem(last=False)
                self._bytes -= lru.nbytes
                self.evictions += 1
            self._entries[key] = ent
            self._bytes += ent.nbytes
            if key.startswith("park:"):
                self.spills += 1
            else:
                self.writebacks += 1
            return True

    def _get_locked(self, key, remove):
        ent = self._entries.get(key)
        if ent is None:
            self.misses += 1
            return None
        if _rows_crc(ent.kv_rows) != ent.crc:
            # quarantine: never serve corrupt rows — the reader
            # recomputes from tokens
            del self._entries[key]
            self._bytes -= ent.nbytes
            self.corrupt_dropped += 1
            self.misses += 1
            return None
        if remove:
            del self._entries[key]
            self._bytes -= ent.nbytes
        else:
            self._entries.move_to_end(key)
        self.hits += 1
        return ent

    def get(self, key):
        """CRC-verified lookup; corrupt entries are quarantined and read
        as a miss (None)."""
        with self._lock:
            return self._get_locked(key, remove=False)

    def pop(self, key):
        """CRC-verified take (the resume path: parked rows are consumed
        exactly once)."""
        with self._lock:
            return self._get_locked(key, remove=True)

    def discard(self, key):
        """Drop without reading (parked session cancelled/expired)."""
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is not None:
                self._bytes -= ent.nbytes

    def discard_prefix(self, prefix):
        """Drop every entry whose key starts with ``prefix`` (a relaunch
        drops the ``blk:`` write-backs of the arena it zeroed). Returns
        the count dropped."""
        with self._lock:
            keys = [k for k in self._entries if k.startswith(prefix)]
            for k in keys:
                self._bytes -= self._entries.pop(k).nbytes
            return len(keys)

    def __contains__(self, key):
        with self._lock:
            return key in self._entries

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def corrupt_entry(self, key):
        """Chaos/test seam: flip one byte of the stored rows WITHOUT
        updating the CRC, so the next read must quarantine. Returns True
        when the entry existed."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return False
            k, v = ent.kv_rows[0]
            k = np.array(k, copy=True)
            k.view(np.uint8).reshape(-1)[0] ^= 0xFF
            ent.kv_rows[0] = (k, v)
            return True

    def stats(self):
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
                "spills": self.spills,
                "writebacks": self.writebacks,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "corrupt_dropped": self.corrupt_dropped,
                "rejected": self.rejected,
            }
