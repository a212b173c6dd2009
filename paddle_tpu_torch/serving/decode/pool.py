"""Paged KV-pool bookkeeping: slot allocator, block allocator, radix
prefix index, and the whole-prompt prefill cache.

The device side of the pool is ONE flat ``[R, H]`` row arena per layer
per K/V inside the decode/inject programs (model.py), where
``R = num_blocks * block_size``; this module is the host side: which
block is free, which slot owns which blocks, and — storage dedup on
top of the whole-prompt prefill cache — a **radix tree over chained
block hashes** so N requests sharing a prompt prefix share PHYSICAL
blocks, not just prefill compute.

Sharing rules (all bit-exactness-preserving by construction — a KV row
for position ``p`` is a pure function of ``tokens[:p+1]`` under causal
attention, so content-equal prefixes have byte-equal rows):

* **Full blocks** are immutable once written and are registered in the
  radix tree keyed by the chain hash of their token history. A later
  prompt that walks the same chain references the same physical rows
  (refcount++) and skips both the inject AND the storage.
* **Partial tail blocks** are shareable only when their host-side rows
  are retained (the prefill cache supplies them); a shared partial is
  frozen — the first writer to APPEND at its free offset diverges from
  its sharers and pays a **copy-on-write**: a fresh private block plus a
  host-row re-inject, never a mutation another slot could observe.
* **Generated-token blocks** are always private (refcount 1, never
  registered): speculative/greedy continuations differ per request, so
  indexing them would only grow the tree.

A retired request's refcount-0 REGISTERED blocks stay cached (LRU) so
the next prompt with the same prefix still shares storage; eviction
returns the LRU cached block to the free list when allocation needs it.

Locks: one lock guards the allocator (``decode.blocks``), another the
tree (``decode.radix``); the pool calls into the tree while holding its
own lock, never the reverse: the declared order
``decode.blocks -> decode.radix`` for the lockdep witness.

The device arenas here are torch tensors; the prefill cache keeps the
prefill's K/V rows as the device tensors the prefill produced.
"""

import hashlib
from collections import OrderedDict

import numpy as np

from paddle_tpu_torch.observability import lockdep

__all__ = ["SlotPool", "PrefixCache", "BlockPool", "Block", "prompt_key",
           "block_hashes"]

# the pool calls into the radix tree under its own lock, never the reverse
lockdep.declare_order("decode.blocks", "decode.radix")


def prompt_key(prompt_ids):
    """Content hash of a prompt (the whole-prompt prefill dedup key)."""
    arr = np.ascontiguousarray(np.asarray(prompt_ids, dtype=np.int64))
    return hashlib.sha256(arr.tobytes()).hexdigest()


def _tok_bytes(tokens):
    return np.ascontiguousarray(
        np.asarray(list(tokens), dtype=np.int64)).tobytes()


def block_hashes(tokens, block_size):
    """Chained content hashes of the FULL blocks covering ``tokens``:
    ``h[i] = sha256(h[i-1] || tokens[i*bs:(i+1)*bs])``. The chain makes
    a block hash name its whole history, so equal hashes mean equal
    prefixes — the radix key, and the fleet router's block-affinity key
    (same first block -> same replica -> the replica that already holds
    those physical rows)."""
    bs = int(block_size)
    toks = [int(t) for t in tokens]
    out = []
    h = b"paged-kv-v1"
    for i in range(len(toks) // bs):
        h = hashlib.sha256(h + _tok_bytes(toks[i * bs:(i + 1) * bs])).digest()
        out.append(h.hex())
    return out


class SlotPool:
    """Fixed-capacity slot allocator. Slots are just indices into the
    decode batch's leading axis; state per slot lives with the
    scheduler. Not thread-safe by itself — the scheduler owns it from
    one loop thread."""

    def __init__(self, slots):
        self.slots = int(slots)
        self._free = list(range(self.slots - 1, -1, -1))  # pop() -> slot 0 first
        self._active = set()

    def acquire(self):
        """Lowest free slot index, or None when the batch is full."""
        if not self._free:
            return None
        s = self._free.pop()
        self._active.add(s)
        return s

    def release(self, slot):
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        self._active.discard(slot)
        self._free.append(slot)
        self._free.sort(reverse=True)

    @property
    def free_count(self):
        return len(self._free)

    @property
    def active_count(self):
        return len(self._active)

    def reset(self):
        self._free = list(range(self.slots - 1, -1, -1))
        self._active.clear()


class PrefixCache:
    """Bounded LRU of whole-prompt prefill results keyed by prompt
    content hash (prefill COMPUTE dedup; the BlockPool radix below is
    the storage dedup that rides on top of it).

    Values are tuples ``(kv_rows, logits_row)`` where ``kv_rows`` is the
    per-layer ``[1, L, H]`` K/V list and ``logits_row`` the ``[V]``
    logits at the prompt's last position, kept as the tensors the
    prefill produced.
    Thread-safe (submissions from many clients race admission)."""

    def __init__(self, capacity=64):
        self.capacity = int(capacity)
        self._map = OrderedDict()
        self._lock = lockdep.named_lock("decode.prefix")
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            val = self._map.get(key)
            if val is None:
                self.misses += 1
                return None
            self._map.move_to_end(key)
            self.hits += 1
            return val

    def put(self, key, kv_rows, logits_row):
        if self.capacity <= 0:
            return
        with self._lock:
            self._map[key] = (list(kv_rows), logits_row)
            self._map.move_to_end(key)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def __len__(self):
        with self._lock:
            return len(self._map)


class Block:
    """One fixed-size run of ``block_size`` arena rows. ``row0`` is its
    first physical row; position ``p`` of a sequence whose block list
    holds this block at chunk ``p // bs`` lives at row
    ``row0 + p % bs``. ``host_rows`` (per-layer ``[(k, v), ...]`` numpy
    rows, present only for prefill-sourced blocks) is what makes a
    partial block COW-able: divergence re-injects these bytes into a
    fresh block."""

    __slots__ = ("id", "row0", "size_used", "tokens", "chain_hash",
                 "refcount", "host_rows", "registered", "partial_of")

    def __init__(self, bid, row0):
        self.id = bid
        self.row0 = row0
        self.reset()

    def reset(self):
        self.size_used = 0
        self.tokens = ()
        self.chain_hash = None
        self.refcount = 0
        self.host_rows = None
        self.registered = False
        self.partial_of = None   # parent chain hash for partial entries


class _RadixNode:
    __slots__ = ("children", "block_id", "chain_hash", "partials", "parent",
                 "tokens")

    def __init__(self, chain_hash, parent=None, tokens=()):
        self.children = {}       # tokens-tuple -> _RadixNode (full blocks)
        self.partials = {}       # tokens-tuple -> block id (shared tails)
        self.block_id = None
        self.chain_hash = chain_hash
        self.parent = parent
        self.tokens = tuple(tokens)


class _RadixTree:
    """Radix tree over block token-chunks; each depth-d node names one
    FULL block whose history is the d-chunk chain, carrying the chain
    hash. Partial tails hang off their parent node keyed by the tail
    tokens."""

    def __init__(self):
        self._root = _RadixNode(chain_hash="root")
        self._lock = lockdep.named_lock("decode.radix")
        self._by_block = {}      # block id -> node (or (node, tail-key))

    def lookup_chain(self, tokens, block_size):
        """Longest registered full-block chain covering ``tokens``:
        returns ``(block_ids, last_node, tail_block_id)`` where
        ``tail_block_id`` is a registered shared PARTIAL holding exactly
        the remaining tail tokens (or None)."""
        bs = int(block_size)
        toks = [int(t) for t in tokens]
        with self._lock:
            node, ids = self._root, []
            n_full = len(toks) // bs
            for i in range(n_full):
                chunk = tuple(toks[i * bs:(i + 1) * bs])
                child = node.children.get(chunk)
                # a node whose block was evicted while a descendant stays
                # registered keeps its place in the tree but names no
                # block: the chain breaks there
                if child is None or child.block_id is None:
                    break
                node = child
                ids.append(node.block_id)
            tail = tuple(toks[len(ids) * bs:])
            tail_bid = node.partials.get(tail) if tail else None
            return ids, node, tail_bid

    def insert_full(self, tokens_chunk, chain_hash, block_id, parent_node):
        with self._lock:
            chunk = tuple(int(t) for t in tokens_chunk)
            child = parent_node.children.get(chunk)
            if child is None:
                child = _RadixNode(chain_hash, parent=parent_node,
                                   tokens=chunk)
                parent_node.children[chunk] = child
            if child.block_id is None:
                # a new node, or one whose block was evicted: this block
                # names it now
                child.block_id = block_id
                self._by_block[block_id] = child
            return child

    def insert_partial(self, tail_tokens, block_id, parent_node):
        with self._lock:
            key = tuple(int(t) for t in tail_tokens)
            if key not in parent_node.partials:
                parent_node.partials[key] = block_id
                self._by_block[block_id] = (parent_node, key)
                return True
            return False

    @property
    def root(self):
        return self._root

    def node_of(self, block_id, default=None):
        with self._lock:
            entry = self._by_block.get(block_id)
            return entry if isinstance(entry, _RadixNode) else default

    def remove(self, block_id):
        with self._lock:
            entry = self._by_block.pop(block_id, None)
            if entry is None:
                return
            if isinstance(entry, tuple):
                node, key = entry
                node.partials.pop(key, None)
                return
            node = entry
            node.block_id = None
            # prune leaf chains with no registered descendants
            while (node.parent is not None and not node.children
                   and not node.partials and node.block_id is None):
                parent = node.parent
                parent.children.pop(node.tokens, None)
                node = parent

    def __len__(self):
        with self._lock:
            return len(self._by_block)


class CowCopy:
    """What a copy-on-write owes the device: re-inject ``host_rows``
    (per-layer ``[(k, v)]`` covering ``size_used`` offsets) into
    ``block`` before any append lands there."""

    __slots__ = ("block", "host_rows", "size_used")

    def __init__(self, block, host_rows, size_used):
        self.block = block
        self.host_rows = host_rows
        self.size_used = size_used


class BlockPool:
    """Block-granular allocator over the flat row arena + the radix
    prefix index. All allocation calls happen on the entry's scheduler
    thread; ``stats()`` may be read from any thread (the lock makes the
    counters coherent)."""

    def __init__(self, num_blocks, block_size):
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._blocks = [Block(i, i * self.block_size)
                        for i in range(self.num_blocks)]
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._cached = OrderedDict()   # block id -> None (LRU of refcount-0)
        self._radix = _RadixTree()
        self._lock = lockdep.named_lock("decode.blocks")
        self._tier = None              # HostKVTier (attach_tier)
        self._tier_read = None         # block -> per-layer [(k, v)] rows
        self.cow_copies = 0
        self.evictions = 0
        self.radix_hits = 0            # shared-block references served
        self.forks = 0                 # beam forks served (refcount++ paths)
        self.tier_writebacks = 0       # evicted blocks spilled to host

    def attach_tier(self, tier, read_rows=None):
        """Adopt a host-RAM tier (tier.py): LRU eviction writes a
        registered full block's rows back to ``tier`` under
        ``blk:<chain>`` before recycling it. ``read_rows(block)`` reads
        the block's arena rows (the pool is host bookkeeping only — the
        engine owns the arena scope); called, like the ``tier.put``,
        while holding the allocator lock."""
        self._tier = tier
        self._tier_read = read_rows

    @property
    def rows(self):
        return self.num_blocks * self.block_size

    # -- allocation --------------------------------------------------------
    def _alloc_locked(self):
        if not self._free:
            # evict the LRU cached (refcount-0, registered) block
            if not self._cached:
                return None
            bid, _ = self._cached.popitem(last=False)
            self._writeback_locked(self._blocks[bid])
            self._radix.remove(bid)
            self._blocks[bid].reset()
            self._free.append(bid)
            self.evictions += 1
        bid = self._free.pop()
        b = self._blocks[bid]
        b.reset()
        b.refcount = 1
        return b

    def _writeback_locked(self, b):
        """Spill an about-to-be-evicted FULL registered block's rows to
        the host tier (registered blocks are immutable, so this is the
        one moment their bytes leave the arena). Partial tails already
        retain ``host_rows`` on the host and are cheap to recompute;
        only chain-hashed full blocks spill."""
        if self._tier is None or b.chain_hash is None:
            return
        rows = b.host_rows
        if rows is None and self._tier_read is not None:
            rows = self._tier_read(b)
        if rows is None:
            return
        if self._tier.put("blk:" + b.chain_hash, rows, b.size_used,
                          tokens=b.tokens):
            self.tier_writebacks += 1

    def available(self):
        """Blocks an allocation can take now: the free ones and the
        evictable (cached, refcount-0) ones."""
        with self._lock:
            return len(self._free) + len(self._cached)

    def acquire_rows(self, n_rows):
        """Fresh PRIVATE blocks covering ``n_rows`` positions with
        ``size_used`` preset (the preemption-resume path: the caller
        re-injects spilled rows, so these blocks hold real content the
        moment they are handed out). Returns None when the pool cannot
        cover the run."""
        bs = self.block_size
        n = (int(n_rows) + bs - 1) // bs
        with self._lock:
            if n > len(self._free) + len(self._cached):
                return None
            out = []
            for i in range(n):
                b = self._alloc_locked()
                b.size_used = min(bs, int(n_rows) - i * bs)
                out.append(b)
            return out

    def acquire_for_prompt(self, tokens):
        """Map a prompt onto blocks: longest shared full-block chain
        from the radix tree (+ a shared partial tail when one matches),
        fresh private blocks for the rest. Returns
        ``(blocks, shared_len)`` — ``shared_len`` positions already hold
        the right rows on device and must NOT be re-injected — or
        ``(None, 0)`` when the pool cannot cover the prompt."""
        toks = [int(t) for t in tokens]
        bs = self.block_size
        ids, node, tail_bid = self._radix.lookup_chain(toks, bs)
        with self._lock:
            shared = []
            for bid in ids:
                b = self._blocks[bid]
                shared.append(b)
            tail_block = None
            if tail_bid is not None:
                tail_block = self._blocks[tail_bid]
            shared_len = len(shared) * bs
            if tail_block is not None:
                shared_len += tail_block.size_used
            n_new = (len(toks) - shared_len + bs - 1) // bs
            sharing = shared + ([tail_block] if tail_block is not None
                                else [])
            # capacity check must not count cached blocks this very call
            # is about to re-reference as shared — they stop being
            # evictable the moment the commit refs them
            shared_ids = {b.id for b in sharing}
            evictable = sum(1 for bid in self._cached
                            if bid not in shared_ids)
            if n_new > (len(self._free) + evictable):
                return None, 0
            # commit: reference shared, allocate private
            for b in sharing:
                if b.refcount == 0:
                    self._cached.pop(b.id, None)
                b.refcount += 1
                self.radix_hits += 1
            blocks = list(sharing)
            for i in range(n_new):
                nb = self._alloc_locked()
                start = shared_len + i * bs
                nb.tokens = tuple(toks[start:start + bs])
                nb.size_used = min(bs, len(toks) - start)
                blocks.append(nb)
            return blocks, shared_len

    def register_prompt_blocks(self, blocks, tokens, host_rows=None):
        """Index this prompt's freshly written blocks in the radix tree
        so later prompts share them. Full blocks always register;
        the partial tail registers only when ``host_rows`` (a callable
        ``(start, stop) -> per-layer [(k, v)]``) can retain its bytes
        for copy-on-write."""
        toks = [int(t) for t in tokens]
        bs = self.block_size
        hashes = block_hashes(toks, bs)
        node = self._radix.root
        with self._lock:
            for i, b in enumerate(blocks):
                if (i + 1) * bs <= len(toks):
                    chunk = tuple(toks[i * bs:(i + 1) * bs])
                    if b.registered:
                        node = self._radix.node_of(b.id, node)
                        continue
                    b.chain_hash = hashes[i]
                    b.registered = True
                    node = self._radix.insert_full(chunk, hashes[i], b.id,
                                                   node)
                else:
                    tail = tuple(toks[i * bs:])
                    if not tail or b.registered or host_rows is None:
                        break
                    b.host_rows = host_rows(i * bs, len(toks))
                    if self._radix.insert_partial(tail, b.id, node):
                        b.registered = True
                        b.partial_of = node.chain_hash
                    break

    def ensure_appendable(self, blocks, cursor):
        """Make position ``cursor`` writable for ONE owner. Returns
        ``(blocks, new_block, cow)``:

        * cursor opens a new chunk -> allocate a fresh private block
          (``new_block`` set);
        * cursor lands in a SHARED partial tail (refcount > 1) ->
          copy-on-write: fresh block + a ``CowCopy`` the caller must
          re-inject before building row feeds;
        * cursor lands in an exclusively-owned registered partial ->
          unregister it (its content is about to stop matching its key)
          and append in place.

        Returns ``(None, None, None)`` when the pool is exhausted."""
        bs = self.block_size
        idx = cursor // bs
        if idx >= len(blocks):
            with self._lock:
                nb = self._alloc_locked()
            if nb is None:
                return None, None, None
            return blocks + [nb], nb, None
        b = blocks[idx]
        with self._lock:
            if b.refcount > 1:
                if b.host_rows is None:
                    raise RuntimeError(
                        f"shared block {b.id} has no host rows to COW")
                nb = self._alloc_locked()
                if nb is None:
                    return None, None, None
                nb.size_used = b.size_used
                nb.tokens = b.tokens
                cow = CowCopy(nb, b.host_rows, b.size_used)
                b.refcount -= 1
                self.cow_copies += 1
                out = list(blocks)
                out[idx] = nb
                return out, nb, cow
            if b.registered:
                self._radix.remove(b.id)
                b.registered = False
                b.partial_of = None
        return blocks, None, None

    def note_append(self, block):
        """One row landed in ``block`` (host bookkeeping only)."""
        with self._lock:
            block.size_used = min(block.size_used + 1, self.block_size)

    def fork_blocks(self, blocks, written):
        """Beam fork: a second owner for the first ``written`` positions
        of ``blocks``. Full covered blocks are SHARED (refcount++ — they
        are immutable history for both beams; appends can never land in
        them because the cursor is past their last offset), and a
        partial tail gets a fresh PRIVATE block the caller must fill by
        copying the parent's ``written % block_size`` arena rows on the
        device.

        Returns ``(child_blocks, new_tail, src_tail)`` — ``new_tail`` /
        ``src_tail`` are None when ``written`` is block-aligned — or
        ``(None, None, None)`` when the pool is exhausted."""
        bs = self.block_size
        full = int(written) // bs
        tail_used = int(written) % bs
        with self._lock:
            child = list(blocks[:full])
            nb = None
            src = None
            if tail_used:
                src = blocks[full]
                nb = self._alloc_locked()
                if nb is None:
                    return None, None, None
                nb.size_used = tail_used
                nb.tokens = src.tokens
            for b in child:
                b.refcount += 1
            self.forks += 1
            if nb is not None:
                child.append(nb)
            return child, nb, src

    def release(self, blocks):
        """Drop one owner's references. Registered refcount-0 blocks
        stay cached (LRU) for future prefix hits; private ones free."""
        with self._lock:
            for b in blocks:
                b.refcount -= 1
                if b.refcount > 0:
                    continue
                if b.registered:
                    self._cached[b.id] = None
                    self._cached.move_to_end(b.id)
                else:
                    b.reset()
                    self._free.append(b.id)

    def reset(self):
        """Arena wiped (relaunch path): every block returns to the free
        list and the radix index empties — the device rows are zeros."""
        with self._lock:
            for b in self._blocks:
                if b.registered:
                    self._radix.remove(b.id)
                b.reset()
            self._free = list(range(self.num_blocks - 1, -1, -1))
            self._cached.clear()

    def check_conservation(self):
        """The row-conservation invariant, assertable after any admission,
        retirement, beam fork or prune: each block is in EXACTLY ONE of {free list, LRU
        cache, live (refcount > 0)}, the three counts sum to the pool
        size, and no refcount is negative. Raises AssertionError naming
        the violation; returns the three counts when clean."""
        with self._lock:
            free = set(self._free)
            cached = set(self._cached)
            live = {b.id for b in self._blocks if b.refcount > 0}
            neg = [b.id for b in self._blocks if b.refcount < 0]
            assert not neg, f"negative refcount on blocks {neg}"
            assert not (free & cached), (
                f"blocks both free and cached: {sorted(free & cached)}")
            assert not (free & live), (
                f"blocks both free and live: {sorted(free & live)}")
            assert not (cached & live), (
                f"blocks both cached and live: {sorted(cached & live)}")
            total = len(free) + len(cached) + len(live)
            assert total == self.num_blocks, (
                f"row conservation broken: {len(free)} free + "
                f"{len(cached)} cached + {len(live)} live != "
                f"{self.num_blocks} total")
            return {"blocks_free": len(free), "blocks_cached": len(cached),
                    "blocks_live": len(live)}

    # -- observability -----------------------------------------------------
    def stats(self):
        with self._lock:
            live = [b for b in self._blocks if b.refcount > 0]
            physical = sum(b.size_used for b in live)
            logical = sum(b.refcount * b.size_used for b in live)
            cached_rows = sum(self._blocks[bid].size_used
                              for bid in self._cached)
            return {
                "block_size": self.block_size,
                "blocks_total": self.num_blocks,
                "blocks_free": len(self._free),
                "blocks_cached": len(self._cached),
                "blocks_live": len(live),
                "rows_total": self.rows,
                "rows_live": physical,
                "rows_cached": cached_rows,
                "rows_logical": logical,
                "occupancy": physical / float(max(self.rows, 1)),
                "dedup_ratio": logical / float(max(physical, 1)),
                "cow_copies": self.cow_copies,
                "forks": self.forks,
                "evictions": self.evictions,
                "radix_hits": self.radix_hits,
                "radix_entries": len(self._radix),
                "tier_writebacks": self.tier_writebacks,
            }
