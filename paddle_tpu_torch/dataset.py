"""Datasets: high-throughput file-based training input.

Reference: python/paddle/fluid/dataset.py — DatasetFactory :22,
InMemoryDataset :292 (load_into_memory + local/global shuffle),
QueueDataset :672 (streaming); backed by the C++ data-feed layer
(reference: paddle/fluid/framework/data_feed.cc MultiSlotDataFeed,
data_set.cc DatasetImpl). The port's copy of the JAX package's
``dataset.py``: the native backend is the port's own copy of the JAX
package's ``csrc/datafeed/datafeed.cc`` (``native/csrc/datafeed.cc``,
built by ``native.load_native``) — threaded MultiSlot parsing, shuffle,
and padded batch assembly in C++ — bound via ctypes, with the same
pure-Python fallback (``_PyFeed``) when the build fails; ``native_feed``
says which one a dataset runs. Variable-length slots come back as padded
[B, maxlen] arrays plus a `<name>.lens` int64 vector (padding + lengths
instead of LoD). The feed and truncation locks are the lockdep classes
``dataio.dataset.feed`` and ``dataio.dataset.truncate``, as there.
"""

import ctypes
import os

import numpy as np

from paddle_tpu_torch.native import NativeBuildError, load_native
from paddle_tpu_torch.observability import lockdep
from paddle_tpu_torch.utils.enforce import enforce

__all__ = ["DatasetFactory", "InMemoryDataset", "QueueDataset"]


def _fleet_rank_world(fleet):
    if fleet is not None:
        try:
            return fleet.worker_index(), fleet.worker_num()
        except Exception:
            pass
    return (
        int(os.environ.get("PADDLE_TRAINER_ID", "0")),
        int(os.environ.get("PADDLE_TRAINERS_NUM", "1")),
    )


class DatasetFactory:
    """reference: dataset.py:22."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError(f"unknown dataset class {datafeed_class}")


class _SlotSpec:
    def __init__(self, name, dtype, length):
        self.name = name
        self.dtype = dtype  # "float32" | "int64"
        self.length = length  # >0 fixed, -1 variable


class _PyFeed:
    """Pure-Python fallback backend mirroring the native C ABI semantics."""

    def __init__(self, slots):
        self.slots = slots
        self.records = []
        self.order = None
        self._cursor = 0
        self._batch = []

    def load_buffer(self, text):
        for line in text.splitlines():
            if not line.strip():
                continue
            toks = line.split()
            pos = 0
            rec = []
            for s in self.slots:
                cnt = int(toks[pos]); pos += 1
                vals = toks[pos:pos + cnt]; pos += cnt
                conv = float if s.dtype == "float32" else int
                rec.append([conv(v) for v in vals])
            self.records.append(rec)

    def load_files(self, paths, nthreads):
        for p in paths:
            with open(p) as f:
                self.load_buffer(f.read())

    def size(self):
        return len(self.records)

    def shuffle(self, seed):
        # compose onto the existing permutation (matches the native backend:
        # repeated per-epoch shuffles keep mixing rather than resetting)
        rng = np.random.RandomState(seed)
        if self.order is None or len(self.order) != len(self.records):
            self.order = np.arange(len(self.records))
        rng.shuffle(self.order)

    def begin_pass(self, batch_size, drop_last):
        if self.order is None or len(self.order) != len(self.records):
            self.order = np.arange(len(self.records))
        self._cursor = 0
        self._bs = batch_size
        self._drop = drop_last

    def next_batch(self):
        rem = len(self.records) - self._cursor
        take = min(self._bs, rem)
        if take == 0 or (self._drop and take < self._bs):
            return 0
        self._batch = self.order[self._cursor:self._cursor + take]
        self._cursor += take
        return take

    def batch_arrays(self, slot_idx):
        s = self.slots[slot_idx]
        rows = [self.records[r][slot_idx] for r in self._batch]
        lens = np.array([len(r) for r in rows], dtype=np.int64)
        maxlen = s.length if s.length > 0 else max((len(r) for r in rows), default=0)
        dt = np.float32 if s.dtype == "float32" else np.int64
        out = np.zeros((len(rows), max(maxlen, 1)), dtype=dt)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r[:maxlen] if maxlen else r
        return out, lens


class _NativeFeed:
    """ctypes binding over the native data feed (threaded C++
    parse/shuffle/batch)."""

    def __init__(self, slots):
        self.slots = slots
        self.lib = load_native("datafeed")
        lib = self.lib
        lib.paddle_ds_create.restype = ctypes.c_void_p
        lib.paddle_ds_create.argtypes = [ctypes.c_char_p]
        lib.paddle_ds_error.restype = ctypes.c_char_p
        lib.paddle_ds_error.argtypes = [ctypes.c_void_p]
        lib.paddle_ds_load_files.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int,
        ]
        lib.paddle_ds_load_buffer.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
        ]
        lib.paddle_ds_size.restype = ctypes.c_long
        lib.paddle_ds_size.argtypes = [ctypes.c_void_p]
        lib.paddle_ds_shuffle.argtypes = [ctypes.c_void_p, ctypes.c_uint]
        lib.paddle_ds_begin_pass.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.paddle_ds_next_batch.restype = ctypes.c_int
        lib.paddle_ds_next_batch.argtypes = [ctypes.c_void_p]
        lib.paddle_ds_batch_maxlen.restype = ctypes.c_int
        lib.paddle_ds_batch_maxlen.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.paddle_ds_batch_copy.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]
        lib.paddle_ds_destroy.argtypes = [ctypes.c_void_p]
        spec = ",".join(
            f"{s.name}:{'f' if s.dtype == 'float32' else 'i'}:{s.length}"
            for s in slots
        )
        self.h = lib.paddle_ds_create(spec.encode())
        enforce(self.h, f"bad slot spec {spec}")
        self._cur_bs = 0

    def _check(self, rc):
        if rc != 0:
            raise RuntimeError(self.lib.paddle_ds_error(self.h).decode())

    def load_buffer(self, text):
        data = text.encode()
        self._check(self.lib.paddle_ds_load_buffer(self.h, data, len(data)))

    def load_files(self, paths, nthreads):
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._check(
            self.lib.paddle_ds_load_files(self.h, arr, len(paths), nthreads)
        )

    def size(self):
        return self.lib.paddle_ds_size(self.h)

    def shuffle(self, seed):
        self.lib.paddle_ds_shuffle(self.h, seed & 0xFFFFFFFF)

    def begin_pass(self, batch_size, drop_last):
        self.lib.paddle_ds_begin_pass(self.h, batch_size, int(drop_last))

    def next_batch(self):
        self._cur_bs = self.lib.paddle_ds_next_batch(self.h)
        return self._cur_bs

    def batch_arrays(self, slot_idx):
        s = self.slots[slot_idx]
        maxlen = (
            s.length
            if s.length > 0
            else max(self.lib.paddle_ds_batch_maxlen(self.h, slot_idx), 1)
        )
        dt = np.float32 if s.dtype == "float32" else np.int64
        out = np.zeros((self._cur_bs, maxlen), dtype=dt)
        lens = np.zeros(self._cur_bs, dtype=np.int64)
        self.lib.paddle_ds_batch_copy(
            self.h, slot_idx,
            out.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            maxlen,
        )
        return out, lens

    def __del__(self):
        try:
            self.lib.paddle_ds_destroy(self.h)
        except Exception:
            pass


class DatasetBase:
    def __init__(self):
        self._batch_size = 1
        self._thread_num = 1
        self._num_workers = 0
        self._filelist = []
        self._slots = []
        self._feed = None
        self._use_native = True
        self._drop_last = False
        self._emit_lengths = False
        self._loaded = False
        self._pad_to = {}
        self._truncated_rows = {}
        self._warned_truncate = set()
        self._truncate_lock = lockdep.named_lock("dataio.dataset.truncate")
        # the feed backend is a stateful cursor; passes may be driven
        # from pipeline threads (num_workers / DevicePrefetcher), so
        # access is lock-serialized and generation-stamped: starting a
        # new pass invalidates any still-running producer of the old one
        self._feed_lock = lockdep.named_lock("dataio.dataset.feed")
        self._pass_gen = 0

    @property
    def native_feed(self):
        """Whether the loaded data sits in the native feed (False: the
        Python fallback, or nothing loaded yet)."""
        return isinstance(self._feed, _NativeFeed)

    def truncated_row_counts(self):
        """Per-slot count of rows whose tokens were dropped by pad_to
        truncation (visible data loss, never silent)."""
        return dict(self._truncated_rows)

    # -- configuration (reference: dataset.py DatasetBase) -----------------
    def set_batch_size(self, batch_size):
        self._batch_size = batch_size

    def set_thread(self, thread_num):
        self._thread_num = thread_num

    def set_num_workers(self, num_workers):
        """Pad/assemble batches on the dataio ordered worker pool
        (reference: data_feed.cc's parse threads). Batch ORDER is
        unchanged — round-robin reassembly makes output order independent
        of worker timing — only the numpy padding/bucketing work runs
        concurrently with the training step."""
        self._num_workers = int(num_workers)

    def set_filelist(self, filelist):
        self._filelist = list(filelist)
        self._loaded = False

    def set_use_var(self, var_list):
        """Declare the feed vars, in slot order. Variable-length slots are
        vars whose non-batch shape is unknown (any -1 beyond dim 0)."""
        self._slots = []
        for v in var_list:
            dtype = "int64" if "int" in str(v.dtype) else "float32"
            trailing = list(v.shape[1:]) if v.shape else []
            if trailing and all(isinstance(d, int) and d > 0 for d in trailing):
                length = int(np.prod(trailing))
            else:
                length = -1
            self._slots.append(_SlotSpec(v.name, dtype, length))

    def set_emit_lengths(self, emit=True):
        """Also yield `<name>.lens` int64 arrays for variable-length slots."""
        self._emit_lengths = emit

    def set_pad_to(self, pad_lengths):
        """Fixed pad length per variable-length slot: {slot_name: L}. Without
        this, var-len slots pad to the next power of two above the batch max
        (shape bucketing), as in the JAX package, so both packages see the
        same batch shapes."""
        self._pad_to.update(pad_lengths)

    def _make_feed(self):
        if self._feed is not None:
            return self._feed
        enforce(self._slots, "call set_use_var before loading data")
        if self._use_native:
            try:
                self._feed = _NativeFeed(self._slots)
            except NativeBuildError:
                self._feed = _PyFeed(self._slots)
        else:
            self._feed = _PyFeed(self._slots)
        return self._feed

    def _load(self):
        feed = self._make_feed()
        if self._filelist and not self._loaded:
            feed.load_files(self._filelist, self._thread_num)
            self._loaded = True

    # -- iteration ---------------------------------------------------------
    def _assemble_batch(self, raw):
        """Pad/bucket one raw batch ([(arr, lens)] per slot) into the feed
        dict. Pure numpy — safe on the worker pool; the truncation
        bookkeeping is the only shared state and sits under a lock."""
        out = {}
        for s, (arr, lens) in zip(self._slots, raw):
            if s.length < 0:
                want = self._pad_to.get(s.name)
                if want is None:
                    # bucket to next pow2 so step shapes stabilize
                    want = 1 << max(int(np.ceil(np.log2(arr.shape[1]))), 0)
                if arr.shape[1] < want:
                    arr = np.pad(arr, [(0, 0), (0, want - arr.shape[1])])
                elif arr.shape[1] > want:
                    # truncation drops real tokens — make the data loss
                    # visible (once per slot) instead of silent
                    with self._truncate_lock:
                        self._truncated_rows[s.name] = self._truncated_rows.get(
                            s.name, 0
                        ) + int(np.sum(lens > want))
                        first = s.name not in self._warned_truncate
                        self._warned_truncate.add(s.name)
                    if first:
                        import warnings

                        warnings.warn(
                            f"slot '{s.name}': batch length {arr.shape[1]} "
                            f"exceeds pad_to={want}; truncating (tokens are "
                            "dropped — raise pad_to to keep them). "
                            "Truncated-row counts accumulate in "
                            "dataset.truncated_row_counts()."
                        )
                    arr = arr[:, :want]
            out[s.name] = arr
            if self._emit_lengths and s.length < 0:
                out[s.name + ".lens"] = np.minimum(lens, arr.shape[1])
        return out

    def _iter_batches(self, drop_last=None):
        self._load()
        feed = self._feed
        drop = self._drop_last if drop_last is None else drop_last
        with self._feed_lock:
            self._pass_gen += 1
            gen = self._pass_gen
            feed.begin_pass(self._batch_size, drop)

        def raw_batches():
            # the backend cursor is stateful, so raw extraction stays
            # serial (one atomic next_batch+copy per lock hold); the
            # numpy pad/assemble work is what parallelizes. A producer
            # thread left over from an ABANDONED pass sees the bumped
            # generation and stops instead of corrupting the new cursor.
            while True:
                with self._feed_lock:
                    if gen != self._pass_gen:
                        return  # superseded by a newer pass
                    if feed.next_batch() <= 0:
                        return
                    raw = [feed.batch_arrays(i)
                           for i in range(len(self._slots))]
                yield raw

        from paddle_tpu_torch.dataio.engine import parallel_map_ordered

        # num_workers=0 runs the pool's synchronous path — identical
        # ordering/error contract and the same spans/metrics
        yield from parallel_map_ordered(
            raw_batches(), self._assemble_batch, self._num_workers,
            name="dataset",
        )

    def get_memory_data_size(self):
        return self._feed.size() if self._feed else 0


class InMemoryDataset(DatasetBase):
    """reference: dataset.py:292."""

    def load_into_memory(self):
        self._load()

    def local_shuffle(self, seed=0):
        enforce(self._feed is not None, "load_into_memory first")
        self._feed.shuffle(seed)

    def global_shuffle(self, fleet=None, thread_num=12, seed=0,
                       exchange_dir=None, timeout=300):
        """Cross-worker record exchange + local shuffle.

        The reference moves records between workers over PS RPC
        (reference: paddle/fluid/framework/data_set.cc GlobalShuffle); the
        TPU build's exchange plane is the shared filesystem the fleet
        already requires for checkpoints (the reference's own Gloo
        rendezvous ran over HDFS paths): each worker hash-partitions its
        raw records into per-destination files under `exchange_dir`,
        barriers on done-markers, re-reads the partitions addressed to it,
        then local-shuffles. Single worker (or no exchange_dir in a
        single-process job) degrades to local_shuffle.
        """
        rank, world = _fleet_rank_world(fleet)
        if world <= 1:
            self.local_shuffle(seed)
            return
        enforce(
            exchange_dir is not None,
            "global_shuffle across workers needs exchange_dir= on a "
            "shared filesystem",
        )
        import glob as _glob
        import hashlib
        import time as _time

        # per-call epoch namespace: reusing one exchange_dir across epochs
        # must not see the previous epoch's done-markers (instant barrier
        # pass over half-written files) or clobber part files that ARE the
        # current filelist
        self._shuffle_epoch = getattr(self, "_shuffle_epoch", -1) + 1
        exchange_dir = os.path.join(
            exchange_dir, f"epoch_{self._shuffle_epoch}"
        )
        os.makedirs(exchange_dir, exist_ok=True)
        outs = [
            open(os.path.join(exchange_dir, f"part_src{rank}_dst{d}.txt"),
                 "w")
            for d in range(world)
        ]
        n_records = 0
        for path in self._filelist:
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    h = hashlib.md5(
                        (str(seed) + line).encode()
                    ).digest()
                    outs[int.from_bytes(h[:4], "little") % world].write(line)
                    n_records += 1
        for o in outs:
            o.close()
        with open(os.path.join(exchange_dir, f"done_{rank}"), "w") as f:
            f.write(str(n_records))
        deadline = _time.monotonic() + timeout
        while True:
            done = _glob.glob(os.path.join(exchange_dir, "done_*"))
            if len(done) >= world:
                break
            enforce(
                _time.monotonic() < deadline,
                f"global_shuffle barrier timed out: {len(done)}/{world} "
                "workers finished partitioning",
            )
            _time.sleep(0.1)
        mine = sorted(
            _glob.glob(os.path.join(exchange_dir, f"part_src*_dst{rank}.txt"))
        )
        self.set_filelist(mine)
        self._feed = None
        self._loaded = False
        self._load()
        self.local_shuffle(seed + rank)

    def release_memory(self):
        self._feed = None
        self._loaded = False


class QueueDataset(DatasetBase):
    """Streaming flavor (reference: dataset.py:672). Batches stream out of
    the native store pass-by-pass without shuffling."""

    def local_shuffle(self, seed=0):
        raise RuntimeError("QueueDataset does not support shuffle")

    def global_shuffle(self, fleet=None, thread_num=12, seed=0):
        raise RuntimeError("QueueDataset does not support shuffle")
