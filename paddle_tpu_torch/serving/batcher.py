"""Bucket lattice + dynamic batcher: padded batches on a fixed shape grid,
the port's copy of the JAX package's ``serving/batcher.py``.

Each distinct input shape costs the predictor a prepared bucket (its plan
and a first run that builds the kernels and warms cuBLAS and the
allocator), so a batcher that formed arbitrary (rows, len) shapes would
turn traffic diversity into first runs on the request path.
`BucketLattice` fixes the admissible grid up front — a batch-size ladder
times an optional padded-axis (sequence-length) ladder — and
`DynamicBatcher` only ever emits batches whose shapes sit exactly on that
grid: requests are stacked along axis 0 and right-padded along the padded
axis, dummy rows fill the batch bucket and are sliced back out of the
outputs. Warm the lattice once (`Predictor.warmup`) and the bucket-cache
hit rate stays 100%.

Scheduling is Clipper-style: wait for the bucket to fill, but never past
`max_wait_s` from the head request's admission, and never past a
gathered request's deadline — latency SLOs bound batching gain, not the
other way round.
"""

import time

import numpy as np

from paddle_tpu_torch.serving.request import RejectedError

__all__ = ["BucketLattice", "DynamicBatcher", "BatchPlan"]


class BucketLattice:
    """The fixed (batch, padded-axis-length) shape grid.

    `batch_sizes` is the row ladder; `seq_lens` (optional) the padded-axis
    ladder — when None the batcher never pads trailing dims, so only
    requests with identical trailing shapes share a batch. `pad_axis` is
    the axis that gets length-padded on every input that has it (inputs
    of rank <= pad_axis are stacked only). Bucket mapping is
    deterministic and total over admissible shapes: smallest ladder entry
    >= the observed value.
    """

    def __init__(self, batch_sizes=(1, 2, 4, 8), seq_lens=None, pad_axis=1,
                 pad_value=0):
        batch_sizes = sorted(int(b) for b in batch_sizes)
        if not batch_sizes or batch_sizes[0] < 1:
            raise ValueError(f"bad batch ladder {batch_sizes}")
        self.batch_sizes = tuple(batch_sizes)
        self.seq_lens = tuple(sorted(int(s) for s in seq_lens)) if seq_lens \
            else None
        if self.seq_lens and self.seq_lens[0] < 1:
            raise ValueError(f"bad seq ladder {self.seq_lens}")
        self.pad_axis = int(pad_axis)
        self.pad_value = pad_value

    @staticmethod
    def pow2(max_batch, max_seq=None, min_seq=8, pad_axis=1):
        """Power-of-two ladders up to the given maxima — the JAX C ABI's
        scalar (max_batch, max_seq) spelling of a lattice."""
        batches = [1]
        while batches[-1] * 2 <= int(max_batch):
            batches.append(batches[-1] * 2)
        seqs = None
        if max_seq:
            seqs = [int(min_seq)]
            while seqs[-1] * 2 <= int(max_seq):
                seqs.append(seqs[-1] * 2)
        return BucketLattice(batches, seqs, pad_axis=pad_axis)

    @property
    def max_rows(self):
        return self.batch_sizes[-1]

    @property
    def max_len(self):
        return self.seq_lens[-1] if self.seq_lens else None

    def bucket_rows(self, rows):
        """Smallest batch bucket >= rows (total over 1..max_rows)."""
        for b in self.batch_sizes:
            if b >= rows:
                return b
        raise RejectedError(
            f"request rows {rows} exceed the largest batch bucket "
            f"{self.max_rows}; split the request or widen the lattice"
        )

    def bucket_len(self, length):
        """Smallest length bucket >= length (total over 1..max_len)."""
        if self.seq_lens is None:
            return 0
        for s in self.seq_lens:
            if s >= length:
                return s
        raise RejectedError(
            f"padded-axis length {length} exceeds the largest bucket "
            f"{self.max_len}; truncate the request or widen the lattice"
        )

    def classify(self, inputs, var_feeds=None):
        """Admission-time shape analysis: returns (rows, var_len,
        group_key) or raises RejectedError for inadmissible shapes.
        group_key captures everything batchmates must agree on — feed
        names, dtypes, and trailing dims with the padded axis masked.

        `var_feeds` (optional) names the inputs whose pad_axis dim is
        genuinely variable (declared -1 in the program); inputs outside
        it keep their trailing dims fixed — a declared-fixed dim must
        never be padded to a length bucket (the resulting shape was
        never warmed AND the program would reject it). Without the set,
        every input of sufficient rank is treated as variable."""
        rows = None
        var_len = 0
        key = []
        for name in sorted(inputs):
            arr = inputs[name]
            if arr.ndim < 1:
                raise RejectedError(f"input '{name}' is rank-0; requests "
                                    "need a leading batch axis")
            if rows is None:
                rows = int(arr.shape[0])
            elif int(arr.shape[0]) != rows:
                raise RejectedError(
                    f"input '{name}' has {arr.shape[0]} rows; other inputs "
                    f"have {rows} — all inputs share the batch axis"
                )
            tail = list(arr.shape[1:])
            if (self.seq_lens is not None and arr.ndim > self.pad_axis
                    and (var_feeds is None or name in var_feeds)):
                var_len = max(var_len, int(arr.shape[self.pad_axis]))
                tail[self.pad_axis - 1] = None  # masked: padded away
            key.append((name, str(arr.dtype), tuple(tail)))
        if rows is None:
            raise RejectedError("request has no inputs")
        if rows < 1:
            raise RejectedError("request has zero rows")
        self.bucket_rows(rows)  # raises when inadmissible
        if var_len:
            self.bucket_len(var_len)
        return rows, var_len, tuple(key)


class BatchPlan:
    """One dispatchable padded batch: which requests, at which lattice
    point, and where each request's rows sit."""

    __slots__ = ("requests", "bucket_rows", "bucket_len", "offsets")

    def __init__(self, requests, bucket_rows, bucket_len):
        self.requests = requests
        self.bucket_rows = bucket_rows
        self.bucket_len = bucket_len
        self.offsets = []
        off = 0
        for r in requests:
            self.offsets.append(off)
            off += r.rows

    @property
    def real_rows(self):
        return sum(r.rows for r in self.requests)

    @property
    def occupancy(self):
        return self.real_rows / float(self.bucket_rows)


class DynamicBatcher:
    """Coalesce queued requests into lattice batches under a max-wait
    timer. Callers hold `queue.lock` across plan() (it scans and then
    removes — the engine's dispatch Condition is built on that lock).

    `feed_specs` / `fetch_specs` ({name: declared shape list or None},
    every feed and fetch of the served program) make padding and scatter
    exact: only a feed whose pad_axis dim is declared -1 is
    length-padded, only a fetch whose leading dim is declared -1 is
    row-sliced back out. A shape of None is undeclared and taken as
    variable."""

    def __init__(self, lattice, feed_specs, fetch_specs, max_wait_s=0.005):
        self.lattice = lattice
        self.max_wait_s = float(max_wait_s)
        self.fetch_specs = fetch_specs
        self.var_feeds = {
            n for n, shape in feed_specs.items()
            if shape is None or (len(shape) > lattice.pad_axis
                                 and int(shape[lattice.pad_axis]) == -1)
        }

    def _pads_feed(self, name, proto):
        return proto.ndim > self.lattice.pad_axis and name in self.var_feeds

    def _batched_fetch(self, name, out, plan):
        """Is this output batch-aligned (axis 0 = bucket rows)?"""
        if out.ndim < 1 or out.shape[0] != plan.bucket_rows:
            return False
        shape = self.fetch_specs[name]
        return shape is None or (len(shape) >= 1 and int(shape[0]) == -1)

    def _var_fetch(self, name):
        """May this output's pad_axis be length-sliced per request?"""
        shape = self.fetch_specs[name]
        return shape is None or (len(shape) > self.lattice.pad_axis
                                 and int(shape[self.lattice.pad_axis]) == -1)

    # -- planning ----------------------------------------------------------
    def plan(self, queue, now=None, force=False):
        """Form the next batch, or None when waiting longer is the better
        schedule. Deterministic given queue contents + clock: take the
        head (oldest, highest lane), gather group-compatible requests
        whose padded length fits the head's length bucket, dispatch when
        the batch bucket is full, the head aged past max_wait, or a
        gathered deadline is imminent."""
        now = now if now is not None else time.perf_counter()
        head = queue.head()
        if head is None:
            return None
        target_len = (self.lattice.bucket_len(head.var_len)
                      if head.var_len else 0)
        gathered, rows = [], 0
        for r in queue.iter_requests():
            if r.group_key != head.group_key:
                continue
            if target_len and r.var_len > target_len:
                continue  # longer sequences wait for their own bucket
            if rows + r.rows > self.lattice.max_rows:
                continue  # would overflow the largest bucket; next batch
            gathered.append(r)
            rows += r.rows
        full = rows >= self.lattice.max_rows
        aged = (now - head.submit_time) >= self.max_wait_s
        urgent = any(
            r.deadline is not None and (r.deadline - now) <= self.max_wait_s
            for r in gathered
        )
        if not (force or full or aged or urgent):
            return None
        queue.remove(gathered)
        for r in gathered:
            r.dispatch_time = now
        return BatchPlan(gathered, self.lattice.bucket_rows(rows), target_len)

    def wait_hint(self, queue, now=None):
        """Seconds the worker may sleep before the head batch must
        dispatch (max-wait expiry or earliest queued deadline)."""
        now = now if now is not None else time.perf_counter()
        head = queue.head()
        if head is None:
            return self.max_wait_s
        hint = max(0.0, self.max_wait_s - (now - head.submit_time))
        for r in queue.iter_requests():
            if r.deadline is not None:
                hint = min(hint, max(0.0, r.deadline - now))
        return hint

    # -- padding / scatter -------------------------------------------------
    def assemble(self, plan):
        """Build the padded feed dict for one plan. Per-request assembly
        failures raise RequestError-compatible exceptions upward; the
        engine isolates them (a bad request must not fail batchmates)."""
        first = plan.requests[0].inputs
        feeds = {}
        for name, proto in first.items():
            shape = list(proto.shape)
            shape[0] = plan.bucket_rows
            if plan.bucket_len and self._pads_feed(name, proto):
                shape[self.lattice.pad_axis] = plan.bucket_len
            out = np.full(shape, self.lattice.pad_value, dtype=proto.dtype)
            for r, off in zip(plan.requests, plan.offsets):
                a = r.inputs[name]
                idx = (slice(off, off + r.rows),) + tuple(
                    slice(0, d) for d in a.shape[1:]
                )
                out[idx] = a
            feeds[name] = out
        return feeds

    def scatter(self, plan, outputs, request=None):
        """Split padded batch outputs back into per-request dicts.

        Batch-aligned outputs (axis 0 == bucket rows) are row-sliced, and
        a padded axis matching the length bucket is cut back to each
        request's real length; outputs without a batch axis (e.g. a
        scalar score) are replicated to every request as-is."""
        reqs = ([request] if request is not None else plan.requests)
        offs = ([0] if request is not None else plan.offsets)
        results = []
        for r, off in zip(reqs, offs):
            per = {}
            for name, out in outputs.items():
                o = out
                if self._batched_fetch(name, o, plan):
                    o = o[off:off + r.rows]
                    if (plan.bucket_len and r.var_len
                            and o.ndim > self.lattice.pad_axis
                            and o.shape[self.lattice.pad_axis]
                            == plan.bucket_len
                            and self._var_fetch(name)):
                        idx = ((slice(None),) * self.lattice.pad_axis
                               + (slice(0, r.var_len),))
                        o = o[idx]
                per[name] = np.asarray(o)
            results.append(per)
        return results
