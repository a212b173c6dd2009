"""Order-deterministic multi-worker input pipeline.

Reference: paddle/fluid/framework/data_feed.cc runs N parse threads into
per-thread channels, so the batch stream a trainer sees depends on which
thread won each race — two runs of the same job train on different
sample orders. The TPU build keeps the worker pool but makes ordering a
structural property: samples are dispatched round-robin to per-worker
bounded queues, each worker's output queue preserves its own dispatch
order, and the reassembler pops the output queues in the same
round-robin — so the emitted order equals the dispatch order no matter
how long any individual transform takes. Determinism costs head-of-line
blocking on the slowest in-flight sample, which the bounded queues turn
into backpressure rather than unbounded memory.

Workers are THREADS: the transforms this framework cares about (numpy
decode/augment, `DataFeeder.feed` batch assembly, padding) release the
GIL inside BLAS/ufunc loops, so a thread pool scales on CPU-bound
preprocessing without the pickling and fork-safety taxes of process
pools.

`DataEngine` composes the pool with a deterministic `ShardedSource`
(source.py) and checkpointable position (state.py): epoch order is a
pure function of (seed, epoch), the cursor only advances when a batch is
EMITTED, and augmentation RNGs are derived per-sample from
(seed, epoch, global index) — so a resumed, re-sharded, or re-timed run
reproduces the exact stream.

The port's copy of the JAX package's ``dataio/engine.py``: the same
streams for every worker count, the same queue gauges and wait
histograms on the port's registry, and the fault site ``dataio.read``
on the port's injector (``resilience/faults.py``). The JAX package also
wraps each transform and epoch in a ``dataio::`` span; the port has no
tracer yet (ROADMAP M12), so those spans wait for it.
"""

import inspect
import itertools
import logging
import queue
import random
import threading
import time

from paddle_tpu_torch.dataio.source import ShardedSource, mix_seed
from paddle_tpu_torch.dataio.state import IteratorState, elastic_resume
from paddle_tpu_torch.observability import registry
from paddle_tpu_torch.observability.logger import RateLimitedLogger
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.utils.enforce import enforce

__all__ = ["DataEngine", "parallel_map_ordered"]

log = logging.getLogger("paddle_tpu_torch.dataio")

# queue message kinds (seq, kind, value)
_OK = "ok"
_ERR = "err"
_END = "end"


class _PreErr:
    """A payload whose production already failed (e.g. a source read):
    workers forward it as an error marker without calling the transform,
    so the failure occupies its sequence slot and ordering holds."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


def _abortable_put(q, item, stop):
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _pool(iterable, fn, num_workers, queue_depth, name):
    """Yield (seq, kind, value) in strict input order from a round-robin
    worker pool. kind is "ok" (value = fn(payload)) or "err" (value = the
    exception fn or the iterable's producer raised for that slot).
    Exceptions raised by the ITERABLE itself (not tied to one slot)
    propagate after every completed slot."""
    reg = registry()
    labels = {"pipeline": name}
    in_depth = reg.gauge(
        "dataio_queue_depth", "items buffered in pipeline queues",
        labels={**labels, "queue": "in"},
    )
    out_depth = reg.gauge(
        "dataio_queue_depth", "items buffered in pipeline queues",
        labels={**labels, "queue": "out"},
    )
    producer_wait = reg.histogram(
        "dataio_producer_wait_seconds",
        "time workers spent blocked on a full output queue",
        labels=labels,
    )
    consumer_wait = reg.histogram(
        "dataio_consumer_wait_seconds",
        "time the consumer spent blocked waiting for the next result",
        labels=labels,
    )

    if num_workers <= 0:
        # synchronous path: same contract, no threads. fn runs OUTSIDE
        # the yield so consumer close (GeneratorExit) is never mistaken
        # for a record failure.
        for seq, payload in enumerate(iterable):
            if isinstance(payload, _PreErr):
                yield seq, _ERR, payload.exc
                continue
            try:
                res = fn(payload)
            except Exception as e:
                yield seq, _ERR, e
                continue
            yield seq, _OK, res
        return

    w_n = int(num_workers)
    in_qs = [queue.Queue(maxsize=queue_depth) for _ in range(w_n)]
    out_qs = [queue.Queue(maxsize=queue_depth) for _ in range(w_n)]
    stop = threading.Event()
    feed_err = []

    def dispatch():
        try:
            for seq, payload in enumerate(iterable):
                if not _abortable_put(in_qs[seq % w_n],
                                      (seq, payload), stop):
                    return
        except BaseException as e:  # producer failure: surfaces at the end
            feed_err.append(e)
        finally:
            for q_ in in_qs:
                _abortable_put(q_, _END, stop)

    def work(w):
        while True:
            try:
                msg = in_qs[w].get(timeout=0.1)
            except queue.Empty:
                if stop.is_set():
                    return
                continue
            if msg is _END:
                _abortable_put(out_qs[w], _END, stop)
                return
            seq, payload = msg
            if isinstance(payload, _PreErr):
                out = (seq, _ERR, payload.exc)
            else:
                # BaseException is caught so a dying transform can never
                # strand the consumer (the marker must flow), but skip
                # logic downstream only ever skips Exception subclasses
                # — SystemExit/KeyboardInterrupt always re-raise, same
                # as the synchronous path
                try:
                    out = (seq, _OK, fn(payload))
                except BaseException as e:
                    out = (seq, _ERR, e)
            t0 = time.perf_counter()
            if not _abortable_put(out_qs[w], out, stop):
                return
            producer_wait.observe(time.perf_counter() - t0)

    threads = [threading.Thread(target=dispatch, daemon=True,
                                name=f"{name}-dispatch")]
    threads += [
        threading.Thread(target=work, args=(w,), daemon=True,
                         name=f"{name}-worker{w}")
        for w in range(w_n)
    ]
    for t in threads:
        t.start()
    try:
        for seq in itertools.count():
            q_ = out_qs[seq % w_n]
            t0 = time.perf_counter()
            msg = q_.get()
            consumer_wait.observe(time.perf_counter() - t0)
            in_depth.set(sum(x.qsize() for x in in_qs))
            out_depth.set(sum(x.qsize() for x in out_qs))
            if msg is _END:
                break
            got_seq, kind, value = msg
            # structural invariant of round-robin reassembly; a violation
            # means a queue was shared or a worker died mid-slot
            enforce(got_seq == seq,
                    f"dataio pool order broke: got seq {got_seq}, "
                    f"expected {seq}")
            yield got_seq, kind, value
        if feed_err:
            raise feed_err[0]
    finally:
        stop.set()


def parallel_map_ordered(iterable, fn, num_workers, queue_depth=8,
                         name="dataio"):
    """Map `fn` over `iterable` with a deterministic worker pool; yields
    results in input order; the first error (from fn or the producer)
    raises at its input position. The building block DataLoader and
    Dataset ride; DataEngine uses the marker-level pool directly so it
    can convert errors into bounded skips."""
    for _seq, kind, value in _pool(iterable, fn, num_workers, queue_depth,
                                   name):
        if kind == _ERR:
            raise value
        yield value


class DataEngine:
    """Deterministic multi-worker pipeline over a ShardedSource.

        source = ListSource(samples, seed=7)
        engine = DataEngine(source, transform=decode, batch_size=32,
                            num_workers=4)
        for epoch in range(epochs):
            for batch in engine:          # iter == one epoch; resumable
                train_step(batch)
                ckpt.maybe_save(step)     # data position rides along

    Contract: the emitted stream is a pure function of
    (seed, epoch sequence, world size, batch_size, transform) —
    independent of num_workers, worker timing, and host load. `iter()`
    yields the CURRENT epoch from the current cursor, then advances to
    the next epoch; `state_dict()`/`load_state_dict()` round-trip the
    position exactly (cursor counts only samples covered by emitted
    batches, so a checkpoint taken between steps never loses or repeats
    in-flight samples).

    `transform(item)` or `transform(item, rng)`: the two-arg form gets a
    ``random.Random`` seeded from (seed, epoch, global index) — same
    augmentation stream regardless of sharding or worker count.

    ``skip_errors=True`` turns per-record failures (source reads — fault
    site ``dataio.read`` — and transform raises) into bounded, counted,
    rate-limit-logged skips instead of a dead epoch.
    """

    def __init__(self, source, transform=None, batch_size=None,
                 drop_last=False, num_workers=0, queue_depth=8,
                 collate=None, skip_errors=False, max_skips=1024,
                 name="dataio", elastic=False):
        enforce(isinstance(source, ShardedSource),
                f"source must be a ShardedSource, got {type(source)!r}")
        self._source = source
        self._transform = transform
        self._wants_rng = self._transform_wants_rng(transform)
        self._batch_size = batch_size
        self._drop_last = bool(drop_last)
        self._num_workers = int(num_workers)
        self._queue_depth = int(queue_depth)
        self._collate = collate
        self._skip_errors = bool(skip_errors)
        self._max_skips = int(max_skips)
        self._name = name
        # elastic=True lets load_state_dict accept a checkpoint written
        # under a DIFFERENT shard geometry by translating its cursor to
        # the epoch-global stream position (state.elastic_resume);
        # False keeps the strict same-geometry contract.
        self._elastic = bool(elastic)
        # position (the checkpointable part). No live RNG object: every
        # random draw (epoch order, per-sample augmentation) is derived
        # from (seed, epoch, idx), so position + seed IS the RNG state.
        # `_base` is the epoch-global offset this geometry's shards were
        # cut from — 0 except mid-epoch after an elastic resume, and it
        # resets to 0 when the epoch (suffix) is fully consumed.
        self._epoch = 0
        self._cursor = 0
        self._base = 0
        self._emitted_batches = 0
        self._skip_counter = registry().counter(
            "dataio_skipped_records_total",
            "records skipped by skip_errors pipelines",
            labels={"pipeline": name},
        )
        self._batch_counter = registry().counter(
            "dataio_batches_total", "batches emitted by the data engine",
            labels={"pipeline": name},
        )

    @staticmethod
    def _transform_wants_rng(transform):
        if transform is None:
            return False
        try:
            params = [
                p for p in inspect.signature(transform).parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            ]
            return len(params) >= 2
        except (TypeError, ValueError):
            return False

    # -- position ----------------------------------------------------------
    @property
    def epoch(self):
        return self._epoch

    @property
    def cursor(self):
        return self._cursor

    @property
    def base(self):
        return self._base

    @property
    def global_cursor(self):
        """Epoch-global stream position already consumed (state.py):
        geometry-free, so it survives elastic resizes."""
        return self._base + self._cursor * self._source.world

    @property
    def emitted_batches(self):
        return self._emitted_batches

    def state_dict(self):
        return IteratorState(
            epoch=self._epoch,
            cursor=self._cursor,
            base=self._base,
            emitted_batches=self._emitted_batches,
            seed=self._source.seed,
            world=self._source.world,
            rank=self._source.rank,
        ).to_dict()

    def load_state_dict(self, d):
        st = IteratorState.from_dict(d)
        if self._elastic and (st.world != self._source.world
                              or st.rank != self._source.rank):
            # a checkpoint from a different gang geometry: translate its
            # cursor to the epoch-global position and re-base this
            # rank's shards on the remaining stream suffix
            log.info(
                "dataio elastic resume: translating state from "
                "world=%d rank=%d to world=%d rank=%d "
                "(global cursor %d)", st.world, st.rank,
                self._source.world, self._source.rank, st.global_cursor(),
            )
            st = IteratorState.from_dict(elastic_resume(
                d, self._source.world, self._source.rank))
        enforce(
            st.world == self._source.world,
            f"checkpointed data state is for world size {st.world}, this "
            f"run has {self._source.world}: the shard cursor is not "
            "portable across world sizes",
        )
        enforce(
            st.rank == self._source.rank,
            f"checkpointed data state belongs to rank {st.rank}, this "
            f"process is rank {self._source.rank}",
        )
        if st.seed != self._source.seed:
            log.warning(
                "dataio resume: checkpoint seed %d != source seed %d; "
                "using the checkpointed seed so the stream continues "
                "exactly", st.seed, self._source.seed,
            )
            self._source.seed = st.seed
        self._epoch = st.epoch
        self._cursor = st.cursor
        self._base = st.base
        self._emitted_batches = st.emitted_batches

    # -- iteration ---------------------------------------------------------
    def _payloads(self, shard, epoch, start):
        """(global_idx, item) payloads for shard positions [start:);
        source-read failures become _PreErr markers so they hold their
        sequence slot (and become skips under skip_errors)."""
        for pos in range(start, len(shard)):
            idx = shard[pos]
            try:
                faults.fire("dataio.read", step=pos)
                item = self._source.item(idx)
            except Exception as e:
                yield _PreErr(e)
                continue
            yield (idx, item)

    def _apply(self, payload):
        idx, item = payload
        if self._transform is None:
            return item
        if self._wants_rng:
            rng = random.Random(mix_seed(self._source.seed, self._epoch, idx))
            return self._transform(item, rng)
        return self._transform(item)

    def __iter__(self):
        epoch = self._epoch
        start = self._cursor
        shard = self._source.epoch_shard(epoch, base=self._base)
        limited = RateLimitedLogger(log, max_records=8)
        skips = 0
        buf = []
        bs = self._batch_size
        results = _pool(
            self._payloads(shard, epoch, start), self._apply,
            self._num_workers, self._queue_depth, self._name,
        )
        for seq, kind, value in results:
            pos = start + seq  # position within the epoch shard
            if kind == _ERR:
                # only Exception subclasses are skippable:
                # SystemExit/KeyboardInterrupt-class failures abort
                # the epoch identically for every num_workers
                if not self._skip_errors or \
                        not isinstance(value, Exception):
                    raise value
                skips += 1
                self._skip_counter.inc()
                if skips > self._max_skips:
                    log.error(
                        "dataio pipeline '%s' exceeded max_skips=%d; "
                        "re-raising", self._name, self._max_skips,
                    )
                    limited.summarize(what="skipped records")
                    raise value
                limited.warning(
                    "skipping bad record at epoch %d pos %d "
                    "(skip %d/%d): %s: %s", epoch, pos, skips,
                    self._max_skips, type(value).__name__, value,
                )
                continue
            if bs is None:
                self._cursor = pos + 1
                self._emitted_batches += 1
                self._batch_counter.inc()
                yield value
                continue
            buf.append(value)
            if len(buf) == bs:
                batch = (self._collate(buf) if self._collate is not None
                         else buf)
                buf = []
                self._cursor = pos + 1
                self._emitted_batches += 1
                self._batch_counter.inc()
                yield batch
        if buf and not self._drop_last:
            batch = (self._collate(buf) if self._collate is not None
                     else buf)
            self._cursor = len(shard)
            self._emitted_batches += 1
            self._batch_counter.inc()
            yield batch
        limited.summarize(what="skipped records")
        # epoch fully consumed: advance (a mid-epoch elastic base only
        # lives until its suffix is drained — the next epoch re-shards
        # the full order)
        self._epoch = epoch + 1
        self._cursor = 0
        self._base = 0
