"""Reader decorators: composable generator transforms.

Reference: python/paddle/reader/decorator.py — shuffle, batch (creator),
buffered (background thread), cache, chain, compose, map_readers,
xmap_readers (parallel map), firstn. A "reader" is a zero-arg callable
returning an iterator of samples; decorators wrap readers into new readers.
These are host-side and framework-agnostic: the port's copy of the JAX
package's ``reader/decorator.py``, unchanged in behaviour. The work for
the card (staging on it) lives in ``reader/dataloader.py`` and
``dataio/prefetch.py``.
"""

import itertools
import logging
import queue
import random
import threading
import time

__all__ = [
    "cache",
    "map_readers",
    "buffered",
    "compose",
    "chain",
    "shuffle",
    "firstn",
    "xmap_readers",
    "batch",
    "robust",
]


def cache(reader):
    """Materialize the reader once; replay from memory afterwards."""
    all_data = []
    filled = []

    def cached_reader():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        return iter(all_data)

    return cached_reader


def map_readers(func, *readers):
    """Sample-wise map over zipped readers."""

    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)

    return reader


def shuffle(reader, buf_size, seed=None):
    """Pool-based shuffling (reference: decorator.py shuffle).

    `seed` makes the shuffle deterministic via a LOCAL
    ``random.Random(seed)`` — fresh per iteration, so every epoch (and
    every rerun) of a seeded reader replays the identical order, and
    nothing perturbs or reads the module-global RNG. Default (seed=None)
    keeps the reference behavior: the process-global ``random`` state."""

    def data_reader():
        rng = random if seed is None else random.Random(seed)
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rng.shuffle(buf)
            yield from buf

    return data_reader


def chain(*readers):
    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


def compose(*readers, **kwargs):
    """Zip readers into tuple samples; check_alignment verifies equal
    lengths."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise RuntimeError("readers have different lengths")
                yield sum(list(map(make_tuple, outputs)), ())

    return reader


def _abortable_put(q, item, stop):
    """Bounded put that gives up when the consumer abandoned iteration, so
    producer threads never block forever on a full queue."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def buffered(reader, size):
    """Decouple producer/consumer with a background thread + bounded queue
    (reference: decorator.py buffered)."""

    class _End:
        pass

    def data_reader():
        r = reader()
        q = queue.Queue(maxsize=size)
        err = []
        stop = threading.Event()

        def produce():
            try:
                for d in r:
                    if not _abortable_put(q, d, stop):
                        return
            except BaseException as e:  # propagate into consumer
                err.append(e)
            finally:
                _abortable_put(q, _End, stop)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                e = q.get()
                if e is _End:
                    if err:
                        raise err[0]
                    return
                yield e
        finally:
            stop.set()

    return data_reader


def firstn(reader, n):
    def data_reader():
        return itertools.islice(reader(), n)

    return data_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map with worker threads (reference: decorator.py
    xmap_readers). order=True preserves input order."""

    class _End:
        pass

    def data_reader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)
        err = []
        stop = threading.Event()

        def feed():
            try:
                for i, d in enumerate(reader()):
                    if not _abortable_put(in_q, (i, d), stop):
                        return
            except BaseException as e:
                err.append(e)
            finally:
                for _ in range(process_num):
                    if not _abortable_put(in_q, _End, stop):
                        return

        def work():
            while not stop.is_set():
                try:
                    item = in_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is _End:
                    _abortable_put(out_q, _End, stop)
                    return
                i, d = item
                try:
                    if not _abortable_put(out_q, (i, mapper(d)), stop):
                        return
                except BaseException as e:
                    err.append(e)
                    _abortable_put(out_q, _End, stop)
                    return

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()

        try:
            finished = 0
            if order:
                pending, want = {}, 0
                while finished < process_num:
                    item = out_q.get()
                    if item is _End:
                        finished += 1
                        continue
                    i, d = item
                    pending[i] = d
                    while want in pending:
                        yield pending.pop(want)
                        want += 1
                for i in sorted(pending):
                    yield pending[i]
            else:
                while finished < process_num:
                    item = out_q.get()
                    if item is _End:
                        finished += 1
                        continue
                    yield item[1]
            if err:
                raise err[0]
        finally:
            stop.set()

    return data_reader


def robust(reader, max_skips=16, max_restarts=4, backoff_s=0.0,
           retry_on=(Exception,)):
    """Skip-and-log bad records instead of killing the epoch (opt-in;
    also exposed as ``fluid.io.robust``).

    Wraps each `next()` on the underlying iterator: a transient exception
    (matching `retry_on`) is logged and counted as one skipped record —
    bounded by `max_skips`, after which the error propagates (a reader
    that is ALL bad records must still fail loudly). Class-based
    iterators simply continue past the bad record. A plain generator
    dies on its first raise (Python semantics), so the decorator
    recreates the reader and fast-forwards past everything already
    consumed plus the bad record — bounded by `max_restarts`, assuming
    the deterministic re-iteration a replayable reader provides
    (file/dataset readers; NOT one-shot streams). Fast-forward
    re-executes earlier records, so a generator record that fails
    DETERMINISTICALLY cannot be skipped — the restart budget exhausts
    and the error is re-raised (never a silent truncation); use a
    class-based iterator for true skip-past-bad-record semantics.
    `backoff_s` sleeps before each recovery for readers whose failures
    are time-transient (e.g. remote storage).

    Skip logging is rate-limited through the observability layer: the
    first `log_first_n` skips log individually, the rest are counted
    silently (``reader_skipped_records_total`` in the metrics registry
    keeps the live rate), and one summary line reports totals when the
    epoch ends — a 10%-bad dataset does not turn the log into noise."""
    log = logging.getLogger("paddle_tpu_torch.reader.robust")
    log_first_n = 8

    def _recreate(position):
        return itertools.islice(reader(), position, None)

    def data_reader():
        import inspect

        from paddle_tpu_torch.observability import registry
        from paddle_tpu_torch.observability.logger import RateLimitedLogger

        limited = RateLimitedLogger(log, max_records=log_first_n)
        skip_counter = registry().counter(
            "reader_skipped_records_total",
            "records skipped by fluid.io.robust readers",
        )

        consumed = 0
        skips = 0
        restarts = 0
        last_error = None  # last next() raised: detect a dead generator
        it = reader()
        # only a GENERATOR dies on raise; a class-based iterator that
        # raised and then ends simply reached end-of-data
        mortal = inspect.isgenerator(it)
        while True:
            try:
                sample = next(it)
            except StopIteration:
                if last_error is None or not mortal:
                    limited.summarize(what="skipped records")
                    return
                # the previous raise killed a generator: StopIteration
                # here is death, not end-of-data — restart past the bad
                # record (position = consumed good + skipped bad)
                if restarts >= max_restarts:
                    log.error(
                        "reader died %d times at record ~%d; raising",
                        restarts + 1, consumed + skips,
                    )
                    limited.summarize(what="skipped records")
                    raise last_error
                restarts += 1
                last_error = None
                if backoff_s:
                    time.sleep(backoff_s)
                it = _recreate(consumed + skips)
            except retry_on as e:
                skips += 1
                skip_counter.inc()
                if skips > max_skips:
                    log.error(
                        "reader exceeded max_skips=%d; re-raising", max_skips
                    )
                    limited.summarize(what="skipped records")
                    raise
                limited.warning(
                    "skipping bad record %d (skip %d/%d): %s: %s",
                    consumed + skips, skips, max_skips,
                    type(e).__name__, e,
                )
                last_error = e
                if backoff_s:
                    time.sleep(backoff_s)
            else:
                last_error = None
                consumed += 1
                yield sample

    return data_reader


def batch(reader, batch_size, drop_last=False):
    """Group samples into lists of batch_size (reference:
    python/paddle/batch.py)."""

    def batch_reader():
        b = []
        for d in reader():
            b.append(d)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
