"""Device prefetch: a bounded double-buffer of batches staged on the card.

Reference: paddle/fluid/operators/reader/buffered_reader.cc keeps two
in-flight GPU copies on a dedicated CUDA stream so the H2D of batch N+1
overlaps the compute of batch N. The port does the same: a producer
thread copies each array into a pinned host buffer, uploads it with
``non_blocking=True`` on a side stream, and waits for the copies'
event before it queues the batch, so the consumer never sees a tensor whose
copy is still running and a pinned buffer is reused only after its copy
has finished. The consumer ``record_stream``s each tensor on its own
current stream, so the caching allocator does not hand the block back to
the side stream while a step still reads it. The bounded queue is the
double-buffer (depth 2 by default).

The JAX package's ``DevicePrefetcher`` (``dataio/prefetch.py``) places
every array with ``jax.device_put``. Two differences:

* A feed that the host reads stays on the host, as a numpy array
  (``host_keys``): the raw ids that the embedding engine, the PS worker
  and the remote lookup read on the host (``host_read_feeds`` of a
  program). Staging them would cost a copy to the card and one back.
* With a data-parallel rank (``rank``/``world``: the port's
  one-process-per-rank plan, ``parallel/data_parallel.py``), an array
  whose leading dim divides by ``world`` is staged as this rank's rows
  ``[r*B/n, (r+1)*B/n)`` only; other arrays go whole (the JAX package's
  ``NamedSharding(P(axis))`` and replication).

``specs`` ({name: (dtype, shape)}) casts each named array through
``data_feeder.check_feed_array`` before it is staged: a tensor fed to the
executor keeps its own dtype, so the cast has to come first.

The consumer-exact ``state_dict`` proxy is the JAX package's: the state
exposed is the source's as of the last batch the CONSUMER received.
The JAX package wraps the staging in a ``dataio::device_put`` span; the
port has no tracer yet (ROADMAP M12).
"""

import contextlib
import queue
import threading
import time

import numpy as np
import torch

from paddle_tpu_torch.data_feeder import check_feed_array
from paddle_tpu_torch.dataio.engine import _abortable_put
from paddle_tpu_torch.observability import registry

__all__ = ["DevicePrefetcher"]

_END = object()


class DevicePrefetcher:
    """Iterate `batches` (dicts of arrays, or bare arrays) with a
    background thread that stages `depth` batches ahead on ``device``
    (a ``torch.device``, a place, or None for the first card). Producer
    exceptions re-raise in the consumer at the position they occurred;
    abandoning iteration unblocks and stops the producer.

    Checkpointing a prefetched engine: the producer thread consumes the
    wrapped iterable up to `depth` batches AHEAD of the training loop,
    so snapshotting the ENGINE's position directly would record batches
    still sitting in the queue (resume would skip them). The prefetcher
    therefore proxies checkpoint state itself — it pairs every staged
    batch with the source's state at that point and exposes the pair
    belonging to the last YIELDED batch. Attach the PREFETCHER, not the
    engine:

        pre = DevicePrefetcher(engine, depth=2)
        ckpt = AutoCheckpoint(exe, prog, dirname, data_state=pre)
    """

    def __init__(self, batches, depth=2, device=None, rank=None, world=None,
                 host_keys=(), specs=None, name="prefetch"):
        self._batches = batches
        self._last_state = None  # source state as of the last YIELDED batch
        self._depth = max(1, int(depth))
        self._device = _resolve_device(device)
        self._rank = None if world in (None, 1) else int(rank)
        self._world = None if world in (None, 1) else int(world)
        self._host_keys = frozenset(host_keys)
        self._specs = dict(specs or {})
        self._name = name
        self._pinned = {}
        reg = registry()
        self._depth_gauge = reg.gauge(
            "dataio_queue_depth", "items buffered in pipeline queues",
            labels={"pipeline": name, "queue": "prefetch"},
        )
        self._consumer_wait = reg.histogram(
            "dataio_consumer_wait_seconds",
            "time the consumer spent blocked waiting for the next result",
            labels={"pipeline": name},
        )
        # the producer's wait for a batch's copies to the card: one a
        # batch, on the prefetch thread (an event wait, which PyTorch's
        # sync debug mode does not report)
        self._copy_wait = reg.histogram(
            "dataio_copy_wait_seconds",
            "time the prefetch producer spent waiting for a batch's copies",
            labels={"pipeline": name},
        )

    @property
    def device(self):
        return self._device

    # -- placement ---------------------------------------------------------
    def _rows(self, arr):
        """This rank's rows of a batch-shaped array, else the array."""
        if self._world is None or arr.ndim < 1 or arr.shape[0] % self._world:
            return arr
        per = arr.shape[0] // self._world
        return arr[self._rank * per:(self._rank + 1) * per]

    def _pinned_copy(self, key, arr):
        """``arr`` in a pinned host buffer kept for ``key``'s shape and
        dtype (reused: the producer waits for each upload to finish
        before it takes the next batch)."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        tag = (key, tuple(src.shape), src.dtype)
        buf = self._pinned.get(tag)
        if buf is None:
            buf = self._pinned[tag] = torch.empty(
                src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        return buf

    def _put_one(self, key, value, stream):
        if isinstance(value, (list, tuple)):
            # a nested batch (the engine's samples): each leaf staged, as
            # jax.device_put stages a pytree
            return type(value)(self._put_one(key, v, stream) for v in value)
        if key in self._host_keys:
            arr = np.asarray(value)
            spec = self._specs.get(key)
            return check_feed_array(key, arr, *spec) if spec else arr
        arr = np.asarray(value)
        spec = self._specs.get(key)
        if spec is not None:
            arr = check_feed_array(key, arr, *spec)
        arr = self._rows(arr)
        if stream is None:
            return torch.from_numpy(np.ascontiguousarray(arr)).to(self._device)
        return self._pinned_copy(key, arr).to(self._device, non_blocking=True)

    def _stage(self, batch):
        stream = None
        if self._device.type == "cuda":
            stream = _side_stream(self._device)
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            if isinstance(batch, dict):
                out = {k: self._put_one(k, v, stream) for k, v in batch.items()}
            elif isinstance(batch, (list, tuple)):
                out = type(batch)(self._put_one(i, v, stream)
                                  for i, v in enumerate(batch))
            else:
                out = self._put_one(None, batch, stream)
        if stream is not None:
            # the batch is queued only once its copies are done: the
            # consumer never reads a tensor mid-copy, and the pinned
            # buffers are free for the next batch. This thread waits on
            # the copies' event; the training thread never does
            done = torch.cuda.Event()
            done.record(stream)
            t0 = time.perf_counter()
            done.synchronize()
            self._copy_wait.observe(time.perf_counter() - t0)
        return out

    @staticmethod
    def _record(batch, stream):
        """Tie each staged tensor to the consuming stream, so its block
        is not handed back to the side stream while a step reads it."""
        values = (batch.values() if isinstance(batch, dict)
                  else batch if isinstance(batch, (list, tuple)) else [batch])
        for v in values:
            if isinstance(v, torch.Tensor) and v.is_cuda:
                v.record_stream(stream)

    # -- checkpointable-state proxy ----------------------------------------
    def state_dict(self):
        """Source position as of the last batch the CONSUMER received —
        not the producer's read-ahead position. Before any batch is
        yielded, falls through to the source's current state."""
        if self._last_state is not None:
            return self._last_state
        getter = getattr(self._batches, "state_dict", None)
        return getter() if getter is not None else None

    def load_state_dict(self, d):
        """Forwards to the wrapped source — including the elastic
        geometry translation when the source is a
        ``DataEngine(elastic=True)`` (the prefetcher proxies position,
        it never owns geometry)."""
        self._batches.load_state_dict(d)
        self._last_state = None

    def global_cursor(self):
        """Epoch-global stream position as of the last batch the
        CONSUMER received (None when the wrapped source keeps no
        state)."""
        st = self.state_dict()
        if st is None:
            return None
        from paddle_tpu_torch.dataio.state import IteratorState

        return IteratorState.from_dict(st).global_cursor()

    # -- iteration ---------------------------------------------------------
    def __iter__(self):
        q = queue.Queue(maxsize=self._depth)
        err = []
        stop = threading.Event()
        get_state = getattr(self._batches, "state_dict", None)

        def produce():
            try:
                for batch in self._batches:
                    # snapshot the source position the moment the batch
                    # left it: this pair is what state_dict() exposes
                    # once the batch reaches the consumer
                    st = get_state() if get_state is not None else None
                    if not _abortable_put(q, (self._stage(batch), st),
                                          stop):
                        return
            except BaseException as e:
                err.append(e)
            finally:
                _abortable_put(q, _END, stop)

        t = threading.Thread(target=produce, daemon=True,
                             name=f"{self._name}-prefetch")
        t.start()
        consumer = (torch.cuda.current_stream(self._device)
                    if self._device.type == "cuda" else None)
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self._consumer_wait.observe(time.perf_counter() - t0)
                self._depth_gauge.set(q.qsize())
                if item is _END:
                    if err:
                        raise err[0]
                    return
                batch, st = item
                if st is not None:
                    self._last_state = st
                if consumer is not None:
                    self._record(batch, consumer)
                yield batch
        finally:
            stop.set()
            while not q.empty():  # unblock producer, drop staged batches
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            # bounded shutdown: the producer sees `stop` within one
            # abortable-put poll
            t.join(timeout=5.0)
            if t.is_alive():
                from paddle_tpu_torch.observability.logger import get_logger

                get_logger("dataio.prefetch").warning(
                    "prefetch producer %s still alive 5s after abandon; "
                    "leaking daemon thread", t.name)


_streams = {}
_streams_lock = threading.Lock()


def _side_stream(device):
    """One copy stream per card, shared by the prefetchers of a process."""
    with _streams_lock:
        s = _streams.get(device.index)
        if s is None:
            s = _streams[device.index] = torch.cuda.Stream(device)
        return s


def _resolve_device(device):
    if isinstance(device, torch.device):
        return device
    if isinstance(device, str):
        return torch.device(device)
    from paddle_tpu_torch.core.places import default_place

    return default_place(device).device
