"""ServingEngine: SLO-aware worker loop over predictor replicas, the
port's copy of the JAX package's ``serving/engine.py``.

One engine owns the admission queue, the batcher, and N predictor
replicas (clones — shared weights and bucket cache, each its own
executor and I/O; the reference's thread-per-predictor serving pattern
with a shared scheduler). Worker threads race to form the next padded
batch under the queue lock, then run it on their replica outside the
lock. The port's executor issues eager ops from Python, and that host
work holds the interpreter lock, so replica threads contend for it: on
an H100, BERT-base served 0.4-0.6x the rows/s on 2 replicas that it
served on 1 (PERF.md §7). Keep ``num_replicas=1`` until replicas run as
processes (ROADMAP M6, fleet serving). Each worker runs its batches under
``torch.inference_mode()`` (the predictor enters it on every run: grad
mode is thread-local).

Guarantees:

* no first run of a shape after start(): warmup prepares every lattice
  point and the batcher only emits lattice shapes — `stats()` reports
  the post-warmup bucket-cache hit rate;
* failure isolation: a request that breaks a batch is re-run alone and
  fails alone (`RequestError`); batchmates are served from the re-run;
* explicit backpressure: admission rejects with retry-after once the
  queue is full, instead of queueing unboundedly;
* graceful drain: shutdown() stops admission, flushes partial batches,
  and joins workers — no request admitted is ever silently dropped;
* replica quarantine: a circuit breaker per replica
  (``serving/breaker.py``) opens after `breaker_threshold` CONSECUTIVE
  batch-run failures (a healthy batch resets the count) and stops
  dispatching to that replica; after `breaker_cooldown_s` the next batch
  is a PROBE — success re-admits the replica, failure re-opens the
  breaker for another cooldown. Lifecycle counters (batch_failures /
  breaker_opened / breaker_probes / breaker_closed / breaker_reopened)
  flow through `stats()`. Draining bypasses quarantine — on shutdown
  every queued request gets an answer attempt.

A batch run passes the ``serving.run_batch`` fault site
(``resilience/faults.py``) just before the replica runs it.
"""

import threading
import time

import numpy as np

from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving.batcher import (BatchPlan, BucketLattice,
                                              DynamicBatcher)
from paddle_tpu_torch.serving.breaker import ReplicaBreaker
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.queue import RequestQueue
from paddle_tpu_torch.serving.request import (
    DeadlineExceededError,
    Priority,
    RejectedError,
    Request,
    RequestError,
)

__all__ = ["ServingEngine"]


class ServingEngine:
    def __init__(self, config_or_predictor, lattice=None, num_replicas=1,
                 queue_depth=256, max_wait_ms=5.0, breaker_threshold=3,
                 breaker_cooldown_s=1.0):
        from paddle_tpu_torch.inference.predictor import Predictor

        if isinstance(config_or_predictor, Predictor):
            base = config_or_predictor
        else:
            base = Predictor(config_or_predictor)
        self._base = base
        if lattice is None:
            spec = base._config.serving_buckets()
            if spec is None:
                raise ValueError(
                    "ServingEngine needs a bucket lattice: call "
                    "Config.set_serving_buckets(...) or pass lattice="
                )
            lattice = BucketLattice(
                spec["batch_sizes"], spec["seq_lens"],
                pad_axis=spec["pad_axis"],
            )
        self._lattice = lattice
        self._replicas = [base] + [base.clone()
                                   for _ in range(int(num_replicas) - 1)]
        self._queue = RequestQueue(queue_depth)
        # declared feed specs drive strict admission (a shape/dtype the
        # lattice can't serve is rejected at the door, never prepared)
        # and make the batcher's padding/scatter decisions exact: only
        # declared-variable dims pad/slice
        block = base._program.global_block()
        self._feed_specs = {}
        for n in base.get_input_names():
            v = block._find_var_recursive(n)
            self._feed_specs[n] = (
                list(v.shape) if v is not None else None,
                str(v.dtype) if v is not None and v.dtype else None,
            )
        fetch_specs = {}
        for n in base.get_output_names():
            v = block._find_var_recursive(n)
            fetch_specs[n] = (list(v.shape)
                              if v is not None and v.shape else None)
        self._batcher = DynamicBatcher(
            lattice,
            feed_specs={n: s for n, (s, _) in self._feed_specs.items()},
            fetch_specs=fetch_specs, max_wait_s=max_wait_ms / 1e3,
        )
        self._breakers = [
            ReplicaBreaker(breaker_threshold, breaker_cooldown_s)
            if breaker_threshold and breaker_threshold > 0 else None
            for _ in self._replicas
        ]
        self._metrics = ServingMetrics()
        self._cond = threading.Condition(self._queue.lock)
        self._workers = []
        self._stop = False
        self._started = False
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._warm_base = {"hits": 0, "misses": 0}

    # -- lifecycle ---------------------------------------------------------
    def start(self, warmup=True):
        """Warm every lattice point, then start one worker per replica."""
        if self._started:
            return self
        if warmup:
            self._base.warmup(buckets={
                "batch_sizes": self._lattice.batch_sizes,
                "seq_lens": self._lattice.seq_lens,
                "pad_axis": self._lattice.pad_axis,
            })
        cs = self._base.cache_stats()
        self._warm_base = {"hits": cs["hits"], "misses": cs["misses"]}
        self._stop = False
        self._queue.reopen()
        self._started = True
        for i, rep in enumerate(self._replicas):
            t = threading.Thread(
                target=self._worker, args=(rep, self._breakers[i]),
                name=f"serving-worker-{i}", daemon=True,
            )
            t.start()
            self._workers.append(t)
        return self

    def shutdown(self, timeout=60.0):
        """Graceful drain: stop admitting, flush queued requests (partial
        batches dispatch immediately), join workers."""
        self._queue.close()
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for t in self._workers:
            t.join(timeout)
        self._workers = []
        self._started = False

    drain = shutdown

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- admission ---------------------------------------------------------
    def submit(self, inputs, priority=Priority.NORMAL, deadline_ms=None):
        """Admit one request; returns its Response future. Raises
        RejectedError (structured, with retry_after_s) when admission
        refuses — queue full, draining, or inadmissible inputs."""
        self._metrics.incr("submitted")
        try:
            norm = self._validate(inputs)
            rows, var_len, group_key = self._lattice.classify(
                norm, var_feeds=self._batcher.var_feeds
            )
        except RejectedError:
            self._metrics.incr("rejected")
            self._metrics.incr("rejected_invalid")
            raise
        if priority not in Priority.LANES:
            self._metrics.incr("rejected")
            self._metrics.incr("rejected_invalid")
            raise RejectedError(f"unknown priority {priority!r}")
        deadline = (time.perf_counter() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        with self._id_lock:
            self._next_id += 1
            rid = self._next_id
        req = Request(rid, norm, rows, priority, deadline, group_key, var_len)
        try:
            with self._cond:
                self._queue.put(req, retry_after_s=self._drain_estimate())
                self._cond.notify()
        except RejectedError as e:
            self._metrics.incr("rejected")
            self._metrics.incr("rejected_shutdown" if self._queue.closed()
                               else "rejected_queue_full")
            raise e
        self._metrics.incr("admitted")
        return req.response

    def _validate(self, inputs):
        """Strict admission against the program's declared feeds: right
        names, right dtypes, right concrete trailing dims. Anything the
        warmed lattice can't serve is refused here — after this point a
        request can only fail at runtime, never miss the bucket cache."""
        if not isinstance(inputs, dict):
            raise RejectedError("inputs must be {feed_name: array}")
        names = set(inputs)
        expect = set(self._feed_specs)
        if names != expect:
            raise RejectedError(
                f"inputs {sorted(names)} != declared feeds {sorted(expect)}"
            )
        norm = {}
        for n, v in inputs.items():
            arr = np.ascontiguousarray(v)
            shape, dtype = self._feed_specs[n]
            if dtype and str(arr.dtype) != dtype:
                raise RejectedError(
                    f"input '{n}' dtype {arr.dtype} != declared {dtype}; "
                    "cast before submitting (dtype is part of the bucket "
                    "key)"
                )
            if shape:
                if arr.ndim != len(shape):
                    raise RejectedError(
                        f"input '{n}' rank {arr.ndim} != declared "
                        f"{len(shape)} ({shape})"
                    )
                for i, d in enumerate(shape):
                    if i == 0 or int(d) == -1:
                        continue
                    if int(arr.shape[i]) != int(d):
                        raise RejectedError(
                            f"input '{n}' dim {i} is {arr.shape[i]}, "
                            f"declared {d}"
                        )
            norm[n] = arr
        return norm

    def _drain_estimate(self):
        """Caller-side backpressure floor: time for the current queue to
        drain at the observed batch rate (bounded; 50ms default before
        any data). The queue combines this with its own measured
        drain-rate estimate and reports the larger of the two.
        O(1) — it runs on every submit under the queue lock."""
        per_batch = self._metrics.run_avg_s() or 0.05
        batches = (self._queue.depth() / float(self._lattice.max_rows)
                   / max(len(self._replicas), 1))
        return min(max(per_batch * max(batches, 1.0), 0.005), 5.0)

    # -- worker loop -------------------------------------------------------
    def _worker(self, replica, breaker=None):
        while True:
            probing = False
            # quarantine gate (bypassed while draining: every queued
            # request deserves an answer attempt on shutdown)
            if breaker is not None and not self._stop:
                verdict, wait_s = breaker.gate()
                if verdict == "wait":
                    with self._cond:
                        # deadlines keep expiring while quarantined — a
                        # single-replica engine must still reject dead
                        # requests at their deadline, not after cooldown
                        for r in self._queue.expire():
                            self._reject_expired(r)
                        if not self._stop:
                            self._cond.wait(timeout=min(wait_s, 0.1))
                    continue
                probing = verdict == "probe"
            with self._cond:
                for r in self._queue.expire():
                    self._reject_expired(r)
                plan = self._batcher.plan(self._queue, force=self._stop)
                if plan is None:
                    if self._stop and self._queue.empty():
                        return
                    self._cond.wait(
                        timeout=max(
                            self._batcher.wait_hint(self._queue), 0.0005
                        )
                    )
                    continue
            if probing:
                self._metrics.incr("breaker_probes")
            self._execute(replica, plan, breaker)

    def _reject_expired(self, request):
        self._metrics.incr("deadline_missed")
        request.response._complete(error=DeadlineExceededError(
            "deadline expired after "
            f"{time.perf_counter() - request.submit_time:.3f}s in queue"
        ))
        self._metrics.observe_request(request)

    def _breaker_event(self, event):
        if event:
            self._metrics.incr(event)

    def _execute(self, replica, plan, breaker=None):
        t0 = time.perf_counter()
        try:
            feeds = self._batcher.assemble(plan)
            faults.fire("serving.run_batch")
            outputs = replica.run_batch(feeds)
        except Exception:
            # one request poisoned the batch (bad buffer, runtime fault):
            # isolate by re-running each request alone at its own lattice
            # point (still warmed — a cache hit) so only the poison fails.
            # The breaker counts the batch-level outcome — K consecutive
            # of these quarantine the replica.
            self._metrics.incr("batch_failures")
            if breaker is not None:
                self._breaker_event(breaker.record_failure())
            self._isolate(replica, plan)
            return
        if breaker is not None:
            self._breaker_event(breaker.record_success())
        self._metrics.observe_batch(plan, time.perf_counter() - t0)
        for req, res in zip(plan.requests,
                            self._batcher.scatter(plan, outputs)):
            req.response._complete(outputs=res)
            self._metrics.incr("completed", 1)
            self._metrics.observe_request(req)

    def _isolate(self, replica, plan):
        for req in plan.requests:
            single = BatchPlan(
                [req], self._lattice.bucket_rows(req.rows), plan.bucket_len
            )
            t0 = time.perf_counter()
            try:
                feeds = self._batcher.assemble(single)
                faults.fire("serving.run_batch")
                outputs = replica.run_batch(feeds)
            except Exception as e:
                self._metrics.incr("failed")
                req.response._complete(error=RequestError(
                    f"request {req.id} failed: {e}"
                ))
                self._metrics.observe_request(req)
                continue
            self._metrics.observe_batch(single, time.perf_counter() - t0)
            req.response._complete(
                outputs=self._batcher.scatter(single, outputs, request=req)[0]
            )
            self._metrics.incr("completed", 1)
            self._metrics.observe_request(req)

    # -- observability -----------------------------------------------------
    def stats(self):
        """One coherent snapshot: queue, batcher, latency, and the
        post-warmup bucket-cache hit rate (1.0 == no first run of a shape
        after start)."""
        cs = self._base.cache_stats()
        hits = cs["hits"] - self._warm_base["hits"]
        misses = cs["misses"] - self._warm_base["misses"]
        breakers = [b.state for b in self._breakers if b is not None]
        return self._metrics.snapshot(extra={
            **self._metrics.queue_snapshot(self._queue),
            "num_replicas": len(self._replicas),
            "breaker_states": breakers,
            "breaker_open_replicas": sum(
                1 for s in breakers if s != "closed"
            ),
            "batch_buckets": list(self._lattice.batch_sizes),
            "seq_buckets": (list(self._lattice.seq_lens)
                            if self._lattice.seq_lens else None),
            "cache_hits": hits,
            "cache_misses": misses,
            "cache_hit_rate": hits / max(hits + misses, 1),
            "compile_seconds": cs["compile_s"],
        })

    @property
    def metrics(self):
        return self._metrics

    @property
    def lattice(self):
        return self._lattice

    @property
    def predictor(self):
        return self._base
