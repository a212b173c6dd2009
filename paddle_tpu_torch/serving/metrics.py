"""Serving metrics: always-on registry-backed counters + latency histograms.

The port's copy of the JAX package's ``serving/metrics.py``, without its
profiler mirror (``torch.profiler`` takes that place: ROADMAP.md, M12).
The batching ServingEngine records each dispatched batch through
``observe_batch``; the decode engine keeps the same batch counters and
``run`` histogram, so both engines' ``stats()`` carry the JAX keys.
The engines record into the process-global registry
(``paddle_tpu_torch.observability.metrics``); each ServingMetrics
instance is one ``engine=<label>`` label set, so two engines in a process
scrape as two series while each engine's ``stats()`` stays exact.

Latency percentiles come from bucketed histograms (p50/p95/p99 by linear
interpolation inside the target bucket). Per-lane queue-depth gauges
(``serving_queue_lane_depth{engine,lane}``) and per-tenant counters
(``serving_tenant_<name>_total{engine,tenant}``) ride the same engine
label set.
"""

import itertools
import threading

from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.serving.request import Priority

__all__ = ["ServingMetrics"]

_ENGINE_SEQ = itertools.count()

LANE_NAMES = {Priority.HIGH: "high", Priority.NORMAL: "normal",
              Priority.LOW: "low"}


class ServingMetrics:
    COUNTERS = (
        "submitted", "admitted", "rejected", "rejected_queue_full",
        "rejected_shutdown", "rejected_invalid", "deadline_missed",
        "completed", "failed", "batches", "batched_rows", "padded_rows",
        # replica circuit breaker (serving/breaker.py): quarantine/probe
        # lifecycle
        "batch_failures", "breaker_opened", "breaker_probes",
        "breaker_closed", "breaker_reopened",
    )

    def __init__(self, engine_label=None, registry=None):
        self._registry = registry or obs_metrics.registry()
        self.engine_label = (engine_label
                            or f"engine-{next(_ENGINE_SEQ)}")
        labels = {"engine": self.engine_label}
        self._counts = {
            name: self._registry.counter(
                f"serving_{name}_total", f"serving {name} count",
                labels=labels,
            )
            for name in self.COUNTERS
        }
        self._queue_wait = self._registry.histogram(
            "serving_queue_wait_seconds",
            "submit-to-dispatch wait", labels=labels,
        )
        self._run = self._registry.histogram(
            "serving_run_seconds", "batch execution latency", labels=labels,
        )
        self._total = self._registry.histogram(
            "serving_latency_seconds", "submit-to-finish latency",
            labels=labels,
        )
        self._occupancy_sum = self._registry.counter(
            "serving_batch_occupancy_sum",
            "sum of per-batch row occupancy", labels=labels,
        )
        self._lane_depth = {
            lane: self._registry.gauge(
                "serving_queue_lane_depth",
                "queued rows per priority lane",
                labels={**labels, "lane": name},
            )
            for lane, name in LANE_NAMES.items()
        }
        self._tenant_counts = {}  # (counter_name, tenant) -> Counter
        self._tenant_lock = threading.Lock()
        # batches/batched_rows/occupancy move together, so the averages
        # in snapshot() stay consistent
        self._batch_lock = threading.Lock()
        # a ServingMetrics instance is one engine LIFETIME: re-creating an
        # engine under a reused label must start from zero (the registry
        # series are get-or-create)
        for series in list(self._counts.values()) + [
            self._queue_wait, self._run, self._total, self._occupancy_sum,
        ] + list(self._lane_depth.values()):
            series.reset()

    def incr(self, name, n=1):
        self._counts[name].inc(n)

    def tenant_incr(self, name, tenant, n=1):
        """Per-tenant counter ``serving_tenant_<name>_total{engine,tenant}``
        (get-or-create per label set; tenants are few and long-lived)."""
        key = (name, tenant)
        c = self._tenant_counts.get(key)
        if c is None:
            with self._tenant_lock:
                c = self._tenant_counts.get(key)
                if c is None:
                    c = self._registry.counter(
                        f"serving_tenant_{name}_total",
                        f"per-tenant serving {name} count",
                        labels={"engine": self.engine_label,
                                "tenant": str(tenant)},
                    )
                    c.reset()
                    self._tenant_counts[key] = c
        c.inc(n)

    def tenant_counts(self, name):
        """{tenant: count} snapshot for one per-tenant counter family."""
        with self._tenant_lock:  # tenant_incr inserts concurrently
            items = list(self._tenant_counts.items())
        return {t: c.value for (n, t), c in items if n == name}

    def set_lane_depths(self, depths):
        """Update the per-lane queue-depth gauges from
        ``RequestQueue.stats()["lane_depths"]``."""
        for lane, rows in depths.items():
            g = self._lane_depth.get(lane)
            if g is not None:
                g.set(rows)

    def queue_snapshot(self, queue):
        """ONE consistent ``queue.stats()`` read shaped into the
        ``stats()`` extra keys, updating the per-lane gauges on the
        way."""
        qs = queue.stats()
        lane_depths = qs.pop("lane_depths")
        self.set_lane_depths(lane_depths)
        return {
            "queue_depth": qs["depth"],
            "queue_lane_depths": {
                name: lane_depths.get(lane, 0)
                for lane, name in LANE_NAMES.items()
            },
            "queue_drain_rate_rows_per_s": qs["drain_rate_rows_per_s"],
            "queue_rejected_at_admission": qs["rejected_at_admission"],
            "queue_expired_in_queue": qs["expired_in_queue"],
            "queue_rerouted": qs["rerouted"],
        }

    def observe_batch(self, plan, run_seconds):
        """One dispatched padded batch (``serving/batcher.py``'s
        ``BatchPlan``): its real and padded rows, its occupancy and its
        run time."""
        with self._batch_lock:
            self._counts["batches"].inc()
            self._counts["batched_rows"].inc(plan.real_rows)
            self._counts["padded_rows"].inc(plan.bucket_rows - plan.real_rows)
            self._occupancy_sum.inc(plan.occupancy)
        self._run.observe(run_seconds)

    def observe_request(self, request):
        """Called at completion: queue-wait + end-to-end latency."""
        finish = request.response.finish_time
        if request.dispatch_time is not None:
            self._queue_wait.observe(
                request.dispatch_time - request.submit_time
            )
        if finish is not None:
            self._total.observe(finish - request.submit_time)

    def count(self, name):
        return self._counts[name].value

    def run_avg_s(self):
        """O(1) mean batch-run latency (no percentile math — safe on the
        admission hot path)."""
        return self._run.avg

    def snapshot(self, extra=None):
        with self._batch_lock:
            out = {name: c.value for name, c in self._counts.items()}
            occupancy_sum = self._occupancy_sum.value
        batches = max(out["batches"], 1)
        out["avg_batch_occupancy"] = occupancy_sum / batches
        out["avg_batch_rows"] = out["batched_rows"] / batches
        out.update(self._queue_wait.snapshot("queue_wait"))
        out.update(self._run.snapshot("run"))
        out.update(self._total.snapshot("latency"))
        if extra:
            out.update(extra)
        return out
