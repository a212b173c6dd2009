"""Fleet-router metrics: acceptance/outcome accounting + the failover
lifecycle counters the chaos gate asserts over.

The port's copy of the JAX package's ``serving/fleet/metrics.py``.

Same discipline as ServingMetrics: always-on registry-backed counters
(one ``router=<label>`` label set per FleetRouter, reset on router
creation so a rebuilt router starts from zero) plus an end-to-end
latency histogram whose p99 is the chaos scenario's headline number.

The zero-loss invariant is an ACCOUNTING identity over these counters:
every ``accepted`` request ends in exactly one of ``completed``,
``failed``, ``deadline_missed``, or ``drained_unserved`` —
``tools/torch_chaos_serve.py`` recomputes ``accepted == completed`` (no
deadlines, no drain in the scenario) and any gap is an
accepted-then-lost request.
"""

from paddle_tpu_torch.observability import metrics as obs_metrics

__all__ = ["FleetMetrics"]


class FleetMetrics:
    COUNTERS = (
        # admission / outcome (the zero-loss identity's terms)
        "submitted", "accepted", "completed", "failed", "deadline_missed",
        "rejected_shed", "rejected_invalid", "drained_unserved",
        # failover lifecycle
        "rerouted", "dispatch_faults", "health_probe_failures",
        "replica_deaths", "replicas_revived", "supervisor_restarts",
        # per-replica circuit breaker (the breaker contract at fleet scope)
        "breaker_opened", "breaker_probes", "breaker_closed",
        "breaker_reopened",
        # elasticity + rolling deploys ("replaced_deploys" = subprocess
        # worker-replacement swaps inside a deploy() pass)
        "scale_ups", "scale_downs", "deploys", "replaced_deploys",
        "stolen_queued",
        # brownout: fleet-level sheds when EVERY routable replica
        # reports severity 4 (non-HIGH turned away at the router door)
        "brownout_shed",
    )

    def __init__(self, router_label, registry=None):
        self._registry = registry or obs_metrics.registry()
        self.router_label = str(router_label)
        labels = {"router": self.router_label}
        self._counts = {
            name: self._registry.counter(
                f"fleet_{name}_total", f"fleet router {name} count",
                labels=labels,
            )
            for name in self.COUNTERS
        }
        self._latency = self._registry.histogram(
            "fleet_latency_seconds",
            "submit-to-answer latency through the router", labels=labels,
        )
        self._healthy = self._registry.gauge(
            "fleet_healthy_replicas", "routable replica count",
            labels=labels,
        )
        for series in list(self._counts.values()) + [self._latency]:
            series.reset()
        self._healthy.set(0)

    def incr(self, name, n=1):
        self._counts[name].inc(n)

    def count(self, name):
        return self._counts[name].value

    def observe_latency(self, seconds):
        self._latency.observe(seconds)

    def set_healthy(self, n):
        self._healthy.set(n)

    def snapshot(self, extra=None):
        out = {name: c.value for name, c in self._counts.items()}
        out.update(self._latency.snapshot("latency"))
        if extra:
            out.update(extra)
        return out
