"""Per-replica health: the circuit-breaker contract under an explicit
DEAD state.

The port's copy of the JAX package's ``serving/fleet/health.py``. Each
replica the router fronts carries one ``ReplicaHealth``: a
``ReplicaBreaker`` (serving/breaker.py — closed -> K consecutive
failures -> open -> cooldown -> half-open probe) driven by BOTH dispatch
outcomes and heartbeat probes, plus a ``dead`` latch for hard failures
(transport EOF, the ``replica.kill`` fault site, a worker process
exiting). The distinction matters for routing: a quarantined (breaker-
open) replica still gets periodic probes and re-admits itself after a
healthy one; a dead replica never self-heals — it leaves the routing
set until something external (supervisor ``restart(rank)``, autoscale
replacement) revives it with a FRESH breaker.

Mutation happens under the router's ``fleet.router`` lock (the router
owns the table); the breaker keeps its own ``serving.breaker`` leaf
lock so probe gating stays safe from the health pass too.
"""

import time

from paddle_tpu_torch.serving.breaker import ReplicaBreaker

__all__ = ["ReplicaHealth"]


class ReplicaHealth:
    __slots__ = ("threshold", "cooldown_s", "breaker", "dead",
                 "death_reason", "deaths", "last_seen", "severity")

    def __init__(self, threshold=3, cooldown_s=1.0):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.breaker = (ReplicaBreaker(threshold, cooldown_s)
                        if threshold and threshold > 0 else None)
        self.dead = False
        self.death_reason = None
        self.deaths = 0
        self.last_seen = None
        # brownout severity (serving/brownout.py) last sampled from the
        # replica's engine stats by the router's health pass: 0 = full
        # service .. 4 = shedding; the router biases dispatch away from
        # browned-out replicas and sheds fleet-wide at 4
        self.severity = 0

    # -- routing gate ------------------------------------------------------
    def routable(self):
        """May the router dispatch here? Breaker 'probe' counts as
        routable — the probe TRAFFIC is what closes a half-open breaker
        (the re-admission contract)."""
        if self.dead:
            return False
        if self.breaker is None:
            return True
        verdict, _ = self.breaker.gate()
        return verdict in ("dispatch", "probe")

    def probing(self):
        """True when the next dispatch is a half-open re-admission
        probe (counted by the router as `breaker_probes`)."""
        if self.dead or self.breaker is None:
            return False
        return self.breaker.gate()[0] == "probe"

    def state(self):
        if self.dead:
            return "dead"
        return self.breaker.state if self.breaker is not None else "closed"

    # -- outcome plumbing (returns the breaker lifecycle event or None) ----
    def note_success(self):
        self.last_seen = time.perf_counter()
        if self.dead or self.breaker is None:
            return None
        # consult the cooldown gate first: an open breaker whose
        # cooldown elapsed moves to half_open, so THIS healthy
        # heartbeat/dispatch is the re-admission probe that closes it
        # (without traffic, nothing else would ever call gate())
        self.breaker.gate()
        return self.breaker.record_success()

    def note_failure(self):
        if self.dead or self.breaker is None:
            return None
        # same gate-first rule: a failure after cooldown is a FAILED
        # probe — the breaker re-opens with a fresh cooldown window
        # instead of staying open on a stale opened_at
        self.breaker.gate()
        return self.breaker.record_failure()

    # -- hard lifecycle ----------------------------------------------------
    def mark_dead(self, reason=None):
        already = self.dead
        self.dead = True
        self.death_reason = str(reason) if reason is not None else None
        if not already:
            self.deaths += 1
        return not already

    def revive(self):
        """A restarted/replaced process behind the same slot: fresh
        breaker (the old failure streak belongs to the dead
        incarnation), death latch cleared."""
        self.dead = False
        self.death_reason = None
        self.breaker = (ReplicaBreaker(self.threshold, self.cooldown_s)
                        if self.threshold and self.threshold > 0 else None)
