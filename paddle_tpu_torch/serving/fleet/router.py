"""FleetRouter: chaos-proven failover over N decode replicas.

The port's copy of the JAX package's ``serving/fleet/router.py``: the
tier above one engine, a front-end router that accepts generation
requests once and then OWNS delivering an answer, whatever happens to
the replica serving them.

Guarantees (``tools/torch_chaos_serve.py`` asserts all of them):

* **At-most-once-VISIBLE re-dispatch.** A request lost to a dead or
  quarantined replica is transparently retried on a healthy one under
  the caller's ORIGINAL deadline (the absolute deadline travels with the
  request — a retry never gets a fresh budget). The request may
  EXECUTE more than once, but because decode is bit-deterministic the
  caller-visible answer is byte-identical to the single-replica offline
  reference, and the write-once Response future makes exactly one
  delivery possible. Accounting identity: every accepted request ends
  completed, deadline-missed, failed (request-attributed), or
  drained-unserved — never silently lost.
* **Prefix-affinity routing.** Requests route by rendezvous hash of the
  prompt's leading tokens, so the engines' prefix cache keeps paying off
  fleet-wide (same prefix -> same replica -> ZERO prefill on repeats),
  with spill to the least-loaded healthy replica when the affinity
  target is saturated or down. Rendezvous hashing keeps the mapping
  stable when replicas join or leave — only keys owned by a dead
  replica move.
* **Fleet-wide load shedding.** When every healthy replica rejects, the
  router sheds with the SOONEST measured drain-rate retry-after among
  them (serving/queue.py's EWMA) — backpressure reflects when the fleet
  will actually have capacity.
* **Health + failover.** A pump thread heartbeats every replica
  (``fleet.health`` fault site) and drives the breaker contract:
  consecutive failures quarantine, cooldown probes re-admit. Transport
  loss or the ``replica.kill`` site mark a replica DEAD: its in-flight
  requests re-dispatch immediately and it leaves routing until revived
  (autoscale replacement or supervisor ``restart(rank)``).
* **Elasticity.** Occupancy/queue-depth-driven scale-up/scale-down via
  a replica factory. ``last_scaleup_traces`` records the new replica's
  ``trace_count()`` (always 0 in the eager port, which compiles
  nothing); ``last_scaleup_s`` the seconds the factory took to hand
  back a serving-ready replica.
* **Rolling deploys.** ``deploy()`` walks the fleet one replica at a
  time: quarantine from routing, steal the queued backlog for
  re-dispatch (deadlines intact), wait for in-flight slots to land,
  register the new (model, version), drain-retire the old. Unversioned
  traffic stays PINNED to the old version until every replica hosts the
  new one, then the pin flips — no request ever races the roll.

Locking: ONE router lock, lockdep class ``fleet.router``, at the TOP of
the declared hierarchy ``fleet.router -> serving.queue -> decode.tenant``
(reading a local replica's queue depth during routing nests the queue
lock under it; the decode engine supplies the lower edge). Transport
I/O (RPC, heartbeats, dispatch) always happens OUTSIDE the router lock.
"""

import hashlib
import logging
import threading
import time

from paddle_tpu_torch.observability import lockdep
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving.decode.pool import block_hashes, prompt_key
from paddle_tpu_torch.serving.fleet.metrics import FleetMetrics
from paddle_tpu_torch.serving.fleet.replica import ReplicaError
from paddle_tpu_torch.serving.request import (
    DeadlineExceededError,
    Priority,
    RejectedError,
    ReplicaLostError,
    Response,
)

__all__ = ["FleetRouter", "RoutedRequest"]

log = logging.getLogger("paddle_tpu_torch.serving.fleet.router")

# The router holds its lock while reading replica queue depths (routing)
# and while the pump commits failover state; the decode engine's
# scheduler supplies serving.queue -> decode.tenant below it. Declared
# so an inversion anywhere names the RULE.
lockdep.declare_order("fleet.router", "serving.queue", "decode.tenant")

_SHED_COLD_HINT_S = 0.05


class RoutedRequest:
    """One request the fleet has accepted. ``response`` is the ROUTER's
    write-once future — inner per-replica futures/tickets come and go
    across re-dispatches; this one is the only thing the caller sees."""

    __slots__ = ("id", "prompt", "max_new", "tenant", "priority",
                 "deadline_at", "model", "version", "response",
                 "submit_time", "attempts", "replica", "ticket", "state")

    def __init__(self, rid, prompt, max_new, tenant, priority, deadline_at,
                 model, version):
        self.id = rid
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.tenant = str(tenant)
        self.priority = priority
        self.deadline_at = deadline_at
        self.model = model
        self.version = version
        self.response = Response()
        self.submit_time = time.perf_counter()
        self.attempts = []       # replica ids, dispatch order
        self.replica = None      # current replica id (state == inflight)
        self.ticket = None       # current replica-side ticket
        self.state = "new"       # new -> inflight <-> parked -> done


class FleetRouter:
    _SEQ = 0

    def __init__(self, replica_factory=None, affinity_prefix=4,
                 saturation_rows=None, health_interval_s=0.05,
                 pump_interval_s=0.002, breaker_threshold=3,
                 breaker_cooldown_s=1.0, min_replicas=1, max_replicas=8,
                 autoscale=False, scale_up_rows_per_replica=16,
                 scale_down_idle_ticks=40, supervisor=None,
                 revive_factory=None, label=None):
        FleetRouter._SEQ += 1
        self.label = label or f"fleet-{FleetRouter._SEQ}"
        self._factory = replica_factory
        self._affinity_prefix = int(affinity_prefix)
        self._saturation_rows = saturation_rows
        self._health_interval_s = float(health_interval_s)
        self._pump_interval_s = float(pump_interval_s)
        self._breaker_threshold = breaker_threshold
        self._breaker_cooldown_s = breaker_cooldown_s
        self._min_replicas = int(min_replicas)
        self._max_replicas = int(max_replicas)
        self._autoscale = bool(autoscale)
        self._scale_up_rows = int(scale_up_rows_per_replica)
        self._scale_down_idle_ticks = int(scale_down_idle_ticks)
        self._lock = lockdep.named_lock("fleet.router", rlock=True)
        self._replicas = {}      # rid -> handle
        self._health = {}        # rid -> ReplicaHealth
        self._draining = set()   # rids quarantined from routing (deploy)
        self._inflight = {}      # routed id -> RoutedRequest (incl parked)
        self._pin = {}           # model name -> pinned default version
        self._default_name = None
        self._next_id = 0
        self._next_index = 0
        self._metrics = FleetMetrics(self.label)
        self._pump = None
        self._stop = False
        self._last_health = 0.0
        self._idle_ticks = 0
        self.last_scaleup_traces = None
        self.last_scaleup_s = None
        # router-initiated supervisor integration: a DEAD replica whose
        # rank a GangSupervisor owns is restarted INTO ITS OWN slot
        # (supervisor.restart(rank) + revive_factory(rid, index) ->
        # revive_replica) instead of being replaced by a scale-up
        self._supervisor = supervisor
        self._revive_factory = revive_factory
        self._revive_failed = set()   # rids: one attempt per death episode

    # -- replica set -------------------------------------------------------
    def add_replica(self, handle):
        """Adopt a serving-ready replica handle (any transport)."""
        from paddle_tpu_torch.serving.fleet.health import ReplicaHealth

        with self._lock:
            if handle.rid in self._replicas:
                raise ValueError(f"replica {handle.rid} already routed")
            self._replicas[handle.rid] = handle
            self._health[handle.rid] = ReplicaHealth(
                self._breaker_threshold, self._breaker_cooldown_s)
            self._next_index = max(self._next_index, handle.index + 1)
            for name, version in handle.models():
                if self._default_name is None:
                    self._default_name = name
                self._pin.setdefault(name, version)
        return handle

    def scale_up(self):
        """Grow the fleet by one factory-built replica. The factory
        returns a serving-ready handle; ``last_scaleup_s`` keeps the
        seconds it took and ``last_scaleup_traces`` its trace count."""
        if self._factory is None:
            raise RuntimeError("router has no replica factory")
        with self._lock:
            index = self._next_index
            self._next_index += 1
        t0 = time.perf_counter()
        handle = self._factory(index)
        self.last_scaleup_s = time.perf_counter() - t0
        self.add_replica(handle)
        self.last_scaleup_traces = handle.trace_count()
        self._metrics.incr("scale_ups")
        return handle

    def scale_down(self, rid=None, timeout=60.0):
        """Drain-before-retire one replica (default: the idlest): stop
        routing to it, steal its queued backlog for re-dispatch, wait
        for in-flight slots to land, then close it."""
        with self._lock:
            if rid is None:
                cands = self._routable()
                if len(cands) <= 1:
                    raise RuntimeError("nothing retirable: the fleet "
                                       "needs at least one replica")
                rid = min(cands, key=lambda r: (
                    self._replicas[r].load(), -self._replicas[r].index))
            handle = self._replicas[rid]
            self._draining.add(rid)
        try:
            self._steal_and_park(rid, handle)
            self._wait_inflight_drained(rid, timeout)
        except Exception:
            # drain failed: RE-ADMIT the replica instead of dropping it
            # with work still in flight (those requests would strand)
            with self._lock:
                self._draining.discard(rid)
            raise
        with self._lock:
            self._draining.discard(rid)
            self._replicas.pop(rid, None)
            self._health.pop(rid, None)
        handle.close()
        self._metrics.incr("scale_downs")
        return rid

    def revive_replica(self, handle):
        """Swap a fresh handle into a DEAD replica's slot (supervisor
        ``restart(rank)`` / manual relaunch): fresh breaker, back in the
        routing set."""
        with self._lock:
            old = self._replicas.get(handle.rid)
            health = self._health.get(handle.rid)
            if old is None or health is None:
                raise ValueError(f"no replica slot {handle.rid} to revive")
            self._replicas[handle.rid] = handle
            health.revive()
        self._metrics.incr("replicas_revived")
        return handle

    def replicas(self):
        with self._lock:
            return {rid: self._health[rid].state()
                    for rid in sorted(self._replicas)}

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._pump is not None:
            return self
        self._stop = False
        self._pump = threading.Thread(
            target=self._pump_loop, name=f"{self.label}-pump", daemon=True)
        self._pump.start()
        return self

    def shutdown(self, timeout=60.0):
        """Graceful: stop admitting, give in-flight work `timeout` to
        land (the pump keeps delivering), then complete anything still
        parked with a structured rejection (visible, never lost)."""
        with self._lock:
            self._stop = True
        if self._pump is not None:
            self._pump.join(timeout)
            self._pump = None
        self._drain_deadline(time.perf_counter() + timeout)
        with self._lock:
            leftovers = [rr for rr in self._inflight.values()
                         if not rr.response.done()]
            self._inflight.clear()
        for rr in leftovers:
            self._metrics.incr("drained_unserved")
            rr.response._complete(error=RejectedError(
                "fleet router shut down before this request was served",
                retry_after_s=0.0))
        with self._lock:
            handles = list(self._replicas.values())
        for h in handles:
            h.close(timeout)

    def _drain_deadline(self, deadline):
        while time.perf_counter() < deadline:
            self._tick()
            with self._lock:
                live = [rr for rr in self._inflight.values()
                        if not rr.response.done()]
                # nothing can make progress: every survivor is parked
                # and no replica is routable — stop burning the timeout
                stuck = (all(rr.state == "parked" for rr in live)
                         and not self._routable())
            if not live or stuck:
                return
            time.sleep(self._pump_interval_s)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- admission ---------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=16, tenant="default",
               priority=Priority.NORMAL, deadline_ms=None, model=None,
               version=None):
        """Accept one generation request into the fleet; returns the
        router-owned Response future. Raises RejectedError (with the
        fleet's soonest measured retry-after) when every healthy replica
        refuses — the request was never accepted. After acceptance the
        router owns delivery: replica death re-dispatches transparently
        under the original deadline."""
        self._metrics.incr("submitted")
        def bad(msg):
            self._metrics.incr("rejected_invalid")
            raise RejectedError(msg)

        try:
            prompt = [int(t) for t in prompt_ids]
        except (TypeError, ValueError):
            prompt = None
        if prompt is None:
            bad("prompt_ids must be a sequence of token ids")
        if not prompt:
            bad("empty prompt")
        if int(max_new_tokens) < 1:
            bad(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        deadline_at = (time.perf_counter() + deadline_ms / 1e3
                       if deadline_ms is not None else None)
        with self._lock:
            if self._stop:
                raise RejectedError("fleet router is draining",
                                    retry_after_s=0.0)
            if priority != Priority.HIGH:
                sevs = [self._health[r].severity for r in self._routable()]
                if sevs and min(sevs) >= 4:
                    # fleet-wide brownout L4: every routable replica is
                    # already shedding non-HIGH — turn it away at the
                    # router door instead of burning a dispatch sweep
                    self._metrics.incr("brownout_shed")
                    self._metrics.incr("rejected_shed")
                    raise RejectedError(
                        "fleet brownout: every routable replica is "
                        "shedding non-HIGH traffic",
                        retry_after_s=_SHED_COLD_HINT_S)
            self._next_id += 1
            rid = self._next_id
            if model is None:
                model = self._default_name
            if version is None and model is not None:
                version = self._pin.get(model)
        rr = RoutedRequest(rid, prompt, max_new_tokens, tenant,
                           priority, deadline_at, model, version)
        kind, err = self._try_dispatch(rr)
        if kind != "ok":
            self._metrics.incr("rejected_shed")
            raise err
        self._metrics.incr("accepted")
        return rr.response

    # -- routing -----------------------------------------------------------
    def _routable(self, exclude=()):
        """Caller holds the lock. Dead/quarantined/draining replicas are
        out; breaker half-open replicas are IN (probe traffic is the
        re-admission mechanism)."""
        return [rid for rid in sorted(self._replicas)
                if rid not in exclude and rid not in self._draining
                and self._health[rid].routable()]

    @staticmethod
    def _rendezvous_score(key, rid):
        return int.from_bytes(
            hashlib.sha256(f"{key}|{rid}".encode()).digest()[:8], "big")

    def _route(self, rr, exclude):
        """Caller holds the lock: affinity target by rendezvous hash of
        the prompt's leading KV BLOCK, spilled to least-loaded when the
        target is saturated. The affinity key is the chained block hash
        (`pool.block_hashes` with ``affinity_prefix`` as the block
        size) — the SAME digest family the paged engine's radix tree
        keys physical blocks by, so two prompts the router co-locates
        are exactly two prompts whose first block the replica can serve
        from shared storage (zero prefill AND zero extra rows). Prompts
        shorter than one block fall back to the whole-prompt hash. Load
        reads a local replica's queue depth — the witnessed
        ``fleet.router -> serving.queue`` edge."""
        cands = self._routable(exclude)
        if not cands:
            return None
        chain = block_hashes(rr.prompt, self._affinity_prefix)
        key = chain[0] if chain else prompt_key(rr.prompt)
        target = max(cands,
                     key=lambda rid: self._rendezvous_score(key, rid))
        sat = self._saturation_rows
        if sat is not None and self._replicas[target].load() >= sat:
            spill = min(cands, key=lambda rid: (
                self._replicas[rid].load(), rid))
            if self._replicas[spill].load() < self._replicas[target].load():
                target = spill
        # brownout bias: an affinity target at severity >= 3 gives way
        # to the least-browned-out (then least-loaded) candidate —
        # affinity saves prefill, but a capped replica costs more than
        # the prefill it saves
        if self._health[target].severity >= 3:
            calm = min(cands, key=lambda rid: (
                self._health[rid].severity, self._replicas[rid].load(), rid))
            if self._health[calm].severity < self._health[target].severity:
                target = calm
        return target

    def _try_dispatch(self, rr):
        """Route + dispatch with failover across replicas. Returns
        ("ok", None) once a replica admits; ("shed", RejectedError)
        when every routable replica refused but the refusals were
        RETRYABLE (backpressure, transport churn — worth re-trying
        later); ("dead_end", RejectedError) when every routable replica
        PERMANENTLY rejected (e.g. the requested (model, version) is
        retired fleet-wide — re-trying can never succeed). Dispatch I/O
        runs OUTSIDE the router lock."""
        tried = set()
        hints = []
        retryable = False
        while True:
            with self._lock:
                target = self._route(rr, tried)
                handle = self._replicas.get(target) if target else None
                probing = (target is not None
                           and self._health[target].probing())
            if target is None:
                hint = min(hints) if hints else _SHED_COLD_HINT_S
                err = RejectedError(
                    f"fleet saturated or unavailable "
                    f"({len(tried)} replicas refused); retry after "
                    f"{hint:.3f}s", retry_after_s=hint)
                kind = ("dead_end" if tried and not retryable
                        else "shed")
                return kind, err
            if probing:
                self._metrics.incr("breaker_probes")
            try:
                faults.fire("fleet.dispatch", rank=handle.index)
                ticket = handle.submit(
                    rr.prompt, rr.max_new, rr.tenant, rr.priority,
                    rr.deadline_at, model=rr.model, version=rr.version)
            except RejectedError as e:
                # a measured retry-after means backpressure (queue
                # full, quota): retryable. retry_after 0.0 means the
                # replica can NEVER serve this (unknown model/version,
                # invalid request) — if every replica says so, parking
                # is a busy-wait on the impossible.
                hints.append(e.retry_after_s)
                if e.retry_after_s > 0:
                    retryable = True
                tried.add(target)
                continue
            except Exception as e:
                # transport death / injected dispatch fault: the
                # replica, not the request, failed this attempt — the
                # replica set can change, so this stays retryable
                retryable = True
                tried.add(target)
                self._note_replica_failure(target, e, during="dispatch")
                continue
            with self._lock:
                was_parked = rr.state == "parked"
                rr.attempts.append(target)
                self._inflight[rr.id] = rr
                # the replica may have died between our submit landing
                # and this commit — _mark_dead's victim sweep has
                # already run, so an 'inflight' record on a dead
                # replica would never be swept again: park instead
                # (decode is deterministic, the re-dispatch is free)
                if self._health[target].dead:
                    rr.state = "parked"
                    rr.replica = rr.ticket = None
                else:
                    rr.replica, rr.ticket = target, ticket
                    rr.state = "inflight"
            self._note_replica_success(target)
            if was_parked:
                self._metrics.incr("rerouted")
            return "ok", None

    # -- health plumbing ---------------------------------------------------
    def _health_event(self, event):
        if event:
            self._metrics.incr(event)

    def _note_replica_success(self, rid):
        with self._lock:
            health = self._health.get(rid)
            event = health.note_success() if health else None
        self._health_event(event)

    def _note_replica_failure(self, rid, exc, during):
        self._metrics.incr("dispatch_faults" if during == "dispatch"
                           else "health_probe_failures")
        fatal = isinstance(exc, ReplicaError) and exc.fatal
        if fatal:
            self._mark_dead(rid, exc)
            return
        with self._lock:
            health = self._health.get(rid)
            event = health.note_failure() if health else None
        self._health_event(event)

    def _mark_dead(self, rid, reason):
        """A replica is GONE: latch dead, pull every in-flight routed
        request off it into the parked set — the pump re-dispatches them
        under their original deadlines. The victim sweep is idempotent
        and runs even when the replica was ALREADY dead: a dispatch
        that raced the first death can still commit an inflight record
        afterwards, and this is its only way back out."""
        with self._lock:
            health = self._health.get(rid)
            if health is None:
                return
            first = not health.dead
            if first:
                health.mark_dead(reason)
                # fresh death episode: the revive path gets one attempt
                self._revive_failed.discard(rid)
            for rr in self._inflight.values():
                if rr.replica == rid and rr.state == "inflight":
                    rr.state = "parked"
                    rr.replica = rr.ticket = None
        if first:
            self._metrics.incr("replica_deaths")

    def _maybe_revive(self):
        """Router-initiated supervisor integration: every DEAD replica
        whose rank a GangSupervisor owns is terminated+respawned INTO
        ITS ORIGINAL endpoint slot (``supervisor.restart(rank)`` — a
        structured ``rank_restart`` event and
        ``resilience_events_total{kind=rank_restart}``), then a fresh
        handle from ``revive_factory(rid, index)`` re-enters routing via
        ``revive_replica``. One attempt per death episode; a failed
        attempt leaves the slot dead for autoscale replacement. All
        process/transport I/O runs OUTSIDE the router lock."""
        if self._supervisor is None or self._revive_factory is None:
            return
        with self._lock:
            dead = [(rid, self._replicas[rid].index)
                    for rid in sorted(self._replicas)
                    if self._health[rid].dead
                    and rid not in self._revive_failed]
            for rid, _ in dead:
                self._revive_failed.add(rid)   # claimed; cleared on success
        for rid, index in dead:
            try:
                self._supervisor.restart(index)
                self._metrics.incr("supervisor_restarts")
                handle = self._revive_factory(rid, index)
                self.revive_replica(handle)
            except Exception:
                log.exception(
                    "supervisor restart of replica %s (rank %d) failed; "
                    "slot stays dead for autoscale replacement", rid, index)
                continue
            with self._lock:
                self._revive_failed.discard(rid)

    # -- the pump ----------------------------------------------------------
    def _pump_loop(self):
        while True:
            with self._lock:
                if self._stop:
                    return
            try:
                self._tick()
            except Exception:
                # the pump is the fleet's heartbeat: one bad tick
                # (factory failure, drain timeout) must not silently
                # kill delivery for every in-flight request
                log.exception("fleet pump tick failed; continuing")
            time.sleep(self._pump_interval_s)

    def _tick(self, now=None):
        """One pump iteration (also called directly by tests for a
        single-threaded deterministic pass): poll in-flight tickets, run
        the health pass when due, re-dispatch parked requests,
        autoscale."""
        now = now if now is not None else time.perf_counter()
        self._poll_inflight()
        if now - self._last_health >= self._health_interval_s:
            self._last_health = now
            self._health_pass()
        self._flush_parked(now)
        # restart-in-place runs BEFORE autoscale: a supervised rank
        # returns to its own endpoint slot instead of being replaced
        self._maybe_revive()
        self._maybe_scale()

    def _poll_inflight(self):
        with self._lock:
            by_replica = {}
            for rr in self._inflight.values():
                if rr.state == "inflight":
                    by_replica.setdefault(rr.replica, []).append(rr)
            handles = {rid: self._replicas.get(rid) for rid in by_replica}
        for rid, rrs in by_replica.items():
            handle = handles.get(rid)
            if handle is None:
                continue
            try:
                results = handle.poll_many([rr.ticket for rr in rrs])
            except Exception as e:
                self._note_replica_failure(rid, e, during="poll")
                continue
            for rr, res in zip(rrs, results):
                if res is None:
                    continue
                kind, payload = res
                if kind == "ok":
                    self._complete(rr, outputs=payload)
                else:
                    self._on_inner_error(rr, payload)

    def _on_inner_error(self, rr, err):
        """Classify a replica-side failure: replica-lost and mid-drain
        rejections re-dispatch (the REQUEST was fine); deadline and
        request-attributed failures deliver — retrying a poison request
        elsewhere just spreads it."""
        if isinstance(err, (ReplicaLostError, RejectedError)):
            self._park(rr)
        else:
            self._complete(rr, error=err)

    def _park(self, rr):
        with self._lock:
            if rr.response.done():
                return
            rr.state = "parked"
            rr.replica = rr.ticket = None

    def _complete(self, rr, outputs=None, error=None):
        with self._lock:
            if rr.response.done():
                return
            rr.state = "done"
            self._inflight.pop(rr.id, None)
        rr.response._complete(outputs=outputs, error=error)
        if error is None:
            self._metrics.incr("completed")
        elif isinstance(error, DeadlineExceededError):
            self._metrics.incr("deadline_missed")
        else:
            self._metrics.incr("failed")
        self._metrics.observe_latency(
            time.perf_counter() - rr.submit_time)

    @staticmethod
    def _severity_of(stats):
        """Max brownout severity across a replica's hosted entries (0
        when the stats carry no engine view — a subprocess handle's
        local stats report full service, not an error)."""
        try:
            models = stats.get("engine", {}).get("models", {})
            return max((int(ms.get("brownout_severity", 0) or 0)
                        for ms in models.values()), default=0)
        except Exception:
            return 0

    def _health_pass(self):
        with self._lock:
            items = [(rid, self._replicas[rid], self._health[rid])
                     for rid in sorted(self._replicas)]
        for rid, handle, health in items:
            if health.dead:
                continue
            try:
                faults.fire("fleet.health", rank=handle.index)
                handle.heartbeat()
            except Exception as e:
                self._note_replica_failure(rid, e, during="health")
                continue
            self._note_replica_success(rid)
            # sample brownout severity alongside the heartbeat (I/O
            # outside the lock, like every other RPC here): the router
            # biases dispatch away from browned-out replicas and sheds
            # fleet-wide when every routable one reports L4
            try:
                sev = self._severity_of(handle.stats())
            except Exception:
                sev = 0
            with self._lock:
                h = self._health.get(rid)
                if h is not None:
                    h.severity = sev
        with self._lock:
            self._metrics.set_healthy(len(self._routable()))

    def _flush_parked(self, now):
        with self._lock:
            parked = [rr for rr in self._inflight.values()
                      if rr.state == "parked"]
        for rr in parked:
            if rr.deadline_at is not None and now > rr.deadline_at:
                self._complete(rr, error=DeadlineExceededError(
                    "original deadline expired during re-dispatch "
                    f"(request {rr.id}, {len(rr.attempts)} attempts)"))
                continue
            kind, err = self._try_dispatch(rr)
            if kind == "dead_end":
                # every routable replica PERMANENTLY rejected (e.g. the
                # version was retired fleet-wide mid-failover): deliver
                # the structured rejection instead of re-trying forever
                self._complete(rr, error=err)
            # "shed" stays parked: backpressure clears, replicas revive

    # -- elasticity --------------------------------------------------------
    def _maybe_scale(self):
        if self._factory is None or not self._autoscale:
            return
        with self._lock:
            if self._stop:
                return
            routable = self._routable()
            total = len([h for rid, h in self._replicas.items()
                         if not self._health[rid].dead])
            queued = sum(self._replicas[rid].load() for rid in routable)
            inflight = sum(1 for rr in self._inflight.values()
                           if rr.state == "inflight")
        try:
            if (len(routable) < self._min_replicas
                    and total < self._max_replicas):
                self.scale_up()
                return
            if (routable and total < self._max_replicas
                    and queued > self._scale_up_rows * len(routable)):
                self.scale_up()
                return
        except Exception:
            # a factory failure is an event, not a pump death
            log.exception("autoscale scale-up failed; continuing")
            return
        if (len(routable) > self._min_replicas and queued == 0
                and inflight == 0):
            self._idle_ticks += 1
            if self._idle_ticks >= self._scale_down_idle_ticks:
                self._idle_ticks = 0
                try:
                    self.scale_down()
                except (RuntimeError, TimeoutError):
                    # nothing retirable / drain raced new traffic — the
                    # replica was re-admitted; try again when idle
                    pass
        else:
            self._idle_ticks = 0

    # -- rolling deploys ---------------------------------------------------
    def deploy(self, builder, version, name=None, timeout=120.0,
               worker_spec=None):
        """Roll (name, version) across the fleet with zero downtime, in
        two passes. Pass 1 makes every live replica HOST the new version
        while the old one keeps serving (unversioned traffic stays
        PINNED to the old version, so nothing races the roll — a
        mixed-version fleet is only reachable by explicit version):

        * local replicas register the builder in-place (the multi-tenant
          registry hosts both versions);
        * subprocess replicas deploy by WORKER REPLACEMENT — a builder
          closure cannot cross the process boundary, so the router
          spawns a replacement worker hosting old+new from
          ``worker_spec`` (the new version's decoder geometry kwargs),
          steals the old worker's queued backlog for re-dispatch
          (deadlines intact), waits for its in-flight slots to land,
          swaps the replacement into the same routing slot, and closes
          the old process.

        Once every replica hosts the new version the pin flips
        atomically; pass 2 then DRAIN-RETIRES the old version replica by
        replica (over the RPC wire for subprocess replicas) — queued and
        in-flight old-version generations finish before each entry
        leaves its registry. Explicit old-version requests after the
        flip fail over between replicas until the version is gone, then
        shed with a structured rejection."""
        with self._lock:
            name = name or self._default_name
            if name is None:
                raise RuntimeError("no model to deploy over")
            old_version = self._pin.get(name)
            rids = [rid for rid in sorted(self._replicas)
                    if not self._health[rid].dead]
            # precondition BEFORE any replica is mutated: a mixed fleet
            # missing worker_spec must fail with zero replicas touched
            # (a half-registered pass 1 cannot be retried — re-register
            # raises on the replicas that already host the version)
            if worker_spec is None and any(
                    hasattr(self._replicas[rid], "spawn_replacement")
                    for rid in rids):
                raise RuntimeError(
                    "fleet contains replicas that deploy by worker "
                    "replacement: deploy(..., worker_spec={decoder "
                    "geometry kwargs}) is required")
        version = str(version)
        for rid in rids:            # pass 1: host new, old keeps serving
            with self._lock:
                handle = self._replicas.get(rid)
                if handle is None or self._health[rid].dead:
                    continue
            if hasattr(handle, "spawn_replacement"):
                self._replace_replica(
                    rid, handle,
                    {**worker_spec, "name": name, "version": version},
                    timeout)
            else:
                handle.deploy(builder, name, version)
        with self._lock:
            self._pin[name] = version
        if old_version is not None and old_version != version:
            for rid in rids:        # pass 2: drain-before-retire the old
                with self._lock:
                    handle = self._replicas.get(rid)
                    if handle is None or self._health[rid].dead:
                        continue
                handle.retire(name, old_version, timeout=timeout)
        self._metrics.incr("deploys")
        return version

    def _replace_replica(self, rid, old, spec, timeout):
        """Swap a freshly spawned replacement worker into `rid`'s slot:
        spawn FIRST (the fleet never dips below strength), then
        quarantine the old worker from routing, steal its queued backlog
        (re-dispatched under original deadlines), wait for in-flight
        slots to land, commit the swap, close the old process. A spawn
        or drain failure re-admits the old worker untouched. All
        process/transport I/O runs OUTSIDE the router lock."""
        replacement = old.spawn_replacement(spec)
        with self._lock:
            self._draining.add(rid)
        try:
            self._steal_and_park(rid, old)
            self._wait_inflight_drained(rid, timeout)
        except Exception:
            with self._lock:
                self._draining.discard(rid)
            replacement.close()
            raise
        with self._lock:
            self._draining.discard(rid)
            self._replicas[rid] = replacement
            self._health[rid].revive()   # fresh process, fresh breaker
        old.close()
        self._metrics.incr("replaced_deploys")
        return replacement

    def _steal_and_park(self, rid, handle):
        try:
            stolen = set(handle.steal_queued())
        except ReplicaError as e:
            self._note_replica_failure(rid, e, during="steal")
            return
        if not stolen:
            return
        with self._lock:
            for rr in self._inflight.values():
                if (rr.state == "inflight" and rr.replica == rid
                        and rr.ticket in stolen):
                    rr.state = "parked"
                    rr.replica = rr.ticket = None
        self._metrics.incr("stolen_queued", len(stolen))

    def _wait_inflight_drained(self, rid, timeout):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                live = any(rr.state == "inflight" and rr.replica == rid
                           for rr in self._inflight.values())
            if not live:
                return
            # the pump keeps polling/delivering — unless the pump is
            # not running (hand-stepped tests) or this wait IS on the
            # pump thread (autoscale scale_down): then tick inline or
            # nothing would ever deliver the completions we wait on
            if (self._pump is None
                    or threading.current_thread() is self._pump):
                self._poll_inflight()
            time.sleep(self._pump_interval_s)
        raise TimeoutError(
            f"replica {rid} did not drain in-flight work in {timeout}s")

    # -- observability -----------------------------------------------------
    def stats(self):
        with self._lock:
            per_replica = {
                rid: {
                    "state": self._health[rid].state(),
                    "transport": self._replicas[rid].transport,
                    "load": self._replicas[rid].load(),
                    "deaths": self._health[rid].deaths,
                    "draining": rid in self._draining,
                    "severity": self._health[rid].severity,
                }
                for rid in sorted(self._replicas)
            }
            fleet_severity = max(
                (self._health[rid].severity for rid in self._routable()),
                default=0)
            inflight = sum(1 for rr in self._inflight.values()
                           if rr.state == "inflight")
            parked = sum(1 for rr in self._inflight.values()
                         if rr.state == "parked")
            pinned = dict(self._pin)
        return self._metrics.snapshot(extra={
            "replicas": per_replica,
            "inflight": inflight,
            "parked": parked,
            "pinned_versions": pinned,
            "fleet_severity": fleet_severity,
            "last_scaleup_traces": self.last_scaleup_traces,
            "last_scaleup_s": self.last_scaleup_s,
        })

    @property
    def metrics(self):
        return self._metrics
