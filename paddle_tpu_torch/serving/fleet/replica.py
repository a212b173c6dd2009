"""Replica handles: one uniform surface over in-process and subprocess
decode replicas.

The port's copy of the JAX package's ``serving/fleet/replica.py``.

The router speaks to every replica through the same five verbs —
``submit`` (returns an opaque ticket), ``poll_many`` (tickets ->
finished results), ``heartbeat`` (liveness + load + trace counters),
``steal_queued`` (pull the admission backlog for re-dispatch), and
``deploy``/``close`` — so failover, affinity, and rolling-deploy logic
is transport-blind.

* ``LocalReplica`` wraps an in-process ``GenerationEngine``. Its tickets
  ARE the engine's Response futures. ``kill()`` simulates process death:
  the handle latches dead and refuses every verb with a fatal
  ``ReplicaError`` — exactly what the router observes when a real
  process vanishes (the abandoned engine self-drains in the background;
  nothing it produces is ever reported again). The ``replica.kill``
  fault site fires on every heartbeat, so a schedule entry
  ``{"site": "replica.kill", "action": "raise", "rank": <index>}``
  deterministically kills replica <index> at its next health probe.
* ``SubprocessReplica`` spawns ``python -m
  paddle_tpu_torch.serving.fleet.worker`` — a fresh interpreter (exec,
  never a fork of a process that may hold a CUDA context) with its own
  scope and engine on its own device — and speaks the length-prefixed
  JSON protocol of ``distributed/ps.py``'s framing, with
  ``resilience.retry`` guarding the connect path. A dropped connection
  is a FATAL ReplicaError — the process is gone; failover, not
  reconnection, is the recovery story.

Bit-exactness note: every replica built from the same model builder
materializes byte-identical weights (deterministic init from the startup
program's key stream) and the same programs, which is what makes
cross-replica re-dispatch invisible on one device type — the retried
answer is the same bytes the dead replica would have produced.
(The eager port compiles nothing, so ``trace_count()`` is always 0: a
scale-up replica pays only its startup.)
"""

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

from paddle_tpu_torch.distributed.ps import frame_recv, frame_send
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience.retry import RetryPolicy
from paddle_tpu_torch.serving.request import (
    DeadlineExceededError,
    RejectedError,
    ReplicaLostError,
    RequestError,
    ServingError,
)

__all__ = ["ReplicaError", "LocalReplica", "SubprocessReplica",
           "error_from_dict"]


class ReplicaError(RuntimeError):
    """The REPLICA (not the request) failed. ``fatal=True`` means the
    process/handle is gone for good (router marks it dead and re-routes
    its in-flight work); non-fatal means this attempt failed but the
    replica may recover (drives the breaker toward quarantine)."""

    def __init__(self, message, fatal=False):
        super().__init__(message)
        self.fatal = bool(fatal)


_ERROR_CLASSES = {
    "rejected": RejectedError,
    "deadline": DeadlineExceededError,
    "replica_lost": ReplicaLostError,
    "request_failed": RequestError,
}


def error_from_dict(d):
    """Rebuild a typed ServingError from its wire ``to_dict()`` form —
    the subprocess transport's errors classify identically to local
    ones (the router branches on class, never on prose)."""
    cls = _ERROR_CLASSES.get(d.get("code"), ServingError)
    if cls is RejectedError:
        return cls(d.get("message", ""),
                   retry_after_s=d.get("retry_after_s", 0.0))
    return cls(d.get("message", ""))


class LocalReplica:
    """In-process replica: a GenerationEngine behind the handle verbs."""

    transport = "local"

    def __init__(self, rid, index, engine):
        self.rid = str(rid)
        self.index = int(index)
        self.engine = engine
        self._dead = False

    @classmethod
    def create(cls, rid, index, builder, queue_depth=64,
               breaker_threshold=0, place=None):
        """Build a serving-ready replica: engine + model + scheduler, on
        ``place`` (default ``CUDAPlace(0)``; pass ``CPUPlace()`` for the
        CPU). The entry-level breaker
        defaults OFF — at fleet scope the ROUTER's breaker owns
        quarantine/probe (a replica relaunching itself underneath the
        router would double-count failures)."""
        from paddle_tpu_torch.serving.decode import GenerationEngine

        engine = GenerationEngine(
            place=place, queue_depth=queue_depth,
            breaker_threshold=breaker_threshold, label=f"fleet-{rid}",
        )
        engine.register_model(builder)
        engine.start()
        return cls(rid, index, engine)

    # -- verbs -------------------------------------------------------------
    def _check_alive(self):
        if self._dead:
            raise ReplicaError(f"replica {self.rid} is dead", fatal=True)

    def submit(self, prompt, max_new, tenant, priority, deadline_at,
               model=None, version=None):
        self._check_alive()
        return self.engine.submit(
            prompt, model=model, version=version, tenant=tenant,
            priority=priority, max_new_tokens=max_new,
            deadline_at=deadline_at,
        )

    def poll_many(self, tickets):
        """Ticket (= inner Response) -> None while pending, else
        ("ok", outputs) / ("error", ServingError)."""
        self._check_alive()
        out = []
        for resp in tickets:
            if not resp.done():
                out.append(None)
            elif resp.error() is not None:
                out.append(("error", resp.error()))
            else:
                out.append(("ok", resp.result()))
        return out

    def load(self):
        """Queued rows + active slots across hosted entries — the
        router's saturation/least-loaded signal. Reading the queue depth
        takes ``serving.queue`` under the caller's ``fleet.router`` lock:
        the witnessed top edge of the fleet hierarchy."""
        if self._dead:
            return float("inf")
        total = 0
        for key in self.engine.models():
            entry = self.engine.entry(*key)
            total += entry._queue.depth() + entry._pool.active_count
        return total

    def heartbeat(self):
        """Liveness probe. Fires the ``replica.kill`` fault site (rank =
        this replica's index): an injected fault here IS the simulated
        process death — the handle latches dead and the probe reports it
        fatally, like a worker that stopped answering."""
        self._check_alive()
        try:
            faults.fire("replica.kill", rank=self.index)
        except faults.InjectedFault as e:
            self.kill()
            raise ReplicaError(
                f"replica {self.rid} killed by fault injection: {e}",
                fatal=True) from e
        return {
            "ok": True,
            "load": self.load(),
            "models": ["@".join(k) for k in self.engine.models()],
            "trace": self.trace_count(),
        }

    def steal_queued(self):
        """Remove every queued (not yet prefilled) request; returns
        their tickets so the router can re-dispatch the matching routed
        requests elsewhere. In-flight slots are untouched."""
        self._check_alive()
        stolen = []
        for key in list(self.engine.models()):
            for r in self.engine.reroute_queued(*key):
                stolen.append(r.response)
        return stolen

    def deploy(self, builder, name, new_version):
        """Register the new (name, version) alongside the old one — the
        multi-tenant registry serves both until the router retires the
        old version (rolling-deploy pass 1)."""
        self._check_alive()
        self.engine.register_model(builder)

    def retire(self, name, version, timeout=120.0):
        """Drain-before-retire one hosted version (rolling-deploy pass
        2): queued + in-flight generations of that version finish, then
        the entry leaves the registry."""
        self._check_alive()
        self.engine.unregister_model(name, version, timeout=timeout)

    def trace_count(self):
        """Program traces paid by this replica's entries: always 0, as
        the eager port compiles no executable (the JAX replica counts
        its XLA traces here)."""
        return 0

    def models(self):
        return list(self.engine.models())

    def stats(self):
        return {"dead": self._dead, "engine": self.engine.stats()}

    # -- lifecycle ---------------------------------------------------------
    def kill(self):
        """Simulated hard death. The engine object is abandoned exactly
        like a crashed process: its daemon threads drain what they hold,
        but this handle never reports anything from it again."""
        if self._dead:
            return
        self._dead = True
        for key in list(self.engine.models()):
            entry = self.engine.entry(*key)
            entry._queue.close()
            with entry._cond:
                entry._stop = True
                entry._cond.notify_all()

    def close(self, timeout=60.0):
        if not self._dead:
            self.engine.shutdown(timeout)
            self._dead = True


class SubprocessReplica:
    """A decode replica in its own PROCESS, spoken to over a length-
    prefixed JSON socket (the PS wire framing). The worker is
    ``python -m paddle_tpu_torch.serving.fleet.worker``; ``device``
    (``"cuda"``, the default, or ``"cpu"``) goes on its command line, and
    its env may carry a ``PADDLE_TPU_FAULTS``
    schedule — the worker fires the ``replica.kill`` site on every RPC it
    serves, so a schedule with ``action: "kill"`` hard-exits the process
    mid-service. ``ready_s`` is the seconds from spawn to the worker's
    READY line."""

    transport = "subprocess"

    _CONNECT_RETRY = RetryPolicy(max_attempts=40, base_delay_s=0.1,
                                 max_delay_s=1.0, deadline_s=240.0)

    def __init__(self, rid, index, proc, sock, meta, specs=None,
                 extra_env=None, device="cuda", ready_s=None):
        self.rid = str(rid)
        self.index = int(index)
        self.proc = proc
        self._sock = sock
        self._sock_lock = threading.Lock()
        self._dead = False
        self._meta = dict(meta)
        self._last_load = 0
        # remembered spawn inputs: what a REPLACEMENT worker must host
        # (rolling deploys add the new version's spec on top)
        self._specs = [dict(s) for s in (specs or [])]
        self._extra_env = dict(extra_env or {})
        self.device = str(device)
        self.ready_s = ready_s

    @classmethod
    def spawn(cls, rid, index, model_args, extra_env=None,
              startup_timeout=240.0, device="cuda"):
        """Spawn + handshake: the worker prints one READY line naming
        its port and models, then serves RPCs. Connect rides the shared
        RetryPolicy. ``model_args`` is one spec dict or a list of spec
        dicts — each a (name, version) decoder geometry
        (``build_decoder_model``'s keyword arguments) the worker hosts.
        A worker that cannot reach ``device`` exits before READY."""
        t_spawn = time.perf_counter()
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (repo, env.get("PYTHONPATH")) if p)
        env.update(extra_env or {})
        specs = (list(model_args) if isinstance(model_args, (list, tuple))
                 else [model_args])
        cmd = [sys.executable, "-m", "paddle_tpu_torch.serving.fleet.worker",
               "--index", str(index), "--device", str(device)]
        for spec in specs:
            cmd += ["--model-spec", json.dumps(spec)]
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                text=True)
        deadline = time.monotonic() + startup_timeout
        meta = None
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                # stdout closes during the interpreter's shutdown, before
                # the process is reaped: wait for the exit code
                try:
                    code = proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    code = None
                raise ReplicaError(
                    f"replica {rid} worker exited during startup "
                    f"(code {code})", fatal=True)
            if line.startswith("FLEET_WORKER_READY "):
                meta = json.loads(line[len("FLEET_WORKER_READY "):])
                break
        if meta is None:
            proc.kill()
            proc.wait()
            raise ReplicaError(f"replica {rid} never became ready",
                               fatal=True)
        ready_s = time.perf_counter() - t_spawn

        def connect():
            s = socket.create_connection(("127.0.0.1", meta["port"]),
                                         timeout=60)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return s

        try:
            sock = cls._CONNECT_RETRY.call(connect)
        except Exception:
            proc.kill()
            proc.wait()
            raise
        return cls(rid, index, proc, sock, meta, specs=specs,
                   extra_env=extra_env, device=device, ready_s=ready_s)

    # -- wire --------------------------------------------------------------
    def _rpc(self, obj, timeout=None):
        """One request/response over the framed socket. ``timeout``
        temporarily widens the socket timeout for RPCs whose server-side
        work legitimately blocks (retire drains a whole version) — the
        default 60s connect timeout would otherwise trip mid-drain and
        mark a healthy worker dead."""
        if self._dead:
            raise ReplicaError(f"replica {self.rid} is dead", fatal=True)
        body = json.dumps(obj).encode()
        try:
            with self._sock_lock:
                old_to = self._sock.gettimeout()
                if timeout is not None:
                    self._sock.settimeout(timeout)
                try:
                    frame_send(self._sock, body)
                    resp = frame_recv(self._sock)
                finally:
                    if timeout is not None:
                        self._sock.settimeout(old_to)
        except (ConnectionError, OSError, struct.error) as e:
            self._dead = True
            raise ReplicaError(
                f"replica {self.rid} transport lost: {e}", fatal=True
            ) from e
        return json.loads(resp.decode())

    # -- verbs -------------------------------------------------------------
    def submit(self, prompt, max_new, tenant, priority, deadline_at,
               model=None, version=None):
        budget_ms = (max(deadline_at - time.perf_counter(), 0.0) * 1e3
                     if deadline_at is not None else None)
        resp = self._rpc({
            "cmd": "submit", "prompt": list(prompt), "max_new": int(max_new),
            "tenant": tenant, "priority": int(priority),
            "deadline_budget_ms": budget_ms, "model": model,
            "version": version,
        })
        if not resp.get("ok"):
            raise error_from_dict(resp["error"])
        return int(resp["ticket"])

    def poll_many(self, tickets):
        resp = self._rpc({"cmd": "poll", "tickets": list(tickets)})
        done = resp.get("done", {})
        out = []
        for t in tickets:
            r = done.get(str(t))
            if r is None:
                out.append(None)
            elif "error" in r:
                out.append(("error", error_from_dict(r["error"])))
            else:
                out.append(("ok", {"tokens": r["tokens"]}))
        return out

    def load(self):
        """Last heartbeat's load (a live RPC per routing decision would
        put the transport inside the router lock — cached instead)."""
        return float("inf") if self._dead else self._last_load

    def heartbeat(self):
        resp = self._rpc({"cmd": "ping"})
        self._last_load = resp.get("load", 0)
        return resp

    def steal_queued(self):
        resp = self._rpc({"cmd": "steal"})
        return [int(t) for t in resp.get("tickets", [])]

    def deploy(self, builder, name, new_version):
        raise ReplicaError(
            "subprocess replicas deploy by replacement (spawn a worker "
            "hosting the new version, drain + retire this one) — the "
            "router's deploy(worker_spec=...) drives spawn_replacement()"
            ", not in-place registration")

    def spawn_replacement(self, new_spec, startup_timeout=240.0):
        """Rolling-deploy pass 1 for the subprocess transport: spawn a
        fresh worker into THIS replica's slot (same rid/index, same env)
        hosting every spec this worker hosts PLUS ``new_spec`` — the old
        version keeps serving on the replacement until the router's pin
        flips and pass 2 retires it over the wire."""
        return SubprocessReplica.spawn(
            self.rid, self.index, self._specs + [dict(new_spec)],
            extra_env=self._extra_env, startup_timeout=startup_timeout,
            device=self.device)

    def retire(self, name, version, timeout=120.0):
        """Drain-before-retire one hosted version over the RPC wire
        (registry unregistration crosses processes fine; only builder
        closures cannot)."""
        resp = self._rpc({"cmd": "retire", "name": name,
                          "version": str(version), "timeout": timeout},
                         timeout=timeout + 30.0)
        if not resp.get("ok"):
            raise ReplicaError(
                f"replica {self.rid} retire({name}@{version}) failed: "
                f"{resp.get('error', {}).get('message')}")
        self._meta["models"] = resp.get("models",
                                        self._meta.get("models", []))
        self._specs = [s for s in self._specs
                       if not (s.get("name") == name
                               and str(s.get("version")) == str(version))]

    def trace_count(self):
        return int(self._meta.get("trace", -1))

    def models(self):
        return [tuple(m.split("@", 1)) for m in self._meta.get("models", [])]

    def stats(self):
        """The handle's own view (no RPC: the router's health pass reads
        this on every tick)."""
        return {"dead": self._dead, "meta": dict(self._meta),
                "load": self._last_load}

    def worker_stats(self):
        """The worker's ``stats`` RPC: its hosted entries' step counts
        and step seconds, and its process's kernel launch counters
        (``kernel_launches``: counters are per process, so the fleet's
        launches are read from each worker). Fires the worker's
        ``replica.kill`` site like every RPC."""
        resp = self._rpc({"cmd": "stats"})
        if not resp.get("ok"):
            raise ReplicaError(
                f"replica {self.rid} stats failed: "
                f"{resp.get('error', {}).get('message')}")
        return resp

    # -- lifecycle ---------------------------------------------------------
    def kill(self):
        """Hard-kill the worker process (chaos lever; the schedule-driven
        path is the worker-side ``replica.kill`` fault site)."""
        self._dead = True
        if self.proc.poll() is None:
            self.proc.kill()

    def close(self, timeout=60.0):
        if not self._dead:
            try:
                self._rpc({"cmd": "stop"})
            except ReplicaError:
                pass
            self._dead = True
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
        try:
            self._sock.close()
        except OSError:
            pass
