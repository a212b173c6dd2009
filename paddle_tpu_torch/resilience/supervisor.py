"""Supervised gang restarts: keep a job alive across worker death.

The port's copy of the JAX package's ``resilience/supervisor.py``, on
the port's ``distributed/launch.py`` (one process per rank) and
``incubate/checkpoint.newest_valid_checkpoint``.

A preemption or single-host failure kills the whole gang — the
reference's recovery story is checkpoint-based restart, and this module
is the piece that presses the restart button without a human: poll every
rank, and on the first nonzero exit or a heartbeat-declared hang,
terminate the gang, validate the checkpoint chain (quarantining corrupt
entries so workers resume from the newest VALID checkpoint), and
relaunch every worker — under a restart budget with backoff between
attempts. Every decision is recorded as a structured event
(``supervisor.events``), logged, and counted as
``resilience_events_total{kind=...}`` in the metrics registry. (The JAX
supervisor also writes each decision as a tracer instant and a profiler
counter; the port has neither module yet: ROADMAP.md, M12.)

Workers announce liveness by calling ``heartbeat_tick()`` once per step;
the supervisor injects ``PADDLE_RESILIENCE_HEARTBEAT_DIR`` so the helper
knows where to touch. Hang detection is opt-in via ``hang_timeout_s``.

    sup = GangSupervisor(["train.py"], nproc=4, max_restarts=2,
                         checkpoint_dirs=["/ckpt"], hang_timeout_s=300)
    codes = sup.run()   # [0, 0, 0, 0] or raises GangFailedError

Replica-grained restarts (serving fleets, not SPMD gangs): a training
gang is all-or-nothing — one dead rank wedges every collective, so
``run()`` restarts the WHOLE gang. A fleet of serving replicas is the
opposite: replicas share nothing, so killing the survivors to revive
one is an outage invented by the supervisor. ``launch()`` spawns the
gang without the watch loop and ``restart(rank)`` terminates +
respawns exactly ONE rank into the same endpoint slot (same
PADDLE_TRAINER_ID, same port), leaving the rest undisturbed — each
restart is a structured ``rank_restart`` event and a
``resilience_events_total{kind=rank_restart}`` counter, with per-rank
counts in ``rank_restarts``.
"""

import logging
import os
import tempfile
import time

from paddle_tpu_torch.observability import metrics as obs_metrics

__all__ = ["GangSupervisor", "GangFailedError", "heartbeat_tick",
           "HEARTBEAT_DIR_ENV"]

log = logging.getLogger("paddle_tpu_torch.resilience.supervisor")

HEARTBEAT_DIR_ENV = "PADDLE_RESILIENCE_HEARTBEAT_DIR"


def heartbeat_tick(rank=None, hb_dir=None):
    """Worker-side liveness tick (call once per training step). No-op
    when no supervisor injected a heartbeat dir — safe to leave in
    production training loops."""
    hb_dir = hb_dir or os.environ.get(HEARTBEAT_DIR_ENV)
    if not hb_dir:
        return False
    if rank is None:
        rank = os.environ.get("PADDLE_TRAINER_ID", "0")
    path = os.path.join(hb_dir, f"hb_{rank}")
    with open(path, "w") as f:
        f.write(str(time.time()))
    return True


class GangFailedError(RuntimeError):
    """The restart budget is exhausted; `events` holds the full timeline
    and `codes` the final gang exit codes."""

    def __init__(self, message, events=None, codes=None):
        super().__init__(message)
        self.events = events or []
        self.codes = codes


class GangSupervisor:
    def __init__(self, script_args, nproc=1, max_restarts=2,
                 restart_backoff_s=1.0, backoff_multiplier=2.0,
                 heartbeat_dir=None, hang_timeout_s=None,
                 poll_interval_s=0.1, grace_s=5.0, checkpoint_dirs=None,
                 on_restart=None, extra_env=None, started_port=None):
        self.script_args = list(script_args)
        self.nproc = int(nproc)
        self.max_restarts = int(max_restarts)
        self.restart_backoff_s = float(restart_backoff_s)
        self.backoff_multiplier = float(backoff_multiplier)
        self.hang_timeout_s = hang_timeout_s
        self.poll_interval_s = float(poll_interval_s)
        self.grace_s = float(grace_s)
        self.checkpoint_dirs = list(checkpoint_dirs or [])
        self.on_restart = on_restart  # fn(attempt, events) before relaunch
        self.extra_env = dict(extra_env or {})
        self.started_port = started_port
        if hang_timeout_s and not heartbeat_dir:
            heartbeat_dir = tempfile.mkdtemp(prefix="paddle_hb_")
        self.heartbeat_dir = heartbeat_dir
        self.events = []
        self.restarts = 0
        self.rank_restarts = {}   # rank -> replica-grained restart count
        self._procs = None
        self._spawn_port = None

    # -- events ----------------------------------------------------------
    def _emit(self, kind, **fields):
        ev = dict(kind=kind, time=time.time(), **fields)
        self.events.append(ev)
        obs_metrics.registry().counter(
            "resilience_events_total", "gang supervisor decisions",
            labels={"kind": kind},
        ).inc()
        log.warning("supervisor: %s %s", kind, fields)
        return ev

    # -- heartbeat -------------------------------------------------------
    def _clear_heartbeats(self):
        if not self.heartbeat_dir:
            return
        os.makedirs(self.heartbeat_dir, exist_ok=True)
        for f in os.listdir(self.heartbeat_dir):
            if f.startswith("hb_"):
                try:
                    os.remove(os.path.join(self.heartbeat_dir, f))
                except OSError:
                    pass

    def _stale_rank(self, attempt_start, codes):
        """Live rank whose last tick (or launch, if it never ticked) is
        older than hang_timeout_s, else None."""
        if not self.hang_timeout_s:
            return None, 0.0
        now = time.monotonic()
        wall_delta = time.time() - (now - attempt_start)  # wall at start
        for rank in range(self.nproc):
            if codes[rank] is not None:  # already exited cleanly
                continue
            path = os.path.join(self.heartbeat_dir, f"hb_{rank}")
            try:
                last_wall = os.path.getmtime(path)
            except OSError:
                last_wall = wall_delta
            age = time.time() - last_wall
            if age > self.hang_timeout_s:
                return rank, age
        return None, 0.0

    # -- checkpoint validation ------------------------------------------
    def _validate_checkpoints(self):
        """Quarantine corrupt/torn checkpoint entries so the relaunched
        workers resume from the newest VALID one; returns what each dir
        will resume from."""
        if not self.checkpoint_dirs:
            return {}
        from paddle_tpu_torch.incubate.checkpoint import (
            newest_valid_checkpoint,
        )

        resume = {}
        for d in self.checkpoint_dirs:
            try:
                resume[d] = newest_valid_checkpoint(d, quarantine=True)
            except OSError as e:
                resume[d] = None
                log.warning("checkpoint dir %s unreadable: %s", d, e)
        return resume

    # -- spawning --------------------------------------------------------
    def _gang_env(self):
        env = dict(self.extra_env)
        if self.heartbeat_dir:
            env[HEARTBEAT_DIR_ENV] = self.heartbeat_dir
        return env

    def launch(self, attempt=0):
        """Spawn the gang WITHOUT the watch/relaunch loop — the
        fleet-router usage: replicas are supervised individually via
        `restart(rank)` rather than gang-atomically. Returns the Popen
        list (also kept as `self._procs`)."""
        from paddle_tpu_torch.distributed.launch import _free_port, spawn_gang

        if self.heartbeat_dir:
            self._clear_heartbeats()
        if self._spawn_port is None:
            # pin the endpoint layout now so a respawned rank rejoins
            # the SAME slot later
            self._spawn_port = self.started_port or _free_port()
        self._procs = spawn_gang(
            self.script_args, nproc=self.nproc,
            started_port=self._spawn_port, extra_env=self._gang_env(),
        )
        self._emit("gang_start", attempt=attempt,
                   pids=[p.pid for p in self._procs])
        return self._procs

    def restart(self, rank):
        """Replica-grained restart: terminate + respawn exactly ONE
        rank into its original endpoint slot, leaving every other rank
        undisturbed. Clears only that rank's heartbeat, counts the
        restart per-rank, and emits a structured `rank_restart` event
        (counted in the metrics registry like every supervisor
        decision)."""
        from paddle_tpu_torch.distributed.launch import (
            spawn_gang,
            terminate_gang,
        )

        if self._procs is None:
            raise RuntimeError("no gang launched; call launch()/run() first")
        rank = int(rank)
        old = self._procs[rank]
        if old.poll() is None:
            terminate_gang([old], grace_s=self.grace_s)
        exit_code = old.poll()
        if self.heartbeat_dir:
            try:
                os.remove(os.path.join(self.heartbeat_dir, f"hb_{rank}"))
            except OSError:
                pass
        new = spawn_gang(
            self.script_args, nproc=self.nproc,
            started_port=self._spawn_port, extra_env=self._gang_env(),
            ranks=[rank],
        )[0]
        self._procs[rank] = new
        self.rank_restarts[rank] = self.rank_restarts.get(rank, 0) + 1
        self._emit("rank_restart", rank=rank, old_code=exit_code,
                   pid=new.pid, count=self.rank_restarts[rank])
        return new

    def procs(self):
        return list(self._procs or [])

    def terminate(self):
        """Stop every live rank (fleet shutdown path)."""
        from paddle_tpu_torch.distributed.launch import terminate_gang

        if self._procs:
            terminate_gang(self._procs, grace_s=self.grace_s)

    # -- the loop --------------------------------------------------------
    def run(self):
        from paddle_tpu_torch.distributed.launch import terminate_gang

        backoff = self.restart_backoff_s
        attempt = 0
        while True:
            attempt_start = time.monotonic()
            procs = self.launch(attempt=attempt)
            failure = self._watch(procs, attempt_start)
            if failure is None:
                codes = [p.poll() for p in procs]
                self._emit("gang_ok", attempt=attempt, codes=codes)
                return codes
            terminate_gang(procs, grace_s=self.grace_s)
            codes = [p.poll() for p in procs]
            attempt += 1
            if attempt > self.max_restarts:
                self._emit("gang_failed", attempt=attempt, codes=codes)
                raise GangFailedError(
                    f"gang failed after {self.max_restarts} restarts "
                    f"(last failure: {failure}); final codes {codes}",
                    events=self.events, codes=codes,
                )
            self.restarts = attempt
            if self.on_restart is not None:  # test hooks mutate state here
                self.on_restart(attempt, self.events)
            resume = self._validate_checkpoints()
            self._emit("restart", attempt=attempt, backoff_s=backoff,
                       resume_from=resume, failure=failure)
            if self.started_port is None:
                # whole-gang restart: take a FRESH port layout per
                # attempt (the crashed gang's listeners may sit in
                # TIME_WAIT). Pinning is only for replica-grained
                # restart(rank), which rejoins a LIVE gang's slots.
                self._spawn_port = None
            time.sleep(backoff)
            backoff *= self.backoff_multiplier

    def _watch(self, procs, attempt_start):
        """Poll until the gang succeeds (returns None) or fails (returns
        the failure event dict): first nonzero rank exit, or a
        heartbeat-declared hang."""
        while True:
            codes = [p.poll() for p in procs]
            for rank, c in enumerate(codes):
                if c is not None and c != 0:
                    return self._emit("rank_exit", rank=rank, code=c)
            if all(c == 0 for c in codes):
                return None
            rank, age = self._stale_rank(attempt_start, codes)
            if rank is not None:
                return self._emit("hang", rank=rank, age_s=round(age, 3))
            time.sleep(self.poll_interval_s)
