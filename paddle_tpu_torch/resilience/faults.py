"""Deterministic fault injection: the port's copy of the JAX package's
``resilience/faults.py``, with the same schedule format, so a failure
timeline written for one package replays in the other.

Instrumented call sites (``faults.fire(site, ...)``) are inert when no
schedule is configured: the fast path is one global None-check. The
injector is process-global and this package's own: a schedule configured
here does not reach the JAX package's sites, nor the reverse.

Schedule format (``PADDLE_TPU_FAULTS`` env var — a JSON list, or
``@/path/to/plan.json``), or ``configure(spec)``:

    [{"site": "decode.step", "action": "raise", "times": 3},
     {"site": "decode.spill", "action": "stall", "delay_s": 0.2}]

Rule fields: ``site`` (required); ``action`` in kill | term | raise |
stall | corrupt | truncate (default raise); ``at_step`` / ``at_call``
(1-based nth matching call) / ``rank`` / ``prob`` (+ ``seed``) select
WHEN it fires; ``times`` bounds how often (default 1, -1 = unlimited);
``exc`` = "transient" (``TransientFault``, the default) or "fault";
``path`` overrides the file target for corrupt/truncate; ``delay_s``,
``exit_code``, ``id`` as expected. With a ``state_dir``
(``PADDLE_TPU_FAULT_STATE``), one-shot rules record firing in a marker
file so a restarted process replaying the same steps does not re-fire
them.

The decode engine's sites (``serving/decode/engine.py``), where the JAX
engine fires them:

* ``decode.step`` / ``decode.prefill`` / ``decode.chunk`` /
  ``decode.inject`` — before each decode step, whole-prompt prefill,
  prefill chunk and prompt KV inject. ``raise`` at a step, chunk or
  inject exercises the arena-loss path (every in-flight request
  rejected, the arena rebuilt, the circuit breaker driven); at a
  prefill it fails only the admitting request.
* ``decode.verify`` — before each speculative verify forward (a
  stateless prefill: ``raise`` fails that request only).
* ``decode.sample`` — before each sampled token draw (host arithmetic:
  use ``stall``).
* ``decode.spill`` / ``decode.resume`` — when the scheduler parks a
  session to the host tier and when it resumes one.
"""

import json
import logging
import os
import random
import threading
import time

__all__ = [
    "InjectedFault",
    "TransientFault",
    "FaultInjector",
    "configure",
    "reset",
    "get_injector",
    "fire",
    "corrupt_file",
    "FAULTS_ENV",
    "STATE_ENV",
]

log = logging.getLogger("paddle_tpu_torch.resilience.faults")

FAULTS_ENV = "PADDLE_TPU_FAULTS"
STATE_ENV = "PADDLE_TPU_FAULT_STATE"


class InjectedFault(RuntimeError):
    """An error raised by the fault harness (never by real code)."""


class TransientFault(InjectedFault):
    """A retryable injected error — retry.RetryPolicy retries these by
    default, so schedules can distinguish 'flaky' from 'broken'."""


def corrupt_file(path, mode="flip", offset=None, nbytes=16, truncate_to=None):
    """Deterministically damage a file in place.

    mode="flip"     XOR-flips `nbytes` bytes at `offset` (default: the
                    middle of the file — past any format magic, inside
                    real payload).
    mode="truncate" cuts the file to `truncate_to` bytes (default: half).
    Returns the number of bytes damaged/removed.
    """
    size = os.path.getsize(path)
    if mode == "truncate":
        keep = truncate_to if truncate_to is not None else size // 2
        with open(path, "r+b") as f:
            f.truncate(keep)
        return size - keep
    if mode != "flip":
        raise ValueError(f"unknown corruption mode {mode!r}")
    if size == 0:
        return 0
    off = offset if offset is not None else size // 2
    off = max(0, min(off, size - 1))
    n = min(nbytes, size - off)
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = f.read(n)
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))
    return n


class _Rule:
    _FIELDS = ("site", "action", "at_step", "at_call", "rank", "prob",
               "seed", "times", "exc", "path", "delay_s", "exit_code",
               "id", "mode")

    def __init__(self, spec, index):
        unknown = set(spec) - set(self._FIELDS)
        if unknown:
            raise ValueError(f"fault rule has unknown fields {sorted(unknown)}")
        if "site" not in spec:
            raise ValueError("fault rule needs a 'site'")
        self.site = spec["site"]
        self.action = spec.get("action", "raise")
        if self.action not in ("kill", "term", "raise", "stall", "corrupt",
                               "truncate"):
            raise ValueError(f"unknown fault action {self.action!r}")
        self.at_step = spec.get("at_step")
        self.at_call = spec.get("at_call")
        self.rank = spec.get("rank")
        self.prob = spec.get("prob")
        self.times = int(spec.get("times", 1))
        self.exc = spec.get("exc", "transient")
        self.path = spec.get("path")
        self.delay_s = float(spec.get("delay_s", 0.1))
        self.exit_code = int(spec.get("exit_code", 43))
        self.mode = spec.get("mode", "flip")
        self.id = spec.get("id") or f"{self.site}:{index}"
        self._rng = random.Random(spec.get("seed", 0))
        self.calls = 0
        self.fired = 0


class FaultInjector:
    """One parsed schedule; thread-safe; process-global via configure()."""

    def __init__(self, rules, state_dir=None):
        if isinstance(rules, (str, bytes)):
            rules = json.loads(rules)
        self._rules = [
            r if isinstance(r, _Rule) else _Rule(r, i)
            for i, r in enumerate(rules)
        ]
        self._sites = {r.site for r in self._rules}
        self._state_dir = state_dir
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)
        # rule-matching happens under the lock; _act (sleep / kill /
        # corrupt) runs OUTSIDE it, keeping this a leaf
        self._lock = threading.Lock()

    # -- cross-process one-shot state (times=1 rules only: a multi-fire
    # rule is meant to keep firing after a restart) ----------------------
    def _already_fired(self, rule):
        if not self._state_dir or rule.times != 1:
            return False
        return os.path.exists(os.path.join(self._state_dir, rule.id + ".fired"))

    def _mark_fired(self, rule):
        if self._state_dir and rule.times == 1:
            marker = os.path.join(self._state_dir, rule.id + ".fired")
            with open(marker, "w") as f:
                f.write(str(time.time()))
                f.flush()
                os.fsync(f.fileno())

    # -- the instrumented entry point -----------------------------------
    def fire(self, site, step=None, path=None, rank=None):
        """Evaluate every matching rule; act on the first that triggers.
        Called from instrumented sites; cheap when the site has no rules."""
        if site not in self._sites:
            return
        if rank is None:
            rank = os.environ.get("PADDLE_TRAINER_ID")
        with self._lock:
            rule = self._match(site, step, rank)
            if rule is None:
                return
            rule.fired += 1
            self._mark_fired(rule)
        self._act(rule, site, step, path)

    def _match(self, site, step, rank):
        site_rules = [r for r in self._rules if r.site == site]
        # every site call counts against EVERY rule's at_call counter —
        # an earlier rule firing must not hide the call from later rules
        # (the written schedule IS the replayed timeline)
        for rule in site_rules:
            rule.calls += 1
        for rule in site_rules:
            if rule.times >= 0 and rule.fired >= rule.times:
                continue
            if rule.rank is not None and (
                rank is None or int(rank) != int(rule.rank)
            ):
                continue
            if rule.at_step is not None and step != rule.at_step:
                continue
            if rule.at_call is not None and rule.calls != rule.at_call:
                continue
            if rule.prob is not None and rule._rng.random() >= rule.prob:
                continue
            if self._already_fired(rule):
                continue
            return rule
        return None

    def _act(self, rule, site, step, path):
        log.warning(
            "FAULT %s at site=%s step=%s (rule %s)",
            rule.action, site, step, rule.id,
        )
        if rule.action == "kill":
            # simulate a hard crash: no atexit handlers, no flushes
            os._exit(rule.exit_code)
        if rule.action == "term":
            # preemption: SIGTERM to self — the polite, CATCHABLE
            # signal (a worker with a handler can land its in-flight
            # durable state first; unhandled it terminates with code
            # -SIGTERM). Contrast "kill" = os._exit: uncatchable-shaped,
            # can leave torn files.
            import signal

            os.kill(os.getpid(), signal.SIGTERM)
            # delivery is asynchronous; hold here so the "preempted"
            # worker never races past the site
            time.sleep(rule.delay_s)
            return
        if rule.action == "stall":
            time.sleep(rule.delay_s)
            return
        if rule.action in ("corrupt", "truncate"):
            target = rule.path or path
            if target and os.path.exists(target):
                corrupt_file(
                    target,
                    mode="truncate" if rule.action == "truncate" else rule.mode,
                )
            return
        msg = f"injected fault at {site} (rule {rule.id}, step {step})"
        if rule.exc == "transient":
            raise TransientFault(msg)
        raise InjectedFault(msg)

    def rule_stats(self):
        with self._lock:
            return {r.id: {"calls": r.calls, "fired": r.fired}
                    for r in self._rules}


_injector = None
_env_checked = False
_glock = threading.Lock()


def configure(spec, state_dir=None):
    """Install a process-global schedule. `spec` is a JSON string or a
    list of rule dicts; state_dir enables cross-process one-shot rules."""
    global _injector, _env_checked
    inj = FaultInjector(spec, state_dir=state_dir
                        or os.environ.get(STATE_ENV) or None)
    with _glock:
        _injector = inj
        _env_checked = True
    return inj


def reset():
    global _injector, _env_checked
    with _glock:
        _injector = None
        _env_checked = False


def get_injector():
    """The active injector, lazily parsing the env schedule; None when no
    faults are configured."""
    global _injector, _env_checked
    if _env_checked:
        return _injector
    with _glock:
        if not _env_checked:
            spec = os.environ.get(FAULTS_ENV)
            if spec:
                if spec.startswith("@"):
                    with open(spec[1:]) as f:
                        spec = f.read()
                _injector = FaultInjector(
                    spec, state_dir=os.environ.get(STATE_ENV) or None
                )
            _env_checked = True
    return _injector


def fire(site, step=None, path=None, rank=None):
    """The one-line instrumentation hook. Near-zero cost when inert."""
    inj = get_injector()
    if inj is not None:
        inj.fire(site, step=step, path=path, rank=rank)
