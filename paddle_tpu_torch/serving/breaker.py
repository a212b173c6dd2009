"""The per-replica circuit breaker: the port's copy of the JAX package's
``_ReplicaBreaker`` (``serving/engine.py``), driven by the decode
engine's batch-level outcomes (a decode step, a chunk or an inject that
fails loses the arena; a successful step closes a half-open breaker)."""

import time

from paddle_tpu_torch.observability import lockdep

__all__ = ["ReplicaBreaker"]


class ReplicaBreaker:
    """Per-replica circuit breaker: closed -> (K consecutive batch
    failures) -> open -> (cooldown) -> half_open probe -> closed on
    success / open again on failure. Only batch-level outcomes drive it;
    per-request isolation failures are attributed to the request, not
    the replica."""

    def __init__(self, threshold, cooldown_s):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.state = "closed"
        self.consecutive = 0
        self.opened_at = None
        self._lock = lockdep.named_lock("serving.breaker")

    def gate(self):
        """Dispatch decision: ('dispatch' | 'probe' | 'wait', wait_s)."""
        with self._lock:
            if self.state == "closed":
                return "dispatch", 0.0
            if self.state == "half_open":
                return "probe", 0.0
            remaining = self.cooldown_s - (time.perf_counter() - self.opened_at)
            if remaining > 0:
                return "wait", remaining
            self.state = "half_open"
            return "probe", 0.0

    def record_failure(self):
        with self._lock:
            self.consecutive += 1
            if self.state == "half_open":
                self.state = "open"
                self.opened_at = time.perf_counter()
                return "breaker_reopened"
            if self.state == "closed" and self.consecutive >= self.threshold:
                self.state = "open"
                self.opened_at = time.perf_counter()
                return "breaker_opened"
            return None

    def record_success(self):
        with self._lock:
            self.consecutive = 0
            if self.state == "half_open":
                self.state = "closed"
                self.opened_at = None
                return "breaker_closed"
            return None
