"""Shared retry policy: capped exponential backoff with jitter + deadline,
the port's copy of the JAX package's ``resilience/retry.py``.

One policy object serves every hardened IO path — the embedding engine's
host-tier pulls/pushes and checkpoint file IO — so retry behavior
is tuned (and fault-injection-tested) in one place instead of ad-hoc
sleep loops. Jitter is drawn from a per-policy seeded RNG: under the
deterministic fault harness a replayed schedule sees identical backoff
sequences (`PADDLE_TPU_RETRY_SEED` pins it globally for chaos runs).

    policy = RetryPolicy(max_attempts=4, base_delay_s=0.05, deadline_s=10)
    rows = policy.call(client.pull_sparse, table, ids, dim)

Retries ConnectionError/TimeoutError/OSError and the fault harness's
TransientFault by default; everything else propagates immediately.
`on_retry` lets callers repair state between attempts (a client can
reconnect there).
"""

import logging
import os
import random
import threading
import time

from paddle_tpu_torch.resilience.faults import TransientFault

__all__ = ["RetryPolicy", "DEFAULT_RETRYABLE"]

log = logging.getLogger("paddle_tpu_torch.resilience.retry")

DEFAULT_RETRYABLE = (ConnectionError, TimeoutError, OSError, TransientFault)


class RetryPolicy:
    """Immutable backoff schedule + the `call` driver.

    max_attempts  total tries (1 = no retry).
    base_delay_s  first backoff; doubles each retry, capped at max_delay_s.
    jitter        fraction of the delay drawn uniformly at random and
                  added (0.5 -> delay * [1.0, 1.5)).
    deadline_s    wall-clock budget across ALL attempts; when the budget
                  is exhausted the last error is raised even if attempts
                  remain.
    retry_on      exception classes worth retrying.
    """

    def __init__(self, max_attempts=4, base_delay_s=0.05, max_delay_s=2.0,
                 jitter=0.5, deadline_s=None, retry_on=DEFAULT_RETRYABLE,
                 seed=None, sleep=time.sleep):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self.deadline_s = deadline_s
        self.retry_on = tuple(retry_on)
        if seed is None:
            env = os.environ.get("PADDLE_TPU_RETRY_SEED")
            seed = int(env) if env else None
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self._sleep = sleep

    def delay(self, attempt):
        """Backoff before retry number `attempt` (1-based), jittered."""
        d = min(self.base_delay_s * (2 ** (attempt - 1)), self.max_delay_s)
        if self.jitter:
            with self._rng_lock:
                d *= 1.0 + self.jitter * self._rng.random()
        return d

    def call(self, fn, *args, retry_on=None, on_retry=None, **kwargs):
        """Run fn(*args, **kwargs) under the policy; returns its value or
        raises the final error. `on_retry(exc, attempt)` runs before each
        retry (reconnect hooks); its own errors abort the retry loop."""
        retry_on = tuple(retry_on) if retry_on is not None else self.retry_on
        start = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except retry_on as e:
                if attempt >= self.max_attempts:
                    raise
                d = self.delay(attempt)
                if (self.deadline_s is not None
                        and time.monotonic() - start + d > self.deadline_s):
                    log.warning(
                        "retry deadline (%.2fs) exhausted after %d attempts: %s",
                        self.deadline_s, attempt, e,
                    )
                    raise
                log.warning(
                    "attempt %d/%d failed (%s: %s); retrying in %.3fs",
                    attempt, self.max_attempts, type(e).__name__, e, d,
                )
                if on_retry is not None:
                    on_retry(e, attempt)
                self._sleep(d)

    def wrap(self, fn, on_retry=None):
        """Decorator form of call()."""

        def wrapped(*args, **kwargs):
            return self.call(fn, *args, on_retry=on_retry, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped
