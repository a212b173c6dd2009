"""Rate-limited logging on the metrics registry: the port's copy of the
JAX package's ``observability/logger.py`` (``get_logger`` and
``RateLimitedLogger``).

``RateLimitedLogger`` caps repetitive per-record messages (reader skips,
retry storms) at N pass-throughs, then stays silent until
``summarize()`` emits one aggregate line — bounded log volume with zero
information loss about the count. Every offered message bumps
``ratelimited_log_messages_total{logger=...}`` on the port's registry.

The JAX package's ``log_event`` also writes an instant event on its
tracer; the port has no tracer yet (ROADMAP M12), so ``log_event`` waits
for it.
"""

import logging
import threading

from paddle_tpu_torch.observability import metrics as _metrics

__all__ = ["get_logger", "RateLimitedLogger"]

_ROOT = "paddle_tpu_torch"


def get_logger(name=None):
    """Namespaced stdlib logger (``paddle_tpu_torch.<name>``)."""
    if name is None:
        return logging.getLogger(_ROOT)
    if name.startswith(_ROOT):
        return logging.getLogger(name)
    return logging.getLogger(f"{_ROOT}.{name}")


class RateLimitedLogger:
    """Pass through the first ``max_records`` messages, count the rest;
    ``summarize()`` reports totals. Each skipped-through or suppressed
    message also bumps a registry counter keyed by the logger name, so
    the rate of the underlying condition stays visible after the log
    goes quiet."""

    def __init__(self, name_or_logger, max_records=8, counter=None):
        self._log = (name_or_logger if isinstance(name_or_logger,
                                                  logging.Logger)
                     else get_logger(name_or_logger))
        self.max_records = int(max_records)
        self._lock = threading.Lock()
        self.emitted = 0
        self.suppressed = 0
        self._counter = counter or _metrics.registry().counter(
            "ratelimited_log_messages_total",
            "messages offered to a rate-limited logger",
            labels={"logger": self._log.name},
        )

    def _offer(self, level, msg, *args):
        self._counter.inc()
        with self._lock:
            if self.emitted < self.max_records:
                self.emitted += 1
                fire = True
                last = self.emitted == self.max_records
            else:
                self.suppressed += 1
                fire = last = False
        if fire:
            self._log.log(level, msg, *args)
            if last:
                self._log.log(
                    level,
                    "(rate limit reached after %d messages; further "
                    "occurrences will be counted and summarized)",
                    self.max_records,
                )

    def debug(self, msg, *args):
        self._offer(logging.DEBUG, msg, *args)

    def info(self, msg, *args):
        self._offer(logging.INFO, msg, *args)

    def warning(self, msg, *args):
        self._offer(logging.WARNING, msg, *args)

    def error(self, msg, *args):
        self._offer(logging.ERROR, msg, *args)

    @property
    def total(self):
        with self._lock:
            return self.emitted + self.suppressed

    def summarize(self, level=logging.WARNING, what="messages"):
        """Emit the aggregate line (only if anything was suppressed);
        resets nothing — callers may keep offering."""
        with self._lock:
            emitted, suppressed = self.emitted, self.suppressed
        if suppressed:
            self._log.log(
                level,
                "%d %s total (%d logged, %d suppressed by rate limit)",
                emitted + suppressed, what, emitted, suppressed,
            )
        return emitted + suppressed
