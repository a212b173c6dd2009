"""Background periodic fetchers for long-running loops.

``FetchHandlerMonitor`` is the reference's FetchHandlerMonitor analog
(reference: python/paddle/fluid/executor.py:406, trainer_factory.py):
a daemon thread that wakes every ``handler.period_secs`` and delivers the
most recent fetched values to the handler — decoupled from step cadence,
so a slow dataset epoch still reports on schedule. The training loop
publishes values via ``update()``; the monitor never touches the scope
mid-step (published fetches ARE the consistent snapshots). The port's
copy of the JAX package's ``observability/fetcher.py``: the monitor's
lock is the lockdep class ``observability.fetcher``, as there.

``PeriodicMetricsDump`` scrapes the metrics registry on a period to a
file or callback — the flat-file analog of a Prometheus pull for rigs
with no scraper.
"""

import threading

from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability.lockdep import named_lock

__all__ = ["FetchHandlerMonitor", "PeriodicMetricsDump"]


class _PeriodicThread:
    """Shared machinery: daemon thread firing ``_tick`` every period;
    stop() wakes it immediately and optionally fires once more."""

    def __init__(self, period_secs):
        self.period_secs = float(period_secs)
        self._wake = threading.Event()
        self._stopping = False
        self._thread = None

    def start(self):
        # idempotent while RUNNING, restartable once the thread is dead;
        # a stop() whose join timed out keeps the stuck thread pinned
        # here so start() cannot clear _stopping underneath it (which
        # would revive it NEXT TO a fresh one)
        if self._thread is not None:
            if self._thread.is_alive():
                return self
            self._thread = None
        self._stopping = False
        self._thread = threading.Thread(
            target=self._run, name=type(self).__name__, daemon=True
        )
        self._thread.start()
        return self

    def _run(self):
        while True:
            self._wake.wait(timeout=self.period_secs)
            if self._stopping:
                return
            self._wake.clear()
            self._tick()

    def stop(self, final_tick=True, timeout=5.0):
        if self._thread is None:
            return
        self._stopping = True
        self._wake.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            # stuck in a user handler: keep it pinned (start() then
            # refuses to revive it) and SKIP the final tick — running it
            # here would make two concurrent _tick writers
            return
        self._thread = None
        if final_tick:
            self._tick()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class FetchHandlerMonitor(_PeriodicThread):
    """Delivers the latest published fetch dict to ``handler.handler``
    every ``handler.period_secs`` seconds, on a background thread.

        monitor = FetchHandlerMonitor(handler).start()
        for batch in loop:
            out = step(batch)
            monitor.update({"loss": out[0]})
        monitor.stop()          # fires one final delivery
    """

    def __init__(self, handler, period_secs=None):
        super().__init__(period_secs if period_secs is not None
                         else getattr(handler, "period_secs", 60))
        self.handler = handler
        self._lock = named_lock("observability.fetcher")
        self._latest = None
        self.deliveries = 0

    def update(self, fetch_vars):
        """Publish the newest fetched values (called from the training
        loop each step; cheap — one dict swap under a lock)."""
        with self._lock:
            self._latest = dict(fetch_vars)

    def _tick(self):
        with self._lock:
            latest = self._latest
            self._latest = None
        if latest is None:
            return
        try:
            self.handler.handler(latest)
            # lockdep: ok(one writer at a time: the loop thread, or stop()'s final tick strictly AFTER a successful join — stop() skips the final tick when the join times out)
            self.deliveries += 1
        except Exception:
            # a user handler must not kill the monitor (nor the loop)
            from paddle_tpu_torch.observability.logger import get_logger

            get_logger("observability.fetcher").exception(
                "fetch handler raised; continuing"
            )


class PeriodicMetricsDump(_PeriodicThread):
    """Write the registry's Prometheus exposition to ``path`` (or call
    ``fn(text)``) every ``period_secs``. The final scrape fires on
    stop(), so short runs still leave one complete dump behind."""

    def __init__(self, path_or_fn, period_secs=15.0, registry=None):
        super().__init__(period_secs)
        self._target = path_or_fn
        self._registry = registry or _metrics.registry()
        self.dumps = 0

    def _tick(self):
        text = self._registry.to_text()
        if callable(self._target):
            self._target(text)
        else:
            tmp = f"{self._target}.tmp-{threading.get_ident()}"
            with open(tmp, "w") as f:
                f.write(text)
            import os

            os.replace(tmp, self._target)
        # lockdep: ok(one writer at a time: the loop thread, or stop()'s final tick strictly after a successful join)
        self.dumps += 1
