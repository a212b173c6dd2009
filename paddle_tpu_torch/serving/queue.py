"""Bounded admission queue with priority lanes and deadline expiry.

The reference served requests thread-per-predictor with no shared queue;
under overload that design queues inside the kernel's accept backlog and
times out opaquely. Here admission is explicit (Clipper's front-end
pattern): a bounded queue that REJECTS with a retry-after estimate when
full, priority lanes so interactive traffic overtakes batch traffic, and
deadline expiry so the device never runs a request whose caller already
gave up.

The retry-after hint is MEASURED, not fixed: the queue keeps an EWMA of
its own drain rate (rows leaving via dispatch or expiry per second) and,
when full, estimates how long until enough rows have drained to admit
THIS request. Callers may still pass an explicit hint (the engine's
batch-rate model) — the queue reports whichever is larger, so backoff
never undershoots either signal. Deadline expiries are counted apart
from admission rejections (`stats()`): "we were too full" and "the
caller's SLO died waiting" are different capacity problems. Requests
pulled back out for re-dispatch (``reroute()``, the drain-before-retire
path) are a third outcome, counted separately again, because a rerouted
request is still served, just elsewhere.

Locking: the queue owns a ``threading.RLock`` (`queue.lock`); single
calls take it internally, and the engine's scheduler takes it around
compound scan-and-remove operations (and builds its dispatch Condition
on it). It is re-entrant because those compound sections call the
queue's own locking methods.
"""

import time
from collections import deque

import threading

from paddle_tpu_torch.serving.request import Priority, RejectedError

__all__ = ["RequestQueue"]

# before any drain has been observed there is no rate to extrapolate —
# this seed hint is the cold-start fallback, not a fixed answer
_COLD_START_HINT_S = 0.05
_EWMA_ALPHA = 0.3


class RequestQueue:
    def __init__(self, max_depth=256):
        self.max_depth = int(max_depth)
        self.lock = threading.RLock()
        self._lanes = {p: deque() for p in Priority.LANES}
        self._depth = 0
        self._closed = False
        # drain-rate EWMA (rows/s) + separated outcome counters
        self._drain_rate = 0.0
        self._last_drain_t = None
        self._deferred_rows = 0
        self._rejected_full = 0
        self._expired_in_queue = 0
        self._rerouted = 0

    # -- admission ---------------------------------------------------------
    def put(self, request, retry_after_s=None):
        """Admit or reject-with-backpressure. The rejection's
        `retry_after_s` is estimated from the queue's measured drain
        rate (time until `request.rows` rows of headroom exist);
        `retry_after_s`, when given, is a caller-side floor — the hint
        reported is the max of both estimates."""
        with self.lock:
            if self._closed:
                raise RejectedError(
                    "serving engine is draining; not accepting requests",
                    retry_after_s=0.0,
                )
            if self._depth + request.rows > self.max_depth:
                self._rejected_full += 1
                hint = self.retry_after_estimate(request.rows)
                if retry_after_s is not None:
                    hint = max(hint, float(retry_after_s))
                raise RejectedError(
                    f"queue full ({self._depth}/{self.max_depth} rows); "
                    f"retry after {hint:.3f}s",
                    retry_after_s=hint,
                )
            self._lanes[request.priority].append(request)
            self._depth += request.rows
        return request

    def retry_after_estimate(self, rows=1):
        """Seconds until `rows` rows of headroom should exist at the
        current drain rate (bounded to [5ms, 5s]; cold-start fallback
        before the first drain). O(1) — runs on every rejected submit."""
        with self.lock:
            overflow = max(self._depth + rows - self.max_depth, 1)
            if self._drain_rate <= 0.0:
                return _COLD_START_HINT_S
            return min(max(overflow / self._drain_rate, 0.005), 5.0)

    def _note_drained(self, rows, now):
        """EWMA update on every row leaving the queue (dispatch OR
        expiry — both free admission capacity). Caller holds `lock`.

        Only back-to-back drains of a continuously busy queue are
        service-rate samples: when the queue goes empty the timer resets,
        otherwise the first drain after an idle gap measures the ARRIVAL
        rate and a burst hitting a long-idle queue would be told to back
        off as if the engine were that slow."""
        if rows <= 0:
            return
        if self._last_drain_t is not None:
            dt = max(now - self._last_drain_t, 1e-6)
            sample = rows / dt
            self._drain_rate = (
                sample if self._drain_rate == 0.0
                else _EWMA_ALPHA * sample
                + (1.0 - _EWMA_ALPHA) * self._drain_rate
            )
        self._last_drain_t = now if self._depth > 0 else None

    def close(self):
        """Stop admitting (drain mode); queued requests still serve."""
        with self.lock:
            self._closed = True

    def reopen(self):
        with self.lock:
            self._closed = False

    # -- scheduling surface (callers hold `lock` across compound use) ------
    def expire(self, now=None):
        """Remove and return every deadline-expired request (they are
        rejected BEFORE dispatch — no device time on dead answers).
        Counted separately from admission rejections in `stats()`."""
        now = now if now is not None else time.perf_counter()
        dead = []
        with self.lock:
            for lane in self._lanes.values():
                kept = deque()
                for r in lane:
                    (dead if r.expired(now) else kept).append(r)
                lane.clear()
                lane.extend(kept)
            rows = 0
            for r in dead:
                self._depth -= r.rows
                rows += r.rows
            self._expired_in_queue += len(dead)
            self._note_drained(rows, time.perf_counter())
        return dead

    def lane(self, priority):
        """The queued requests of one priority lane, in FIFO order (the
        decode engine's picker scans this under ``lock``)."""
        return tuple(self._lanes[priority])

    def head(self):
        """Oldest request in the highest non-empty lane (dispatch order),
        or None."""
        with self.lock:
            for p in Priority.LANES:
                if self._lanes[p]:
                    return self._lanes[p][0]
        return None

    def iter_requests(self):
        """Snapshot in dispatch order (priority lanes, FIFO within)."""
        with self.lock:
            out = []
            for p in Priority.LANES:
                out.extend(self._lanes[p])
            return out

    def remove(self, requests, batch=False):
        """Remove specific admitted requests (they were taken for a
        batch). ``batch=True`` defers the drain-rate sample: a caller
        picking ONE request at a time within a single admission round
        accumulates the rows and samples them as one drain via
        `note_drained()` — sampling each pick would measure the pick
        loop's microsecond gaps (~1e6 rows/s) instead of service."""
        ids = {r.id for r in requests}
        with self.lock:
            for lane in self._lanes.values():
                kept = [r for r in lane if r.id not in ids]
                if len(kept) != len(lane):
                    lane.clear()
                    lane.extend(kept)
            rows = 0
            for r in requests:
                self._depth -= r.rows
                rows += r.rows
            if batch:
                self._deferred_rows += rows
            else:
                self._note_drained(rows, time.perf_counter())

    def note_drained(self):
        """Sample the rows of `remove(batch=True)` calls accumulated
        since the last sample as ONE drain event (call once per
        admission round)."""
        with self.lock:
            rows, self._deferred_rows = self._deferred_rows, 0
            self._note_drained(rows, time.perf_counter())

    def reroute(self, requests):
        """Remove admitted requests for RE-DISPATCH elsewhere (drain
        before retire): the rows leave this queue like any dispatch, but
        the outcome is counted apart from both rejections and expiries —
        a rerouted request is still going to be SERVED. The request
        objects keep their absolute deadline."""
        self.remove(requests)
        with self.lock:
            self._rerouted += len(requests)

    # -- introspection -----------------------------------------------------
    def depth(self):
        """Queued rows (admission unit: a 4-row request costs 4)."""
        with self.lock:
            return self._depth

    def lane_depths(self):
        """{priority: queued rows} — the per-lane gauge source."""
        with self.lock:
            return {p: sum(r.rows for r in lane)
                    for p, lane in self._lanes.items()}

    def pressure(self, now=None, horizon_s=1.0):
        """Normalized pressure signals for the brownout controller
        (serving/brownout.py), sampled once per scheduler iteration:

        * ``queue_seconds`` — queued rows over the measured drain rate,
          normalized against ``horizon_s`` (1.0 == a full horizon of
          work is backed up). Zero before the first drain sample: an
          idle queue must not brown out on its cold-start hint.
        * ``deadline`` — ``1 - headroom / budget`` for the most urgent
          queued request (0 fresh, 1 at expiry); 0 when nothing queued
          carries a deadline.
        * ``depth_frac`` — queued rows over ``max_depth``.
        """
        now = now if now is not None else time.perf_counter()
        with self.lock:
            depth = self._depth
            rate = self._drain_rate
            worst = 0.0
            for lane in self._lanes.values():
                for r in lane:
                    if r.deadline is None:
                        continue
                    budget = r.deadline - r.submit_time
                    if budget <= 0.0:
                        worst = 1.0
                        continue
                    frac = 1.0 - (r.deadline - now) / budget
                    worst = max(worst, min(max(frac, 0.0), 1.0))
        qs = 0.0
        if depth > 0 and rate > 0.0:
            qs = min((depth / rate) / float(horizon_s), 1.0)
        return {
            "queue_seconds": qs,
            "deadline": worst,
            "depth_frac": depth / float(max(self.max_depth, 1)),
        }

    def stats(self):
        """Queue-side counters: depth, per-lane depths, the measured
        drain rate, and the rejected-at-admission vs expired-in-queue
        split."""
        with self.lock:
            return {
                "depth": self._depth,
                "lane_depths": self.lane_depths(),  # RLock: re-entrant
                "drain_rate_rows_per_s": self._drain_rate,
                "rejected_at_admission": self._rejected_full,
                "expired_in_queue": self._expired_in_queue,
                "rerouted": self._rerouted,
            }

    def empty(self):
        with self.lock:
            return self._depth == 0

    def closed(self):
        with self.lock:
            return self._closed
