"""Metrics registry: typed counters, gauges, and bucketed histograms.

The port's copy of the JAX package's ``observability/metrics.py``, with
plain ``threading`` locks where that one takes lockdep-named ones.

One always-on registry for the whole process (a serving replica must
answer a scrape whether or not anyone is profiling). Histograms are
bucketed — p50/p95/p99 come from bucket counts by linear interpolation,
never from stored sample lists, so memory is O(buckets) regardless of
traffic. ``scrape_text()`` emits Prometheus text exposition format.

Series are keyed (family name, labels): two ServingEngines in one process
are two label sets of the same family, so per-engine snapshots stay exact
while the scrape shows the fleet.
"""

import bisect
import re
import threading


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
    "scrape_text",
    "DEFAULT_BUCKETS",
]

# latency ladder: 1-2.5-5 per decade from 10us to 50s — wide enough for a
# feed-dict hot path and a cold XLA compile in the same histogram
DEFAULT_BUCKETS = tuple(
    b * (10.0 ** e) for e in range(-5, 2) for b in (1.0, 2.5, 5.0)
)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name):
    """Prometheus-legal metric name from a dotted/arbitrary one."""
    name = _NAME_RE.sub("_", str(name))
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _label_key(labels):
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


def _label_str(labels):
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class _Metric:
    __slots__ = ("name", "help", "labels", "_lock")

    def __init__(self, name, help="", labels=()):
        self.name = name
        self.help = help
        self.labels = labels  # sorted (k, v) tuple
        # a leaf: no acquisition ever nests inside a series lock
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonic counter (float-valued: occupancy sums etc. count too)."""

    __slots__ = ("_value",)
    kind = "counter"

    def __init__(self, name, help="", labels=()):
        super().__init__(name, help, labels)
        self._value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0

    def _expose(self):
        return [(self.name, self.labels, self.value)]


class Gauge(_Metric):
    """Set/inc/dec instantaneous value (queue depth, open breakers)."""

    __slots__ = ("_value",)
    kind = "gauge"

    def __init__(self, name, help="", labels=()):
        super().__init__(name, help, labels)
        self._value = 0

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0

    def _expose(self):
        return [(self.name, self.labels, self.value)]


class Histogram(_Metric):
    """Bucketed distribution. ``bounds`` are inclusive upper bounds of the
    finite buckets; one implicit +Inf bucket catches the tail. Quantiles
    interpolate linearly inside the bucket holding the target rank (the
    Prometheus histogram_quantile rule), so their error is bounded by the
    bucket width — the price of O(buckets) memory."""

    __slots__ = ("bounds", "_counts", "_sum", "_count")
    kind = "histogram"

    def __init__(self, name, help="", labels=(), buckets=None):
        super().__init__(name, help, labels)
        bounds = sorted(float(b) for b in (buckets or DEFAULT_BUCKETS))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = tuple(bounds)
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    @property
    def avg(self):
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def bucket_counts(self):
        """Per-bucket (non-cumulative) counts, +Inf bucket last."""
        with self._lock:
            return list(self._counts)

    def quantile(self, q):
        """q in [0, 1]. Linear interpolation inside the target bucket;
        the +Inf bucket reports the largest finite bound (no upper edge
        to interpolate toward)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            if cum + c >= rank or i == len(counts) - 1:
                if i >= len(self.bounds):  # +Inf bucket
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                if c == 0:
                    return hi
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.bounds[-1]

    def percentile(self, p):
        return self.quantile(p / 100.0)

    def reset(self):
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._count = 0

    def snapshot(self, prefix):
        """Legacy-shaped latency summary (serving.stats() keys)."""
        with self._lock:
            count, total = self._count, self._sum
        return {
            f"{prefix}_count": count,
            f"{prefix}_avg_s": total / count if count else 0.0,
            f"{prefix}_p50_s": self.quantile(0.50),
            f"{prefix}_p95_s": self.quantile(0.95),
            f"{prefix}_p99_s": self.quantile(0.99),
        }

    def _expose(self):
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        rows = []
        cum = 0
        for bound, c in zip(self.bounds, counts):
            cum += c
            le = (("le", repr(bound) if bound != int(bound)
                   else str(bound)),)
            rows.append((self.name + "_bucket", self.labels + le, cum))
        rows.append(
            (self.name + "_bucket", self.labels + (("le", "+Inf"),), total)
        )
        rows.append((self.name + "_sum", self.labels, s))
        rows.append((self.name + "_count", self.labels, total))
        return rows


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create store of metric series keyed (family, labels).
    Re-requesting an existing series returns it; requesting an existing
    family with a different type raises (one family, one type — the
    Prometheus exposition invariant)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._series = {}   # (name, label_key) -> metric
        self._families = {}  # name -> (kind, help)

    def _get_or_create(self, kind, name, help, labels, **kw):
        name = sanitize_name(name)
        lk = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None and fam[0] != kind:
                raise ValueError(
                    f"metric family '{name}' already registered as "
                    f"{fam[0]}, requested {kind}"
                )
            m = self._series.get((name, lk))
            if m is None:
                m = _KINDS[kind](name, help or (fam[1] if fam else ""),
                                 labels=lk, **kw)
                self._series[(name, lk)] = m
                if fam is None:
                    self._families[name] = (kind, help)
            return m

    def counter(self, name, help="", labels=None):
        return self._get_or_create("counter", name, help, labels)

    def gauge(self, name, help="", labels=None):
        return self._get_or_create("gauge", name, help, labels)

    def histogram(self, name, help="", labels=None, buckets=None):
        return self._get_or_create("histogram", name, help, labels,
                                   buckets=buckets)

    # -- read side ---------------------------------------------------------
    def collect(self):
        with self._lock:
            return list(self._series.values())

    def get(self, name, labels=None):
        with self._lock:
            return self._series.get((sanitize_name(name),
                                     _label_key(labels)))

    def snapshot(self):
        """{family: {label_str: value-or-histogram-summary}} — the
        one-registry view the acceptance smoke reads."""
        out = {}
        for m in self.collect():
            fam = out.setdefault(m.name, {})
            key = _label_str(m.labels) or ""
            if m.kind == "histogram":
                fam[key] = {
                    "count": m.count, "sum": m.sum,
                    "p50": m.quantile(0.5), "p95": m.quantile(0.95),
                    "p99": m.quantile(0.99),
                }
            else:
                fam[key] = m.value
        return out

    def to_text(self):
        """Prometheus text exposition (version 0.0.4)."""
        by_family = {}
        for m in self.collect():
            by_family.setdefault(m.name, []).append(m)
        lines = []
        for name in sorted(by_family):
            series = by_family[name]
            kind, help = self._families.get(name, (series[0].kind, ""))
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
            for m in series:
                for row_name, labels, value in m._expose():
                    lines.append(f"{row_name}{_label_str(labels)} {value}")
        return "\n".join(lines) + "\n"

    # -- maintenance (tests, engine teardown) ------------------------------
    def reset(self):
        for m in self.collect():
            m.reset()

    def remove(self, name, labels=None):
        with self._lock:
            m = self._series.pop((sanitize_name(name), _label_key(labels)),
                                 None)
            if not any(k[0] == sanitize_name(name) for k in self._series):
                self._families.pop(sanitize_name(name), None)
            return m

    def clear(self):
        with self._lock:
            self._series.clear()
            self._families.clear()


_REGISTRY = MetricsRegistry()


def registry():
    """The process-global registry — the single scrape."""
    return _REGISTRY


def scrape_text():
    return _REGISTRY.to_text()
