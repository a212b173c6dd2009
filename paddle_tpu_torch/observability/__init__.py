"""Observability: the metrics registry (typed counters, gauges and
bucketed histograms, Prometheus text exposition) that the serving
engine's stats read from, and ``lockdep``, the runtime lock-order
witness (named lock classes, one process-global may-acquire-while-holding
graph, cycle and declared-hierarchy violations raised at acquire time;
armed by ``PADDLE_TPU_LOCKDEP=1``)."""

from paddle_tpu_torch.observability.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    registry,
    scrape_text,
)
from paddle_tpu_torch.observability import lockdep  # noqa: F401
from paddle_tpu_torch.observability.lockdep import (  # noqa: F401
    LockOrderError,
    declare_order,
    named_condition,
    named_lock,
)
