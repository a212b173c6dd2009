"""Observability: the metrics registry (typed counters, gauges and
bucketed histograms, Prometheus text exposition) that the serving
engine's stats read from."""

from paddle_tpu_torch.observability.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    registry,
    scrape_text,
)
