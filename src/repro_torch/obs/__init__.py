"""Observability: metrics registry, tracing and their file export (copies of
``repro.obs``'s ``registry``, ``trace`` and ``export``; the substrate meters
come with a later slice)."""
from repro_torch.obs.export import write_chrome_trace, write_metrics  # noqa: F401
from repro_torch.obs.registry import (DEFAULT_BUCKETS, Counter, Gauge,  # noqa: F401
                                      Histogram, MetricsRegistry)
from repro_torch.obs.trace import (JsonlSink, Tracer, current_tracer,  # noqa: F401
                                   trace_span, tracing_scope)
