"""Observability: metrics registry, tracing, substrate meters and their file
export (counterparts of ``repro.obs``'s ``registry``, ``trace``, ``meter``
and ``export``). With no ambient scope installed, instrumented code paths do
one global read and nothing else."""
from repro_torch.obs.export import write_chrome_trace, write_metrics  # noqa: F401
from repro_torch.obs.meter import (ContractionMeter, current_meter,  # noqa: F401
                                   pdp_per_mac_fj, telemetry_scope)
from repro_torch.obs.registry import (DEFAULT_BUCKETS, Counter, Gauge,  # noqa: F401
                                      Histogram, MetricsRegistry)
from repro_torch.obs.trace import (JsonlSink, Tracer, current_tracer,  # noqa: F401
                                   trace_span, tracing_scope)
