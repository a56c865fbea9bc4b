"""Serving: the micro-batching core, its telemetry and the edge service.

* :mod:`repro_torch.serving.batcher` — MicroBatcher (dynamic micro-batching);
* :mod:`repro_torch.serving.metrics` — ServingMetrics telemetry;
* :mod:`repro_torch.serving.edge_service` — EdgeDetectService over the
  substrate registry, on the card by default.
"""
from repro_torch.serving.batcher import MicroBatcher, Ticket  # noqa: F401
from repro_torch.serving.edge_service import EdgeDetectService  # noqa: F401
from repro_torch.serving.metrics import ServingMetrics  # noqa: F401
