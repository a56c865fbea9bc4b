"""Serving: the scheduling core, its telemetry, the edge service and the LM
engine.

* :mod:`repro_torch.serving.batcher` — SlotScheduler (fixed-slot continuous
  batching) and MicroBatcher (dynamic micro-batching);
* :mod:`repro_torch.serving.metrics` — ServingMetrics telemetry;
* :mod:`repro_torch.serving.edge_service` — EdgeDetectService over the
  substrate registry, on the card by default;
* :mod:`repro_torch.serving.engine` — the LM ServingEngine, on the card by
  default.
"""
from repro_torch.serving.batcher import (MicroBatcher, SlotScheduler,  # noqa: F401
                                         Ticket)
from repro_torch.serving.edge_service import EdgeDetectService  # noqa: F401
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
from repro_torch.serving.metrics import ServingMetrics  # noqa: F401
