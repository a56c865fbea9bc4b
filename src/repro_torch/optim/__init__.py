"""Optimizers, schedules and gradient clipping on dicts of tensors
(counterparts of ``repro.optim``)."""
from repro_torch.optim.adafactor import adafactor  # noqa: F401
from repro_torch.optim.adamw import Optimizer, adamw  # noqa: F401
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
