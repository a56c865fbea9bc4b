"""Fault-tolerant training loop and approximation-aware training (QAT):
counterparts of ``repro.train``."""
from repro_torch.train.loop import TrainLoop, TrainLoopConfig  # noqa: F401
from repro_torch.train.qat import (  # noqa: F401
    QATPolicy, qat_dot_general, qat_scope)
