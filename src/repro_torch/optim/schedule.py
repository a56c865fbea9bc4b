"""Learning-rate schedules (counterpart of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import numpy as np


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """Linear warm-up to ``base_lr``, then a cosine decay to
    ``min_ratio · base_lr`` at ``total_steps``; ``lr(step)`` is a float
    computed in float32, as ``repro`` computes it."""
    f32 = np.float32

    def lr(step) -> float:
        step = f32(step)
        if step < warmup_steps:
            return float(f32(base_lr) * min(f32(1.0), step / f32(max(1, warmup_steps))))
        progress = np.clip((step - f32(warmup_steps))
                           / f32(max(1, total_steps - warmup_steps)), f32(0.0), f32(1.0))
        cos = f32(min_ratio) + f32(1 - min_ratio) * f32(0.5) * (
            f32(1) + np.cos(f32(math.pi) * progress))
        return float(f32(base_lr) * cos)

    return lr
