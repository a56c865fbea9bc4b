"""Global-norm gradient clipping (counterpart of the clipping half of
``repro.optim.grad_utils``; its int8 compression of the data-parallel
all-reduce comes with the partitioned paths, ROADMAP.md queue 1 item 11).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensor = torch.Tensor


def global_norm(tree: Dict[str, Tensor]) -> Tensor:
    """sqrt of the sum over leaves of Σ x², each leaf summed in float32."""
    total = None
    for x in tree.values():
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree: Dict[str, Tensor],
                        max_norm: float) -> Tuple[Dict[str, Tensor], Tensor]:
    """Every leaf scaled by ``min(1, max_norm / norm)`` (in float32, cast
    back to its dtype) → (clipped leaves, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return {k: (x.to(torch.float32) * scale).to(x.dtype)
            for k, x in tree.items()}, norm
