"""Oracle for the elementwise approximate multiply (counterpart of
``repro.kernels.approx_mul.ref``): the core multiplier model."""
from __future__ import annotations

import torch

from repro_torch.core import multiplier as mult


def approx_mul_ref(a, b) -> torch.Tensor:
    """Elementwise proposed approximate product (core-library model)."""
    return mult.approx_multiply(torch.as_tensor(a).to(torch.int32),
                                torch.as_tensor(b).to(torch.int32))
