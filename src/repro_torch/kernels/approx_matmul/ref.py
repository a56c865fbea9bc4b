"""Plain oracle for the approximate matmul kernel (counterpart of
``repro.kernels.approx_matmul.ref``)."""
from __future__ import annotations

import torch

from repro_torch.core import multiplier as mult


def approx_matmul_ref(a, b) -> torch.Tensor:
    """sum_k f(a[m,k], b[k,n]) with f = proposed approximate multiplier.

    Materializes the (M, K, N) product tensor — oracle for small shapes only.
    """
    a = torch.as_tensor(a).to(torch.int32)
    b = torch.as_tensor(b).to(torch.int32)
    prod = mult.approx_multiply(a[:, :, None], b[None, :, :])
    return prod.sum(dim=1, dtype=torch.int32)
