"""Plain oracle for the LUT-input contraction (counterpart of
``repro.kernels.lut_matmul.ref``)."""
from __future__ import annotations

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.kernels.lut_matmul.ops import table_width


def lut_matmul_ref(a, b, table) -> torch.Tensor:
    """sum_k lut[a[m,k], b[k,n]] through the 2-D LUT gather.

    Materializes the (M, K, N) product tensor — oracle for small shapes
    only. ``table`` may be the flat (2^{2n},) or the square (2^n, 2^n) LUT.
    """
    a = torch.as_tensor(a).to(torch.int32)
    b = torch.as_tensor(b).to(torch.int32)
    table = torch.as_tensor(table).to(torch.int32)
    if table.dim() == 1:
        n_bits = table_width(table.shape[0])
        table = table.reshape(1 << n_bits, 1 << n_bits)
    prod = lut_lib.lut_multiply(a[:, :, None], b[None, :, :], table)
    return prod.sum(dim=1, dtype=torch.int32)
