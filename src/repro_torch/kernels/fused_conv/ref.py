"""Scalar tap-loop oracle for the fused conv kernel (counterpart of
``repro.kernels.fused_conv.ref``)."""
from __future__ import annotations

import torch

from repro_torch.core import multiplier as mult
from repro_torch.nn import conv


def fused_conv_ref(imgs, kernel, mult_key: str = "proposed") -> torch.Tensor:
    """Batched 'same' conv via the scalar tap loop (``conv.conv2d_int``)."""
    _, fn, _ = mult.resolve_multiplier(mult_key)
    imgs = torch.as_tensor(imgs).to(torch.int32)
    kernel = torch.as_tensor(kernel).to(torch.int32)
    return torch.stack([conv.conv2d_int(im, kernel, fn) for im in imgs])
