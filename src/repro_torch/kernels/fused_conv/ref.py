"""Scalar tap-loop oracles for the fused conv kernel (counterpart of
``repro.kernels.fused_conv.ref``): the batched conv of any multiplier and
the single-image Laplacian conv through the paper's multiplier."""
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


def laplacian_conv_ref(img_i32) -> torch.Tensor:
    """'same' Laplacian conv of signed-domain pixels via the core model."""
    return conv.conv2d_int(torch.as_tensor(img_i32).to(torch.int32),
                           conv.LAPLACIAN, mult.approx_multiply)
