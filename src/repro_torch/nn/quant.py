"""Symmetric integer quantization for the approximate-multiplier modes.

Counterpart of ``repro.nn.quant``: symmetric absmax quantization, per-tensor
(dynamic) for activations and per-output-channel for weights.

Width contract: ``bits`` selects the operand width of the downstream
multiplier. Values are clipped to ``[-(2^(bits-1)-1), 2^(bits-1)-1]`` and
stored as int8 for bits ≤ 8, int16 for 9 ≤ bits ≤ 16. Rounding is half to
even in both packages (``torch.round`` / ``jnp.round``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

Tensor = torch.Tensor


def qmax(bits: int = 8) -> float:
    """Largest symmetric quantized magnitude at the given operand width."""
    if not (2 <= bits <= 16):
        raise ValueError(f"quantization width must be in [2, 16]; got {bits}")
    return float((1 << (bits - 1)) - 1)


def storage_dtype(bits: int = 8) -> torch.dtype:
    """Narrowest torch integer dtype holding signed ``bits``-wide values."""
    return torch.int8 if bits <= 8 else torch.int16


@dataclasses.dataclass(frozen=True)
class Quantized:
    """Integer values + float scale such that ``values * scale ≈ original``."""

    values: Tensor  # int8 (bits ≤ 8) or int16
    scale: Tensor   # f32, broadcastable against values

    def dequantize(self) -> Tensor:
        return self.values.to(torch.float32) * self.scale


def _absmax(x: Tensor, axes: Sequence[int] | None, eps: float = 1e-8) -> Tensor:
    """Epsilon-guarded absmax: an all-zero tensor yields ``eps``, not 0, so
    the derived scale stays finite and zero tensors quantize to zeros."""
    a = x.abs()
    m = a.amax(dim=tuple(axes), keepdim=True) if axes is not None else a.max()
    return torch.clamp_min(m.to(torch.float32), eps)


def quantize(x: Tensor, axes: Sequence[int] | None = None,
             bits: int = 8, eps: float = 1e-8) -> Quantized:
    """Symmetric absmax quantization to signed ``bits``-wide integers.

    axes: reduction axes for the scale (None = per-tensor); e.g. for a weight
    of shape (in, out), ``axes=(0,)`` gives a per-output-channel scale.
    """
    m = qmax(bits)
    absmax = _absmax(x, axes, eps)
    # divide by a tensor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, up to an ulp off the true quotient that repro's scale is
    scale = absmax / torch.full_like(absmax, m)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -m, m)
    return Quantized(q.to(storage_dtype(bits)), scale)


def fake_quantize(x: Tensor, axes: Sequence[int] | None = None,
                  bits: int = 8) -> Tensor:
    """Quantize→dequantize (straight-through value)."""
    q = quantize(x, axes, bits)
    return q.dequantize().to(x.dtype)


def quantization_error(x: Tensor, axes: Sequence[int] | None = None,
                       bits: int = 8) -> Tensor:
    return (fake_quantize(x, axes, bits) - x).abs()
