"""Core library: the paper's approximate signed multiplier, bit-exact in torch.

  compressors  — sign-focused compressor models (Table 2/3)
  multiplier   — closed-form + structural approximate BW multipliers
  lut          — product tables, f(0,0)
"""
from repro_torch.core import compressors, lut, multiplier  # noqa: F401

__all__ = ["compressors", "multiplier", "lut"]
