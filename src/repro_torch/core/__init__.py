"""Core library: the paper's approximate signed multiplier, bit-exact in torch.

  compressors  — sign-focused compressor models (Table 2/3)
  multiplier   — closed-form + structural approximate BW multipliers
  lut          — product tables, f(0,0)
  metrics      — ER / NMED / MRED error metrics (Table 4)
  energy       — unit-gate area / power / delay / PDP model (Table 5)
"""
from repro_torch.core import compressors, energy, lut, metrics, multiplier  # noqa: F401

__all__ = ["compressors", "multiplier", "lut", "metrics", "energy"]
