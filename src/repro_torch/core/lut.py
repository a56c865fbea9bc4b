"""Precomputed lookup tables for the approximate multipliers, width-indexed.

Counterpart of ``repro.core.lut``. A (2^n)×(2^n) int32 table fully
characterizes any n×n multiplier model. Tables are built on the host and
returned as numpy arrays; :func:`lut_multiply` gathers from a tensor copy
on the operands' device.

* Tables are keyed ``"{mult_name}[@{n}]"`` (``@8`` implicit, aliases
  resolved). Exhaustive tables exist for n ≤ MAX_LUT_BITS (8).
* Index convention: ``lut[a + 2^(n-1), b + 2^(n-1)] = mult(a, b)``.
* Wraparound: :func:`lut_multiply` masks gather indices to n bits, so
  out-of-range ints hit the same wrapped entry the closed form computes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import multiplier as m

Tensor = torch.Tensor

MAX_LUT_BITS = 8  # 2^(2n) entries; beyond 8 bits the table is impractical


def _lut_width(table) -> int:
    """Operand width implied by a table's shape (inverse of build_lut)."""
    size = table.shape[0]
    n = size.bit_length() - 1
    if tuple(table.shape[-2:]) != (1 << n, 1 << n):
        raise ValueError(f"not a product LUT shape: {tuple(table.shape)}")
    return n


@functools.lru_cache(maxsize=None)
def _build_lut_canonical(key: str) -> np.ndarray:
    base, n = m.split_width(key)
    if n > MAX_LUT_BITS:
        raise ValueError(
            f"exhaustive LUTs are built for widths <= {MAX_LUT_BITS} "
            f"(got {key!r}: 2^{2 * n} entries); use the approx_bitexact "
            "closed form for wider operands")
    fn = m.make_multiplier(base, n)
    lo, hi = -(1 << (n - 1)), 1 << (n - 1)
    v = torch.arange(lo, hi, dtype=torch.int32)
    a, b = torch.meshgrid(v, v, indexing="ij")
    table = fn(a.reshape(-1), b.reshape(-1)).reshape(1 << n, 1 << n)
    out = table.numpy().astype(np.int32)
    out.setflags(write=False)  # cached and shared by every caller
    return out


def build_lut(mult_name: str) -> np.ndarray:
    """The (read-only, cached) product table for ``"name[@N]"`` (N ≤ 8)."""
    return _build_lut_canonical(m.canonical_key(mult_name))


def lut_multiply(a, b, lut) -> Tensor:
    """Gather-based approximate product; width derives from ``lut.shape``.

    Indices are masked to the table's operand width, matching the closed
    form's operand-wraparound semantics for out-of-range ints.
    """
    a = torch.as_tensor(a).to(torch.int32)
    b = torch.as_tensor(b).to(torch.int32)
    lut = (lut if torch.is_tensor(lut) else torch.tensor(np.asarray(lut))).to(a.device)
    n = _lut_width(lut)
    size, off = 1 << n, 1 << (n - 1)
    ai = ((a + off) & (size - 1)).long()
    bi = ((b + off) & (size - 1)).long()
    return lut[ai, bi]


def flat_lut(mult_name: str) -> np.ndarray:
    """Flat ``(2^{2n},)`` view of the product table for gather kernels:
    ``flat[((a + off) & mask) << n | ((b + off) & mask)] = mult(a, b)``."""
    return build_lut(mult_name).reshape(-1)


def f00(mult_name: str) -> int:
    """The model's product at (0, 0) — the k-padding correction constant.

    Approximate wirings map (0,0) to a nonzero value that differs across
    wirings and widths (proposed@8 → 192, design_strollo2020@8 → 64,
    design_strollo2020@4 → −4): a contraction that zero-pads k must
    subtract *this wiring's* f(0,0) per padded element.
    """
    table = build_lut(mult_name)
    off = 1 << (_lut_width(table) - 1)
    return int(table[off, off])


def error_lut(mult_name: str) -> np.ndarray:
    """(2^n)×(2^n) table of (approx − exact) — compact error characterization."""
    table = build_lut(mult_name)
    n = _lut_width(table)
    lo, hi = -(1 << (n - 1)), 1 << (n - 1)
    v = np.arange(lo, hi, dtype=np.int64)
    exact = v[:, None] * v[None, :]
    return (table.astype(np.int64) - exact).astype(np.int32)


def error_moments(mult_name: str) -> dict:
    """Mean/std of the error under uniform operands, normalized over the
    table's own 2^(2n) entries (drives the ``approx_stat`` model)."""
    e = error_lut(mult_name).astype(np.float64)
    return dict(mean=float(e.mean()), std=float(e.std()),
                max_abs=float(np.abs(e).max()))
