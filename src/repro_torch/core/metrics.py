"""Error metrics for approximate multipliers (paper §5.1, Eq. 7–8).

Counterpart of ``repro.core.metrics``. All metrics are computed
*exhaustively* over the full n-bit signed operand space (65 536 pairs at the
default n=8) via :func:`evaluate`; widths whose grid is not enumerable
(n > MAX_EXHAUSTIVE_BITS) use :func:`evaluate_sampled` on a seeded uniform
operand sample. MRED excludes pairs whose exact product is zero (relative
error undefined there); the exclusion is 511/65536 pairs at n=8 and is the
standard convention.

The products run as plain calls of the multiplier model on tensors on
``device`` (``cuda`` unless the caller asks for the CPU; no card raises);
the statistics are numpy on int64 host copies, so a report is the same
float for float on either device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

Tensor = torch.Tensor
MultFn = Callable[[Tensor, Tensor], Tensor]


@dataclasses.dataclass(frozen=True)
class ErrorReport:
    name: str
    er: float        # error rate: P(approx != exact)
    med: float       # mean |error distance|
    nmed: float      # MED / max|exact|
    mred: float      # mean relative error distance (exact != 0)
    max_ed: int      # max |error distance|
    mean_err: float  # signed mean error (bias)

    def row(self) -> str:
        return (
            f"{self.name:>22s}  ER={self.er * 100:6.2f}%  NMED={self.nmed * 100:6.4f}%  "
            f"MRED={self.mred * 100:6.2f}%  MED={self.med:8.2f}  bias={self.mean_err:+8.2f}"
        )


MAX_EXHAUSTIVE_BITS = 12  # 2^(2n) pairs; beyond this use evaluate_sampled


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the error metrics run on CUDA by default and no CUDA device is "
            "available; pass device='cpu'")
    return device


def operand_grid(n_bits: int = 8, device="cuda") -> tuple[Tensor, Tensor]:
    """All (a, b) signed pairs as flat int32 tensors (n_bits ≤
    MAX_EXHAUSTIVE_BITS)."""
    if n_bits > MAX_EXHAUSTIVE_BITS:
        raise ValueError(
            f"exhaustive grid at n={n_bits} has 2^{2 * n_bits} pairs; "
            "use sample_operands/evaluate_sampled for wide operands")
    lo, hi = -(1 << (n_bits - 1)), (1 << (n_bits - 1))
    v = torch.arange(lo, hi, dtype=torch.int32, device=_device(device))
    a, b = torch.meshgrid(v, v, indexing="ij")
    return a.reshape(-1), b.reshape(-1)


def sample_operands(n_bits: int = 16, n_samples: int = 1 << 16,
                    seed: int = 0, device="cuda") -> tuple[Tensor, Tensor]:
    """Seeded uniform (a, b) operand sample for non-enumerable widths (the
    same draws as ``repro``: numpy's generator on the host)."""
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << (n_bits - 1)), (1 << (n_bits - 1))
    a = rng.integers(lo, hi, n_samples, dtype=np.int64).astype(np.int32)
    b = rng.integers(lo, hi, n_samples, dtype=np.int64).astype(np.int32)
    device = _device(device)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def _report(name: str, exact: np.ndarray, approx: np.ndarray) -> ErrorReport:
    err = approx - exact
    abs_err = np.abs(err)
    nz = exact != 0
    max_exact = np.abs(exact).max()
    return ErrorReport(
        name=name,
        er=float((err != 0).mean()),
        med=float(abs_err.mean()),
        nmed=float(abs_err.mean() / max_exact),
        mred=float((abs_err[nz] / np.abs(exact[nz])).mean()),
        max_ed=int(abs_err.max()),
        mean_err=float(err.mean()),
    )


def _products(mult_fn: MultFn, a: Tensor, b: Tensor):
    exact = (a * b).cpu().numpy().astype(np.int64)
    approx = mult_fn(a, b).cpu().numpy().astype(np.int64)
    return exact, approx


def evaluate(mult_fn: MultFn, name: str = "", n_bits: int = 8,
             device="cuda") -> ErrorReport:
    """Exhaustive ER / MED / NMED / MRED for an n×n multiplier model."""
    a, b = operand_grid(n_bits, device)
    return _report(name or getattr(mult_fn, "__name__", "multiplier"),
                   *_products(mult_fn, a, b))


def evaluate_sampled(mult_fn: MultFn, name: str = "", n_bits: int = 16,
                     n_samples: int = 1 << 16, seed: int = 0,
                     device="cuda") -> ErrorReport:
    """Sampled error metrics for widths whose grid is not enumerable (n=16)."""
    a, b = sample_operands(n_bits, n_samples, seed, device)
    return _report(name or getattr(mult_fn, "__name__", "multiplier"),
                   *_products(mult_fn, a, b))


def evaluate_all(mult_fns: Dict[str, MultFn], n_bits: int = 8,
                 device="cuda") -> Dict[str, ErrorReport]:
    return {name: evaluate(fn, name, n_bits, device)
            for name, fn in mult_fns.items()}


# Paper Table 4 values (percent), for validation bands in tests/benchmarks.
PAPER_TABLE4 = {
    "design_strollo2020": dict(er=98.47, nmed=1.128, mred=32.80),
    "design_guo2019": dict(er=98.95, nmed=0.829, mred=30.00),
    "design_esposito2018": dict(er=99.42, nmed=0.786, mred=35.25),
    "design_akbari2017": dict(er=97.37, nmed=0.738, mred=29.02),
    "design_krishna2024": dict(er=98.95, nmed=0.542, mred=33.00),
    "design_du2022": dict(er=98.15, nmed=0.731, mred=26.84),
    "proposed": dict(er=98.04, nmed=0.682, mred=26.29),
}
