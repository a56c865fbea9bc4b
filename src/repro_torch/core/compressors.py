"""Sign-focused compressor models (paper §2.1, §3.1; Tables 2 & 3).

Counterpart of ``repro.core.compressors``. Every compressor is modeled two
ways:

1. *Gate-level boolean form* (``*_gates`` over int32 tensors holding 0/1
   bits) — the behavioural netlist.
2. *Truth-table form* (``values``, a numpy array indexed by the packed input
   bits) — used for exhaustive validation, the error statistics and the
   closed-form parameter blocks of the CUDA kernels.

Input conventions follow the paper: for the ``A+B+C+1`` family, input ``A`` is
the *negative* partial product (NAND-generated, P(A=1)=3/4) and ``B``/``C`` are
positive partial products (AND-generated, P=1/4 each). For ``A+B+C+D+1``,
``A`` is negative and ``B,C,D`` positive.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

Tensor = torch.Tensor


def _i32(x) -> Tensor:
    return torch.as_tensor(x).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A (possibly approximate) compressor computing ``sum(inputs) + 1``.

    Attributes:
      name: design identifier (e.g. ``proposed3``, ``ac5_du2022``).
      n_inputs: 3 for ``A+B+C+1``, 4 for ``A+B+C+D+1``.
      values: np.ndarray of shape (2**n_inputs,) — the *approximate* output
        value for each packed input ``(A<<n-1 | ... | C<<0)``.
      source: citation tag.
      reconstructed: True when the truth table is not verbatim from the paper
        (designs [1]/[7], which Tables 4/5 reference without truth tables).
    """

    name: str
    n_inputs: int
    values: np.ndarray
    source: str = ""
    reconstructed: bool = False

    @property
    def exact(self) -> np.ndarray:
        idx = np.arange(2 ** self.n_inputs)
        pop = np.array([bin(i).count("1") for i in idx])
        return pop + 1

    @property
    def errors(self) -> np.ndarray:
        """approx − exact, per packed input combination."""
        return self.values - self.exact

    def input_probs(self) -> np.ndarray:
        """P(input combo) with A negative (P(1)=3/4) and the rest positive (1/4)."""
        n = self.n_inputs
        probs = np.ones(2 ** n)
        for idx in range(2 ** n):
            for bit in range(n):
                is_one = (idx >> (n - 1 - bit)) & 1
                p_one = 0.75 if bit == 0 else 0.25  # bit 0 == input A (negative pp)
                probs[idx] *= p_one if is_one else (1.0 - p_one)
        return probs

    def error_probability(self) -> float:
        """P_E per Eq. (4)."""
        return float(self.input_probs()[self.errors != 0].sum())

    def mean_error(self) -> float:
        """E_mean per Eq. (4): sum_i P(err_i) * (S_exact - S_approx)."""
        return float((self.input_probs() * (self.exact - self.values)).sum())

    # -- vectorized evaluation ------------------------------------------------

    def apply_packed(self, idx: Tensor) -> Tensor:
        """Approximate value for packed input indices (int tensor)."""
        idx = torch.as_tensor(idx)
        table = torch.as_tensor(self.values, dtype=torch.int32, device=idx.device)
        return table[idx.long()]

    def error_packed(self, idx: Tensor) -> Tensor:
        """approx − exact for packed input indices (int tensor)."""
        idx = torch.as_tensor(idx)
        table = torch.as_tensor(self.errors, dtype=torch.int32, device=idx.device)
        return table[idx.long()]

    def carry_bit(self, idx: Tensor) -> Tensor:
        """Carry output bit (weight 2) of the approximate value."""
        return (self.apply_packed(idx) >> 1) & 1

    def sum_bit(self, idx: Tensor) -> Tensor:
        return self.apply_packed(idx) & 1


def pack_bits(bits: Sequence) -> Tensor:
    """Pack bit tensors [A, B, C, (D)] into truth-table indices, A = MSB."""
    n = len(bits)
    idx = torch.zeros_like(_i32(bits[0]))
    for k, b in enumerate(bits):
        idx = idx | (_i32(b) << (n - 1 - k))
    return idx


# ---------------------------------------------------------------------------
# Gate-level boolean forms for the proposed designs (Fig. 4 reconstruction)
# ---------------------------------------------------------------------------


def proposed3_gates(a, b, c) -> tuple[Tensor, Tensor]:
    """Proposed approximate A+B+C+1: carry = A|B|C, sum = ¬(A·¬B·¬C)."""
    a, b, c = (_i32(x) for x in (a, b, c))
    carry = a | b | c
    s = 1 - (a & (1 - b) & (1 - c))
    return carry, s


def proposed4_gates(a, b, c, d) -> tuple[Tensor, Tensor]:
    """Proposed approximate A+B+C+D+1: carry = A|B|C|D, sum = ¬(A·¬B·¬C·¬D)."""
    a, b, c, d = (_i32(x) for x in (a, b, c, d))
    carry = a | b | c | d
    s = 1 - (a & (1 - b) & (1 - c) & (1 - d))
    return carry, s


def exact3_value(a, b, c) -> Tensor:
    """Exact A+B+C+1 (proposed exact sign-focused compressor, Fig 3a)."""
    return _i32(a) + _i32(b) + _i32(c) + 1


def exact4_value(a, b, c, d) -> Tensor:
    """Exact A+B+C+D+1 (proposed exact sign-focused compressor, Fig 3b)."""
    return exact3_value(a, b, c) + _i32(d)


# ---------------------------------------------------------------------------
# Truth tables (Table 2 of the paper, verbatim; packed index = A<<2|B<<1|C)
# ---------------------------------------------------------------------------

def _table(vals: Sequence[int]) -> np.ndarray:
    return np.asarray(vals, dtype=np.int64)


# exact values for reference:        A,B,C = 000 001 010 011 100 101 110 111
#                                    exact =  1   2   2   3   2   3   3   4
EXACT3 = Compressor("exact3", 3, _table([1, 2, 2, 3, 2, 3, 3, 4]), source="[2] exact / Fig 3a")

AC1 = Compressor("ac1_esposito2018", 3, _table([1, 2, 2, 2, 2, 2, 2, 2]), source="[4]")
AC2 = Compressor("ac2_guo2019", 3, _table([1, 1, 1, 3, 2, 3, 3, 2]), source="[5]")
AC3 = Compressor("ac3_strollo2020", 3, _table([1, 2, 2, 3, 1, 2, 2, 3]), source="[12] stacking")
AC4 = Compressor("ac4_du2024", 3, _table([3, 3, 3, 3, 2, 3, 3, 2]), source="[3]")
AC5 = Compressor("ac5_du2022", 3, _table([2, 2, 2, 2, 2, 3, 3, 3]), source="[2]")
PROPOSED3 = Compressor("proposed3", 3, _table([1, 3, 3, 3, 2, 3, 3, 3]), source="paper Fig 4a")

# Proposed A+B+C+D+1 (Table 3 reconstruction).
#   packed index = A<<3 | B<<2 | C<<1 | D ; exact = popcount+1
_PROP4_VALUES = []
for _i in range(16):
    _a = (_i >> 3) & 1
    _rest = _i & 0b0111
    _carry = 1 if _i else 0
    _sum = 0 if (_a == 1 and _rest == 0) else 1
    _PROP4_VALUES.append(2 * _carry + _sum)
PROPOSED4 = Compressor("proposed4", 4, _table(_PROP4_VALUES), source="paper Fig 4b / Table 3")

EXACT4 = Compressor(
    "exact4", 4, _table([bin(i).count("1") + 1 for i in range(16)]), source="Fig 3b"
)

# Reconstructed 4:2-family baselines used in Tables 4/5 rows [1] and [7]
# (the paper gives no truth tables for them; see repro.core.compressors for
# how they were reconstructed from the published error characteristics).

# [1] dual-quality 4:2 in low-quality mode: carry = OR, sum = ¬parity.
_AC_AKBARI_VALUES = []
for _i in range(16):
    _a, _b, _c, _d = (_i >> 3) & 1, (_i >> 2) & 1, (_i >> 1) & 1, _i & 1
    _carry = _a | _b | _c | _d
    _sum = 1 - (_a ^ _b ^ _c ^ _d)
    _AC_AKBARI_VALUES.append(2 * _carry + _sum)
AC_AKBARI = Compressor(
    "ac_akbari2017", 4, _table(_AC_AKBARI_VALUES), source="[1]", reconstructed=True
)

# [7] probability-based approximate 4:2: saturating 2-output compressor,
# +1 on the all-zero combo, −1/−2 on ≥3-one combos.
_AC_KRISHNA_VALUES = []
for _i in range(16):
    _exact = bin(_i).count("1") + 1
    _v = min(_exact, 3)
    if _i == 0:
        _v = 2
    _AC_KRISHNA_VALUES.append(_v)
AC_KRISHNA = Compressor(
    "ac_krishna2024", 4, _table(_AC_KRISHNA_VALUES), source="[7]", reconstructed=True
)

ALL_3INPUT = {c.name: c for c in [EXACT3, AC1, AC2, AC3, AC4, AC5, PROPOSED3]}
ALL_4INPUT = {c.name: c for c in [EXACT4, PROPOSED4, AC_AKBARI, AC_KRISHNA]}
ALL = {**ALL_3INPUT, **ALL_4INPUT}

# Paper-reported statistics for validation (Table 2 bottom rows).
PAPER_TABLE2_STATS = {
    # name: (P_E, E_mean) as printed in the paper
    "ac1_esposito2018": (22 / 64, 25 / 64),
    "ac2_guo2019": (9 / 64, 12 / 64),
    "ac3_strollo2020": (48 / 64, 48 / 64),
    "ac4_du2024": (18 / 64, -18 / 64),
    "ac5_du2022": (13 / 64, -5 / 64),
    "proposed3": (9 / 64, -3 / 64),
}
