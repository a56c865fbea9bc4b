"""Baugh-Wooley approximate signed multiplier, width-parametric (paper §3).

Counterpart of ``repro.core.multiplier``; every function here takes and
returns int32 tensors (any device) and is bit-identical to the JAX model.

Two independent implementations of the proposed multiplier family, both
defined for arbitrary operand width ``n``:

* :func:`approx_multiply_with` — the *closed form*: exact product +
  truncation removal + compensation + compressor error injections.
* :class:`StructuralMultiplier` — an explicit PPM / reduction-tree model
  that wires every partial-product bit through the compressors slot by slot.

Width contract
==============

* Supported widths: ``MIN_BITS (3) <= n <= MAX_BITS (16)`` for the CSP
  wirings; :func:`exact_baugh_wooley` additionally accepts ``n == 2``. The
  2n-bit product of 16-bit operands exactly fills the int32 ring.
* Operand range: signed n-bit two's complement. Out-of-range ints are
  **wrapped** into that range (low n bits, sign-extended) before the model is
  applied, so the closed form, the structural model and the LUT gather agree
  on arbitrary int inputs.
* Output: the 2n-bit two's-complement product value (wrapped via
  :func:`wrap_to_width`).

CSP wiring: three sign-focused compressor slots at columns n-1 / n-1 / n
(``c1a``: 4-input, +1 = compensation; ``c1b``: 3-input, +1 = converted
¬(a_{n-1}·b_0); ``c3``: 4-input, +1 = Baugh-Wooley constant), fed by the
taps :func:`csp_slot_taps` lists. See ``repro.core.multiplier`` and
``docs/compressors.md`` for the derivation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.core import compressors as comp

Tensor = torch.Tensor

N_BITS = 8
OUT_BITS = 2 * N_BITS

MIN_BITS = 3   # below this the CSP columns degenerate to nothing
MAX_BITS = 16  # 2n-bit products must fit the int32 two's-complement ring

# ``csp_axcK`` selects the CSP framework with approximate compressor design
# AC-K (Table 2 numbering) in its sign-focused slots.
WIRING_ALIASES: Dict[str, str] = {
    "csp_axc1": "design_esposito2018",
    "csp_axc2": "design_guo2019",
    "csp_axc3": "design_strollo2020",
    "csp_axc4": "design_du2024",
    "csp_axc5": "design_du2022",
    "csp_akbari": "design_akbari2017",
    "csp_krishna": "design_krishna2024",
}


def _require_width(n: int) -> None:
    if not (MIN_BITS <= n <= MAX_BITS):
        raise ValueError(
            f"operand width must be in [{MIN_BITS}, {MAX_BITS}] (int32 models"
            f" cannot represent a {2 * n}-bit product ring); got n={n}")


def split_width(key: str, default: int = N_BITS) -> tuple[str, int]:
    """``"name[@N]"`` → (name, N). A bare name reads as the default width.

    The width must be a bare ASCII decimal integer — ``"@ 8"`` / ``"@+8"``
    are rejected rather than silently normalized.
    """
    base, sep, w = str(key).partition("@")
    if not sep:
        return base, default
    if not (w.isascii() and w.isdigit()):
        raise ValueError(f"bad width suffix in multiplier key {key!r}")
    n = int(w)
    _require_width(n)
    return base, n


def canonical_key(key: str) -> str:
    """Resolve aliases and normalize the width suffix (``@8`` is implicit)."""
    base, n = split_width(key)
    base = WIRING_ALIASES.get(base, base)
    if base != "exact" and base not in WIRINGS:
        raise ValueError(f"unknown multiplier wiring: {base!r}")
    return base if n == N_BITS else f"{base}@{n}"


def _i32(x) -> Tensor:
    return torch.as_tensor(x).to(torch.int32)


def _bit(x: Tensor, i: int) -> Tensor:
    """i-th bit of the two's-complement representation (int32 0/1)."""
    return (_i32(x) >> i) & 1


def _const32(v: int) -> int:
    """Python constant → int32-representable value (mod 2^32)."""
    v &= (1 << 32) - 1
    return v - (1 << 32) if v >= (1 << 31) else v


def wrap_to_width(x, out_bits: int) -> Tensor:
    """Reduce an int32 value to ``out_bits``-bit two's complement (int32).

    For ``out_bits >= 32`` this is the identity: int32 arithmetic already
    wraps mod 2^32.
    """
    x = _i32(x)
    if out_bits >= 32:
        return x
    u = x & ((1 << out_bits) - 1)
    return torch.where(u >= (1 << (out_bits - 1)), u - (1 << out_bits), u)


def wrap_int16(x) -> Tensor:
    """Reduce an int32 value to 16-bit two's complement (as int32)."""
    return wrap_to_width(x, OUT_BITS)


def wrap_operand(x, n: int = N_BITS) -> Tensor:
    """Wrap an int into the signed n-bit operand domain (low n bits)."""
    return wrap_to_width(x, n)


# ---------------------------------------------------------------------------
# Exact Baugh-Wooley construction (validation of the PPM model, Fig. 1)
# ---------------------------------------------------------------------------


def exact_baugh_wooley(a, b, n: int = N_BITS) -> Tensor:
    """Exact signed product via the BW PPM (pos ANDs, NANDs, constants)."""
    a = wrap_operand(a, n)
    b = wrap_operand(b, n)
    total = torch.zeros_like(a)
    s = n - 1
    for i in range(s):
        for j in range(s):
            total = total + ((_bit(a, i) & _bit(b, j)) << (i + j))
    for i in range(s):  # complemented row against b's sign bit
        total = total + ((1 - (_bit(a, i) & _bit(b, s))) << (i + s))
    for j in range(s):  # complemented row against a's sign bit
        total = total + ((1 - (_bit(a, s) & _bit(b, j))) << (j + s))
    total = total + ((_bit(a, s) & _bit(b, s)) << (2 * s))
    total = total + _const32((1 << n) + (1 << (2 * n - 1)))  # BW constants
    return wrap_to_width(total, 2 * n)


def truncated_sum(a, b, n: int = N_BITS) -> Tensor:
    """Arithmetic value of the truncated LSP partial products (cols 0..n-2)."""
    a = wrap_operand(a, n)
    b = wrap_operand(b, n)
    t = torch.zeros_like(a)
    for i in range(n - 1):
        for j in range(n - 1 - i):
            t = t + ((_bit(a, i) & _bit(b, j)) << (i + j))
    return t


def compensation_constant(n: int = N_BITS) -> int:
    """Constant 1s approximating E[T_T] (Eq. 5): ``(n-2) · 2^(n-3)``."""
    _require_width(n)
    return (n - 2) << (n - 3)


def expected_truncation(n: int = N_BITS) -> float:
    """E[T_T] per Eq. (5): sum_q (1/4)(q+1) 2^q = (n-2)·2^(n-3) + 1/4."""
    return sum(0.25 * (q + 1) * 2**q for q in range(n - 1))


# ---------------------------------------------------------------------------
# CSP wiring (three sign-focused compressor slots)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CSPWiring:
    """Which compressor design sits in each of the three CSP slots.

    ``c1a`` (col n-1, 4-input slot, +1 = compensation), ``c1b`` (col n-1,
    3-input slot, +1 = converted ¬(a_{n-1}·b_0)), ``c3`` (col n, 4-input
    slot, +1 = BW constant). 3-input designs in a 4-input slot consume one
    fewer positive pp; 4-input designs in the ``c1b`` slot (and slots whose
    column has fewer taps than the design has inputs) are indexed with the
    missing inputs at 0.
    """

    name: str
    c1a: comp.Compressor
    c1b: comp.Compressor
    c3: comp.Compressor


def csp_slot_taps(n: int) -> tuple[list, list, list]:
    """Positive-pp (i, j) taps feeding each CSP slot at width n.

    Column n-1 holds p(i, n-1-i) for i in 1..n-2: C1a takes i ∈ {1,2,3},
    C1b takes i ∈ {4,5,6}. Column n holds p(i, n-i) for i in 2..n-2: C3
    takes i ∈ {2,3,4}.
    """
    c1a = [(i, n - 1 - i) for i in range(1, min(4, n - 1))]
    c1b = [(i, n - 1 - i) for i in range(4, min(7, n - 1))]
    c3 = [(i, n - i) for i in range(2, min(5, n - 1))]
    return c1a, c1b, c3


def _slot_index(c: comp.Compressor, neg, pps, zero: Tensor) -> Tensor:
    """Pack the truth-table index for a compressor slot (bits truncated to
    the design's arity, or zero-padded up to it)."""
    bits = ([neg] if neg is not None else []) + list(pps)
    bits = bits[: c.n_inputs]
    while len(bits) < c.n_inputs:
        bits.append(zero)
    return comp.pack_bits(bits)


def _csp_errors(a: Tensor, b: Tensor, w: CSPWiring,
                n: int = N_BITS) -> tuple[Tensor, Tensor, Tensor]:
    """Per-slot (approx − exact) error values e_C1a, e_C1b, e_C3 at width n."""
    a = _i32(a)
    b = _i32(b)
    zero = torch.zeros_like(a)
    t1a, t1b, t3 = csp_slot_taps(n)

    def pp(ij):
        return _bit(a, ij[0]) & _bit(b, ij[1])

    neg0 = 1 - (_bit(a, 0) & _bit(b, n - 1))  # ¬(a0·b_{n-1})
    neg1 = 1 - (_bit(a, 1) & _bit(b, n - 1))  # ¬(a1·b_{n-1})
    e1a = w.c1a.error_packed(_slot_index(w.c1a, neg0, [pp(t) for t in t1a], zero))
    e1b = w.c1b.error_packed(_slot_index(w.c1b, None, [pp(t) for t in t1b], zero))
    e3 = w.c3.error_packed(_slot_index(w.c3, neg1, [pp(t) for t in t3], zero))
    return e1a, e1b, e3


# ---------------------------------------------------------------------------
# Closed-form multipliers
# ---------------------------------------------------------------------------


def approx_multiply_with(a, b, wiring: CSPWiring, n: int = N_BITS) -> Tensor:
    """Approximate n×n signed product with the given CSP compressor set.

    approx(a,b) = a·b − trunc + comp_n + 2^{n-1}·(a_{n-1}·b_0)
                  + 2^{n-1}·(e_C1a + e_C1b) + 2^n·e_C3       (mod 2^{2n})
    """
    _require_width(n)
    a = wrap_operand(a, n)
    b = wrap_operand(b, n)
    a, b = torch.broadcast_tensors(a, b)
    exact = a * b
    t = truncated_sum(a, b, n)
    conv = _bit(a, n - 1) & _bit(b, 0)  # ¬(a_{n-1}·b_0) → constant-1 conversion
    e1a, e1b, e3 = _csp_errors(a, b, wiring, n)
    raw = (exact - t + compensation_constant(n) + (conv << (n - 1))
           + ((e1a + e1b) << (n - 1)) + (e3 << n))
    return wrap_to_width(raw, 2 * n)


PROPOSED_WIRING = CSPWiring("proposed", comp.PROPOSED4, comp.EXACT3, comp.EXACT4)
EXACT_CSP_WIRING = CSPWiring("trunc_exact_csp", comp.EXACT4, comp.EXACT3, comp.EXACT4)


def approx_multiply(a, b) -> Tensor:
    """The paper's proposed approximate signed multiplier (8-bit closed form)."""
    return approx_multiply_with(a, b, PROPOSED_WIRING)


def exact_multiply(a, b) -> Tensor:
    """Exact signed product (reference; width-agnostic)."""
    return _i32(a) * _i32(b)


# Baseline multipliers: each literature compressor dropped into the
# truncated/compensated framework (paper §5.1), with the deployment density
# of its source paper (see repro.core.multiplier).
BASELINE_WIRINGS: Dict[str, CSPWiring] = {
    "design_esposito2018": CSPWiring("design_esposito2018", comp.AC1, comp.AC1,
                                     comp.EXACT4),
    "design_guo2019": CSPWiring("design_guo2019", comp.AC2, comp.AC2, comp.EXACT4),
    "design_strollo2020": CSPWiring("design_strollo2020", comp.AC3, comp.AC3,
                                    comp.EXACT4),
    "design_du2024": CSPWiring("design_du2024", comp.AC4, comp.EXACT3, comp.EXACT4),
    "design_du2022": CSPWiring("design_du2022", comp.AC5, comp.EXACT3, comp.EXACT4),
    "design_akbari2017": CSPWiring("design_akbari2017", comp.AC_AKBARI,
                                   comp.EXACT3, comp.EXACT4),
    "design_krishna2024": CSPWiring("design_krishna2024", comp.AC_KRISHNA,
                                    comp.EXACT3, comp.EXACT4),
}

# Every named CSP wiring. Aliases in WIRING_ALIASES resolve onto these.
WIRINGS: Dict[str, CSPWiring] = {
    "proposed": PROPOSED_WIRING,
    "trunc_exact_csp": EXACT_CSP_WIRING,
    **BASELINE_WIRINGS,
}


def get_wiring(name: str) -> CSPWiring:
    """Resolve a wiring name (or ``csp_*`` alias) to its CSPWiring."""
    name = WIRING_ALIASES.get(name, name)
    try:
        return WIRINGS[name]
    except KeyError:
        raise ValueError(f"unknown multiplier wiring: {name!r}") from None


def make_multiplier(name: str, n: int = N_BITS) -> Callable[[Tensor, Tensor], Tensor]:
    """Width-n product callable for a wiring name (or ``"exact"``)."""
    if name == "exact":
        return exact_multiply
    w = get_wiring(name)
    _require_width(n)

    def fn(a, b, _w=w, _n=n) -> Tensor:
        return approx_multiply_with(a, b, _w, n=_n)

    fn.__name__ = f"{name}@{n}" if n != N_BITS else name
    return fn


def resolve_multiplier(key: str, n: int | None = None
                       ) -> tuple[str, Callable[[Tensor, Tensor], Tensor], int]:
    """``"name[@N]"`` (+ optional explicit width) → (canonical_key, fn, N)."""
    base, kn = split_width(key)
    if not base:
        raise ValueError(
            f"malformed multiplier key {key!r}: a width needs a wiring name "
            "(name[@N]), e.g. 'proposed@4'")
    width = n if n is not None else kn
    base = WIRING_ALIASES.get(base, base)
    key_c = base if width == N_BITS else f"{base}@{width}"
    return key_c, make_multiplier(base, width), width


# All registered product models. Bare names are the 8-bit designs; ``@4`` /
# ``@16`` variants instantiate the same wiring at the other verified widths.
ALL_MULTIPLIERS: Dict[str, Callable[[Tensor, Tensor], Tensor]] = {
    "exact": exact_multiply,
    **{name: make_multiplier(name) for name in WIRINGS},
    **{f"{name}@{w}": make_multiplier(name, w)
       for name in WIRINGS for w in (4, 16)},
}


def default_width_names() -> list[str]:
    """The 8-bit design names (the paper's sweep set, no @N variants)."""
    return [k for k in ALL_MULTIPLIERS if "@" not in k]


# ---------------------------------------------------------------------------
# Structural model (independent cross-check of the closed form)
# ---------------------------------------------------------------------------


class StructuralMultiplier:
    """Explicit PPM / reduction-tree model of a CSP-framework multiplier.

    Builds every kept partial-product bit at width n, places the three CSP
    compressors' output values into their columns (via the truth tables),
    reduces the rest exactly and wraps to 2n-bit two's complement. C1a's +1
    realizes the 2^(n-1) compensation bit, C1b's +1 the converted
    ¬(a_{n-1}·b_0) constant, C3's +1 the BW constant 2^n; the remaining
    compensation and the BW 2^{2n-1} constant are added directly.
    """

    def __init__(self, n: int = N_BITS, wiring: CSPWiring = PROPOSED_WIRING):
        _require_width(n)
        self.n = n
        self.wiring = wiring

    def __call__(self, a, b) -> Tensor:
        n, w = self.n, self.wiring
        s = n - 1
        a = wrap_operand(a, n)
        b = wrap_operand(b, n)
        a, b = torch.broadcast_tensors(a, b)
        zero = torch.zeros_like(a)
        total = torch.zeros_like(a)

        def pos(i, j):
            return _bit(a, i) & _bit(b, j)

        def neg_row(i):  # ¬(a_i · b_{n-1}) at column i+n-1
            return 1 - (_bit(a, i) & _bit(b, s))

        def neg_col(j):  # ¬(a_{n-1} · b_j) at column j+n-1
            return 1 - (_bit(a, s) & _bit(b, j))

        t1a, t1b, t3 = csp_slot_taps(n)
        consumed = set()

        def feed(c, neg_bit, taps):
            """Truth-table value of a slot + the taps it consumed."""
            n_fed = min((0 if neg_bit is None else 1) + len(taps), c.n_inputs)
            fed_taps = taps[: n_fed - (0 if neg_bit is None else 1)]
            idx = _slot_index(c, neg_bit, [pos(i, j) for i, j in taps], zero)
            return c.apply_packed(idx), fed_taps

        # C1a @ col n-1: 4-input slot, +1 = compensation bit 2^(n-1)
        v1a, fed = feed(w.c1a, neg_row(0), t1a)
        consumed |= {("nr", 0)} | {("p", i, j) for i, j in fed}
        total = total + (v1a << (n - 1))

        # C1b @ col n-1: 3-input slot, +1 = converted ¬(a_{n-1}·b_0)
        v1b, fed = feed(w.c1b, None, t1b)
        consumed |= {("nc", 0)} | {("p", i, j) for i, j in fed}
        total = total + (v1b << (n - 1))

        # C3 @ col n: 4-input slot, +1 = BW constant 2^n
        v3, fed = feed(w.c3, neg_row(1), t3)
        consumed |= {("nr", 1)} | {("p", i, j) for i, j in fed}
        total = total + (v3 << n)

        # remaining PPM bits, reduced exactly
        for i in range(s):
            for j in range(s):
                if i + j <= s - 1:
                    continue  # truncated LSP (cols 0..n-2)
                if ("p", i, j) in consumed:
                    continue
                total = total + (pos(i, j) << (i + j))
        for i in range(s):
            if ("nr", i) in consumed:
                continue
            total = total + (neg_row(i) << (i + s))
        for j in range(s):
            if ("nc", j) in consumed:
                continue
            total = total + (neg_col(j) << (j + s))
        total = total + (pos(s, s) << (2 * s))

        total = total + _const32(1 << (2 * n - 1))  # BW constant at 2^(2n-1)
        # compensation beyond the 2^(n-1) bit realized by C1a's "+1"
        total = total + (compensation_constant(n) - (1 << (n - 1)))
        return wrap_to_width(total, 2 * n)
