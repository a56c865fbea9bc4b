"""A product table as an exact int8 GEMM plus a few bit-monomial int8 GEMMs.

The rows design of both contraction kernels (``csrc/rows_contract.cuh``)
runs on the INT8 tensor cores. It rests on one identity. Write a product
table of width n over the operands' n-bit two's-complement codes
``u = a mod 2^n`` (bits ``u_0 .. u_{n-1}``). Any function on the Boolean
cube is a multilinear polynomial with integer coefficients (the Möbius
transform over the code bits), so

    f(a, b) = a·b + Σ_S Π_{i∈S} a_i · E_S(b)

where a and b are the wrapped n-bit values and the sum runs over the
a-monomials S with a nonzero factor ``E_S(b) = Σ_T c_{S,T} Π_{j∈T} b_j``
(``c`` the Möbius transform of the error table ``f − a·b`` on both axes).
Summed over k:

    Σ_k f(a_mk, w_kn) = (A @ W)[m,n] + Σ_S (A_S @ E_S(W))[m,n] + K·E_∅

with ``A_S[m,k] = [u(a_mk) & S == S]`` a 0/1 bit test and ``E_S(W)`` a
small-integer map of the weight codes. The constant monomial S = ∅ is
``f(0, b)``, which is the constant f(0,0) for every product table of a CSP
wiring (``K·f00`` in the epilogue); a table where it varies with b keeps it
as one more plane, ``E_∅(b) − f00``, under the bit test of the empty mask,
which is always 1.

:func:`decompose` turns a table into :class:`Decomposition` planes, each an
int8 GEMM: ``scale · [u & mask == mask] @ factor(W)``. A factor that fits
int8 is one plane (scale +1); one whose negation fits is one plane of scale
−1 (proposed@8's factors reach +128 but never −128); any other is split
exactly, ``v = lo + 256·hi`` with lo in [−128, 127], into a plane of scale
+1 and one of scale 256. R, the number of planes, is 19 at proposed@8 and 0
at ``exact``. :func:`Decomposition.rebuild` gives the table back from the
planes, and :func:`decompose` raises if it does not.

:func:`device_planes` lays the planes out as the kernel reads them: per
plane the bit mask and the A-side byte (+1, −1, or +64 with the factor
times 4 for a scale-256 plane, so that every plane adds into one int32
accumulator), and one row of packed int8 factors per raw int8 weight code.

:func:`cached` keeps one decomposition per key, as ``build.device_constant``
keeps one device table per key.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Hashable, Optional, Tuple

import numpy as np

#: the most planes the rows kernel takes (``RC_MAX_PLANES``: the words of
#: its plane masks and A-side bytes); a table that needs more runs the tile
#: design
MAX_PLANES = 32
#: a scale-256 plane's factor times 4 must fit int8 (the kernel's A-side
#: byte of such a plane is 64)
_MAX_HI = 31

_CACHE_LOCK = threading.Lock()
_CACHE: Dict[Hashable, "Decomposition"] = {}


@dataclasses.dataclass(frozen=True)
class Decomposition:
    """A product table of width ``n_bits`` as int8 planes.

    ``f(a, b) = a·b + f00 + Σ_r scales[r] · [u(a) & masks[r] == masks[r]]
    · factors[r, u(b)]`` for every pair of wrapped n-bit operands, ``u`` the
    unsigned n-bit code. ``factors`` is (R, 2^n) int8."""

    n_bits: int
    f00: int
    masks: Tuple[int, ...]
    scales: Tuple[int, ...]
    factors: np.ndarray
    #: nonzero monomial pairs (S, T) of the error term, S ≠ ∅ (a statistic)
    pairs: int

    @property
    def planes(self) -> int:
        """R: the number of int8 bit-monomial GEMMs besides the exact one."""
        return len(self.masks)

    def rebuild(self) -> np.ndarray:
        """The (2^n, 2^n) int64 table ``[u(a), u(b)]`` the planes give."""
        n = self.n_bits
        codes = np.arange(1 << n)
        signed = _signed(codes, n)
        out = signed[:, None] * signed[None, :] + self.f00
        for mask, scale, fac in zip(self.masks, self.scales, self.factors):
            bit = (codes & mask) == mask
            out = out + scale * bit[:, None] * fac.astype(np.int64)[None, :]
        return out


def _signed(codes: np.ndarray, n: int) -> np.ndarray:
    """Unsigned n-bit codes → their two's-complement values, int64."""
    codes = codes.astype(np.int64)
    return np.where(codes >= 1 << (n - 1), codes - (1 << n), codes)


def _mobius(t: np.ndarray, n: int) -> np.ndarray:
    """The subset Möbius transform of ``t`` over the n bits of axis 0:
    ``out[S] = Σ_{S'⊆S} (−1)^{|S∖S'|} t[S']``, exact in int64."""
    t = np.array(t, dtype=np.int64)
    idx = np.arange(1 << n)
    for i in range(n):
        hi = idx[(idx >> i) & 1 == 1]
        t[hi] -= t[hi ^ (1 << i)]
    return t


def _fits8(v: np.ndarray) -> bool:
    return bool(v.min() >= -128 and v.max() <= 127)


def decompose(flat: np.ndarray) -> Decomposition:
    """The planes of a flat (2^(2n),) product table in ``core.lut.flat_lut``
    layout (``[(a + 2^(n−1)) mod 2^n << n | (b + 2^(n−1)) mod 2^n]``).

    Raises ValueError for a table that is not of that length, or whose
    factors need a scale-256 part beyond ±31 (no product table of widths
    3..8 does), or if the planes do not rebuild the table exactly."""
    flat = np.asarray(flat).astype(np.int64).reshape(-1)
    n = (flat.size.bit_length() - 1) // 2
    if flat.size != 1 << (2 * n) or n < 1:
        raise ValueError(f"not a flat product table: {flat.size} entries")
    off = 1 << (n - 1)
    codes = np.arange(1 << n)
    signed = _signed(codes, n)
    xi = codes ^ off  # the table's row / column of each unsigned code
    table = flat.reshape(1 << n, 1 << n)[xi[:, None], xi[None, :]]
    err = table - signed[:, None] * signed[None, :]
    fac = _mobius(err, n)  # fac[S, u(b)] = E_S(b)
    f00 = int(fac[0, 0])
    pairs = int(np.count_nonzero(_mobius(fac[1:].T, n)))
    masks, scales, factors = [], [], []
    rows = [(0, fac[0] - f00)] + [(s, fac[s]) for s in range(1, 1 << n)]
    for mask, v in rows:
        if not v.any():
            continue
        if _fits8(v):
            parts = [(1, v)]
        elif _fits8(-v):
            parts = [(-1, -v)]
        else:
            lo = ((v + 128) & 255) - 128
            hi = (v - lo) >> 8
            if np.abs(hi).max() > _MAX_HI:
                raise ValueError(f"a factor of the width-{n} table reaches "
                                 f"{int(np.abs(v).max())}: beyond int8 planes")
            parts = [(1, lo), (256, hi)]
        for scale, part in parts:
            masks.append(int(mask))
            scales.append(scale)
            factors.append(part.astype(np.int8))
    d = Decomposition(n, f00, tuple(masks), tuple(scales),
                      np.array(factors, dtype=np.int8).reshape(-1, 1 << n), pairs)
    if not np.array_equal(d.rebuild(), table):
        raise ValueError("the planes do not rebuild the product table")
    return d


def try_decompose(flat: np.ndarray) -> Optional[Decomposition]:
    """:func:`decompose`, or None for a table it cannot take or one with
    more than :data:`MAX_PLANES` planes (such tables run the tile design)."""
    try:
        d = decompose(flat)
    except ValueError:
        return None
    return d if d.planes <= MAX_PLANES else None


def cached(key: Hashable, make: Callable[[], Optional[Decomposition]]
           ) -> Optional[Decomposition]:
    """``make()`` once per key (thread-safe), as ``build.device_constant``
    keeps device tables: the decomposition of a wiring's table is a pure
    function of its key."""
    with _CACHE_LOCK:
        if key not in _CACHE:
            _CACHE[key] = make()
        return _CACHE[key]


def device_planes(d: Decomposition) -> np.ndarray:
    """The planes as ``rows_contract.cuh`` reads them: one flat int32 array
    of ``2·MAX_PLANES + 256·G`` words.

    Words [0, 32): each plane's n-bit mask replicated in the 4 bytes of a
    word. Words [32, 64): the A-side byte of each plane replicated: 0x01
    (+1), 0xFF (−1), 0x40 (+64, a scale-256 plane whose device factor is
    4·hi: 64·4 = 256). Unused planes are 0. Then 256 rows of G words, G =
    ⌈R/4⌉ made odd (an odd row stride spreads random rows over the
    shared-memory banks): row ``c`` holds the device factors of the raw int8
    weight code ``c`` (as uint8; its low n bits pick the factor), plane
    4g + q in byte q of word g."""
    r = d.planes
    if r > MAX_PLANES:
        raise ValueError(f"{r} planes, the kernel takes {MAX_PLANES}")
    groups = max(1, (r + 3) // 4) | 1
    head = np.zeros((2, MAX_PLANES), np.uint32)
    dev = np.zeros((groups * 4, 256), np.int64)
    low = np.arange(256) & ((1 << d.n_bits) - 1)
    byte = {1: 0x01, -1: 0xFF, 256: 0x40}
    for i, (mask, scale) in enumerate(zip(d.masks, d.scales)):
        head[0, i] = mask * 0x01010101
        head[1, i] = byte[scale] * 0x01010101
        dev[i] = d.factors[i].astype(np.int64)[low] * (4 if scale == 256 else 1)
    u8 = (dev & 0xFF).astype(np.uint32).reshape(groups, 4, 256)
    words = u8[:, 0] | u8[:, 1] << 8 | u8[:, 2] << 16 | u8[:, 3] << 24
    return np.concatenate([head.reshape(-1), words.T.reshape(-1)]).view(np.int32)
