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

_CACHE_LOCK = threading.RLock()  # a maker may take another cached value
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


# ---------------------------------------------------------------------------
# The wide design's planes: the closed form at widths 9..16
# ---------------------------------------------------------------------------
#
# A 2^(2n)-entry table is 2^32 entries at width 16, so the wide design's
# planes come from the closed form's parameter block instead. Before its
# final wrap to 2n bits the closed form is
#
#     raw(a, b) = a·b − trunc(a, b) + rest(a, b),
#     trunc(a, b) = Σ_{i<n−1} u(a)_i · 2^i · (u(b) & (2^{n−1−i} − 1)),
#
# and rest (the compensation constant, the NAND conversion and the three
# slots' compressor errors) is a function of the few partial-product bits
# each slot reads. The 2n-bit wrap never fires for any registered wiring
# (``wide_planes`` checks the planes against the wrapped closed form), so
# f = raw and Σ_k f is a linear sum of these terms in the int32 ring. The
# Möbius transform of rest over the code bits of both operands has a few
# monomial pairs (S, T), each c·[u(a) ⊇ S]·[u(b) ⊇ T], all inside the
# subsets of one slot's a- and b-bits (or the conversion's a_{n−1}·b_0),
# so it is evaluated at those codes alone. The planes, each an 8-bit
# GEMM ``sign · 2^shift · A(a) @ B(b)``:
#
# * the exact product in bytes: the wrapped operands' unsigned low byte and
#   signed high byte, four GEMMs at scales 1, 256, 256, 65536;
# * the truncation: for each bit i < n − 1 the single-bit byte
#   [u(a)_i]·2^(i mod 8) against the bytes of u(b) & (2^{n−1−i} − 1), at
#   scale −256^(i div 8) (and −256^(i div 8 + 1) for the high byte); the
#   planes of one b side and scale merge by their a masks
#   (``_merge_masked``): bits i ≤ n − 9 all meet the whole low byte of b,
#   so they fold into the exact LO·LO plane, which they cancel at width 16;
# * each pair (S, T) of rest: [u(a) ⊇ S]·α against [u(b) ⊇ T]·β with α·β·
#   256^g = c, the constant pair (∅, ∅) being f(0, 0), added K times.
#
# Each side of a plane is one of a few functions of an operand's two bytes,
# which the kernel evaluates in registers on four codes a word.

#: widths of the wide design (``WD_MIN_BITS`` / ``WD_MAX_BITS`` in
#: wide_contract.cuh)
WIDE_MIN_BITS = 9
WIDE_MAX_BITS = 16
#: the most planes and accumulator groups the wide kernel takes
WIDE_MAX_PLANES = 64
WIDE_MAX_GROUPS = 8
#: int32 words of one plane in the kernel's parameter block
WIDE_PLANE_WORDS = 12
WIDE_PARAM_LEN = 2 + 2 * WIDE_MAX_GROUPS + WIDE_MAX_PLANES * WIDE_PLANE_WORDS

#: operand functions of a wide plane's side, on an operand's wrapped n-bit
#: value x and its unsigned code u: the low byte x & 255 (u8), the high
#: byte x >> 8 (s8), the low byte under a mask (u8), the high byte under a
#: mask (u8), and the bit test [u & mask == mask] times a byte (s8)
LO, HI, AND_LO, AND_HI, TEST = range(5)
_SIGNED_SIDE = {LO: False, HI: True, AND_LO: False, AND_HI: False, TEST: True}


@dataclasses.dataclass(frozen=True)
class WideSide:
    """One side of a wide plane: ``kind`` with its ``mask`` (AND_*: a byte;
    TEST: an n-bit mask) and ``byte`` (TEST's factor, −128..127)."""

    kind: int
    mask: int = 0
    byte: int = 0

    def value(self, x, n: int):
        """The side's byte value at wrapped n-bit operands ``x``: an int64
        numpy array or torch tensor, of which the result is one too."""
        if self.kind == LO:
            return x & 255
        if self.kind == HI:
            return x >> 8
        if self.kind == AND_LO:
            return x & self.mask
        if self.kind == AND_HI:
            return (x >> 8) & self.mask
        u = x & ((1 << n) - 1)
        return ((u & self.mask) == self.mask) * self.byte


@dataclasses.dataclass(frozen=True)
class WidePlane:
    """``sign · 2^shift · a(x_a) · b(x_b)`` summed over k: one 8-bit GEMM."""

    a: WideSide
    b: WideSide
    shift: int
    sign: int

    @property
    def group(self) -> tuple:
        """The accumulator group: planes of one (sign, shift) share one."""
        return (-self.sign, self.shift)


@dataclasses.dataclass(frozen=True)
class WidePlanes:
    """The closed form of one wiring at width ``n_bits`` (9..16) as wide
    planes: ``f(a, b) = f00 + Σ_p plane_p(a, b)`` for every pair of wrapped
    n-bit operands, exact as integers (the 2n-bit wrap never fires)."""

    n_bits: int
    f00: int
    planes: Tuple[WidePlane, ...]
    #: the pairs (S, T) of rest besides (∅, ∅), for the record
    pairs: Tuple[Tuple[int, int, int], ...]

    @property
    def groups(self) -> Tuple[tuple, ...]:
        """The accumulator groups in the planes' order."""
        return tuple(dict.fromkeys(p.group for p in self.planes))

    def rebuild(self, a, b) -> np.ndarray:
        """f at operand pairs (any integers, wrapped to n bits first), as
        int64 and unwrapped: equal to the closed form where no wrap fires."""
        n = self.n_bits
        xa, xb = _wrap_n(a, n), _wrap_n(b, n)
        out = np.full(np.broadcast(xa, xb).shape, self.f00, np.int64)
        for p in self.planes:
            out += (p.sign << p.shift) * p.a.value(xa, n) * p.b.value(xb, n)
        return out


def _wrap_n(x, n: int) -> np.ndarray:
    """Integers → their wrapped n-bit values (the low n bits, signed)."""
    x = np.asarray(x, dtype=np.int64) & ((1 << n) - 1)
    return np.where(x >= 1 << (n - 1), x - (1 << n), x)


def _subsets(bits):
    """Every subset of ``bits`` as a bit mask."""
    out = [0]
    for b in bits:
        out += [s | (1 << b) for s in out]
    return out


def _pair_parts(c: int) -> list:
    """(shift, α, β) with Σ α·β·2^shift = c, α in −128..127, β in 1..127,
    shift in {0, 8, 16}: one part where the coefficient allows."""
    shift = 0
    while c % 256 == 0 and shift < 16:
        c //= 256
        shift += 8
    for beta in range(1, 128):
        if c % beta == 0 and -128 <= c // beta <= 127:
            return [(shift, c // beta, beta)]
    if shift == 16:
        raise ValueError(f"a monomial coefficient {c} << 16 beyond the "
                         "wide planes")
    lo = ((c + 128) & 255) - 128
    return _pair_parts_at(lo, shift) + _pair_parts_at((c - lo) // 256, shift + 8)


def _pair_parts_at(c: int, shift: int) -> list:
    return [(s + shift, a, b) for s, a, b in _pair_parts(c)] if c else []


def _merge_masked(planes: list) -> list:
    """Planes whose a side is a masked byte (LO being the low byte under
    0xFF) and that share a b side and a shift, merged by their a masks:
    Σ_p sign_p·(x & mask_p) is Σ_c c·(x & M_c) over the net coefficients c
    of the byte's bits, M_c the bits of coefficient c, so bits that cancel
    drop out. The truncation's bits i ≤ n − 9 share the b side LO, so they
    fold into the exact product's LO·LO plane (cancelling it at width 16)."""
    merged, at = {}, []
    for pl in planes:
        family = {LO: AND_LO, AND_LO: AND_LO, AND_HI: AND_HI}.get(pl.a.kind)
        if family is None:
            at.append(pl)
            continue
        key = (family, pl.b, pl.shift)
        if key not in merged:
            merged[key] = [0] * 8
            at.append(key)
        mask = 0xFF if pl.a.kind == LO else pl.a.mask
        for j in range(8):
            merged[key][j] += pl.sign * (mask >> j & 1)
    out = []
    for item in at:
        if isinstance(item, WidePlane):
            out.append(item)
            continue
        family, b, shift = item
        coef = merged[item]
        for c in sorted(set(coef) - {0}, reverse=True):
            mask = sum(1 << j for j in range(8) if coef[j] == c)
            a = WideSide(LO) if family == AND_LO and mask == 0xFF \
                else WideSide(family, mask)
            for k in range(abs(c).bit_length()):  # c as a sum of powers of 2
                if abs(c) >> k & 1:
                    out.append(WidePlane(a, b, shift + k, 1 if c > 0 else -1))
    return out


def wide_planes(params) -> WidePlanes:
    """The wide planes of a closed form's parameter block
    (``kernels.closed_form.closed_form_params``) at widths 9..16.

    Raises ValueError at another width, for more than
    :data:`WIDE_MAX_PLANES` planes or :data:`WIDE_MAX_GROUPS` groups, or if
    the planes do not give the closed form back on every pair of the
    codes they were derived from, the extreme operands and 2^14 pairs drawn
    from a fixed seed (the CPU tests hold them exhaustively at 9..11)."""
    import torch

    from repro_torch.kernels.closed_form import (MAX_TAPS, SLOT_LEN,
                                                 closed_form_from_params)
    p = [int(v) for v in np.asarray(params)]
    n = p[0]
    if not WIDE_MIN_BITS <= n <= WIDE_MAX_BITS:
        raise ValueError(f"the wide planes take widths {WIDE_MIN_BITS}.."
                         f"{WIDE_MAX_BITS}, got {n}")
    planes = [WidePlane(WideSide(LO), WideSide(LO), 0, 1),
              WidePlane(WideSide(LO), WideSide(HI), 8, 1),
              WidePlane(WideSide(HI), WideSide(LO), 8, 1),
              WidePlane(WideSide(HI), WideSide(HI), 16, 1)]
    for i in range(n - 1):
        m = (1 << (n - 1 - i)) - 1
        a = WideSide(AND_LO if i < 8 else AND_HI, 1 << (i % 8))
        base = 8 * (i // 8)
        b_lo = WideSide(LO) if m & 255 == 255 else WideSide(AND_LO, m & 255)
        planes.append(WidePlane(a, b_lo, base, -1))
        if m >> 8:
            planes.append(WidePlane(a, WideSide(AND_HI, m >> 8), base + 8, -1))
    planes = _merge_masked(planes)

    # candidate (S, T): the subsets of each slot's a- and b-bits, and the
    # conversion's a_{n-1} b_0
    slots = [((n - 1,), (0,))]
    for s in range(3):
        q = p[2 + s * SLOT_LEN: 2 + (s + 1) * SLOT_LEN]
        if q[0] == 0:
            continue
        abits = ([q[2]] if q[2] >= 0 else []) + [q[4 + 2 * t] for t in range(q[3])]
        bbits = ([n - 1] if q[2] >= 0 else []) + [q[5 + 2 * t] for t in range(q[3])]
        assert len(abits) <= 1 + MAX_TAPS
        slots.append((tuple(abits), tuple(bbits)))
    cands = sorted({(sa, sb) for abits, bbits in slots
                    for sa in _subsets(abits) for sb in _subsets(bbits)})
    codes_a = sorted({s for s, _ in cands})
    codes_b = sorted({t for _, t in cands})
    ia = {c: i for i, c in enumerate(codes_a)}
    ib = {c: i for i, c in enumerate(codes_b)}
    xa, xb = _wrap_n(codes_a, n), _wrap_n(codes_b, n)
    f = closed_form_from_params(torch.from_numpy(xa[:, None]),
                                torch.from_numpy(xb[None, :]), params)
    rest = f.numpy().astype(np.int64) - xa[:, None] * xb[None, :] + _trunc(
        np.asarray(codes_a)[:, None], np.asarray(codes_b)[None, :], n)
    pairs, f00 = [], None
    for sa, sb in cands:
        c = 0
        for s2 in _subsets([b for b in range(n) if sa >> b & 1]):
            for t2 in _subsets([b for b in range(n) if sb >> b & 1]):
                sign = -1 if (bin(sa ^ s2).count("1") + bin(sb ^ t2).count("1")) & 1 else 1
                c += sign * int(rest[ia[s2], ib[t2]])
        if (sa, sb) == (0, 0):
            f00 = c
        elif c:
            if not (sa and sb):  # f(a, 0) and f(0, b) are the constant f00
                raise ValueError(f"a monomial pair ({sa:#x}, {sb:#x}) with "
                                 "an empty side")
            pairs.append((sa, sb, c))
    for sa, sb, c in pairs:
        for shift, alpha, beta in _pair_parts(c):
            planes.append(WidePlane(WideSide(TEST, sa, alpha),
                                    WideSide(TEST, sb, beta), shift, 1))
    planes.sort(key=lambda pl: pl.group)  # stable: the order within a group
    w = WidePlanes(n, f00, tuple(planes), tuple(pairs))
    if len(planes) > WIDE_MAX_PLANES or len(w.groups) > WIDE_MAX_GROUPS:
        raise ValueError(f"{len(planes)} wide planes in {len(w.groups)} "
                         f"groups: the kernel takes {WIDE_MAX_PLANES} in "
                         f"{WIDE_MAX_GROUPS}")
    # held against the wrapped closed form: the derivation's codes, the
    # extremes and seeded pairs
    hi = 1 << (n - 1)
    ext = np.array([-hi, -hi + 1, -1, 0, 1, hi - 2, hi - 1])
    rng = np.random.default_rng(n)
    ta = np.concatenate([xa, ext, rng.integers(-hi, hi, 1 << 14)])
    tb = np.concatenate([xb, ext, rng.integers(-hi, hi, 1 << 14)])
    grid_a, grid_b = np.concatenate([np.repeat(ta[:len(xa) + 7], len(tb[:len(xb) + 7])),
                                     ta[len(xa) + 7:]]), \
        np.concatenate([np.tile(tb[:len(xb) + 7], len(ta[:len(xa) + 7])),
                        tb[len(xb) + 7:]])
    want = closed_form_from_params(torch.from_numpy(grid_a),
                                   torch.from_numpy(grid_b), params).numpy()
    if not np.array_equal(w.rebuild(grid_a, grid_b), want.astype(np.int64)):
        raise ValueError(f"the wide planes do not give the width-{n} closed "
                         "form back")
    return w


def _trunc(ua, ub, n: int) -> np.ndarray:
    """Σ_{i<n−1} u(a)_i · 2^i · (u(b) & (2^{n−1−i} − 1)) on unsigned codes."""
    ua, ub = np.asarray(ua, np.int64), np.asarray(ub, np.int64)
    out = np.zeros(np.broadcast(ua, ub).shape, np.int64)
    for i in range(n - 1):
        out += ((ua >> i) & 1) * ((ub & ((1 << (n - 1 - i)) - 1)) << i)
    return out


def wide_device_params(w: WidePlanes) -> np.ndarray:
    """The planes as wide_contract.cuh's parameter block reads them: a flat
    (:data:`WIDE_PARAM_LEN`,) int32 array.

    [0] P planes, [1] G groups; [2, 10): the end plane of each group;
    [10, 18): each group's multiplier ±2^shift (an int32 ring factor); then
    WIDE_PLANE_WORDS words a plane: [0] a's kind | b's kind << 8 | a
    signed << 16 | b signed << 24, [1, 6) a's words, [6, 11) b's words.
    A side's words: AND_*: the mask byte replicated; TEST: for its low and
    high byte the mask's low 7 bits replicated and the complement of its
    bit 7 replicated (the SIMD-within-a-word test of rows_contract.cuh),
    then its byte replicated. TEST is sent as 5 (mask in the low byte
    only), 6 (high byte only) or 4 (both)."""
    out = np.zeros(WIDE_PARAM_LEN, np.int64)
    out[0], out[1] = len(w.planes), len(w.groups)
    groups = w.groups
    for g, key in enumerate(groups):
        out[2 + g] = 1 + max(i for i, pl in enumerate(w.planes) if pl.group == key)
        out[10 + g] = -key[0] * (1 << key[1])
    rep = 0x01010101
    for i, pl in enumerate(w.planes):
        words = out[18 + i * WIDE_PLANE_WORDS: 18 + (i + 1) * WIDE_PLANE_WORDS]
        kinds = []
        for j, side in enumerate((pl.a, pl.b)):
            kind, q = side.kind, [0] * 5
            if kind in (AND_LO, AND_HI):
                q[0] = (side.mask & 0xFF) * rep
            elif kind == TEST:
                lo, hi = side.mask & 0xFF, (side.mask >> 8) & 0xFF
                q = [(lo & 0x7F) * rep, ~((lo & 0x80) * rep) & 0xFFFFFFFF,
                     (hi & 0x7F) * rep, ~((hi & 0x80) * rep) & 0xFFFFFFFF,
                     (side.byte & 0xFF) * rep]
                kind = 5 if not hi else 6 if not lo else TEST
            kinds.append(kind)
            words[1 + 5 * j: 6 + 5 * j] = q
        words[0] = (kinds[0] | kinds[1] << 8 | _SIGNED_SIDE[pl.a.kind] << 16
                    | _SIGNED_SIDE[pl.b.kind] << 24)
    return (out & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
