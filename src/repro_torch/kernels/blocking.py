"""The pad / crop / f(0,0) contract of block-multiple contractions.

Counterpart of the shape half of ``repro.kernels.blocking``. The TPU's
(8, 128) block clamps and the interpret-mode switch have no counterpart:
the CUDA kernels bounds-check ragged shapes themselves, and a tensor's
device decides between a kernel and its plain version.

The contract stays because the plain twin of the matmul kernel walks k in
fixed-size slabs: zero-padding k injects f(0,0) per padded element
(approximate wirings map (0,0) to a nonzero compensation value), which is
subtracted back here. :func:`as3` and :func:`plain_k_chunk` are the shape
half the contraction wrappers share.

Both contraction kernels have several designs on the card, chosen from the
shape and the operand width alone, in this order: the *narrow* design
(:func:`narrow_design`, ``csrc/narrow_contract.cuh``) contracts the rows
against one 2^n-entry product column per coefficient; the *decode* design
(:func:`decode_design`, ``csrc/decode_contract.cuh``) contracts few rows
against the whole int16 product table in shared memory; ``lut_matmul`` has
a *tensor* design for the exact product (:func:`tensor_design`, INT8 tensor
cores) before it; the *rows* design (:func:`rows_design`,
``csrc/rows_contract.cuh``) contracts many rows as an exact int8 GEMM plus a
few bit-monomial int8 GEMMs on the INT8 tensor cores (``kernels.monomials``);
``lut_matmul``'s *gather* design (:func:`gather_design`,
``csrc/gather_contract.cuh``) takes the tables the others refuse (entries
beyond int16, or beyond the rows planes at M > 16) at the shapes where it
beats the tile design (K and N wide, or few rows), the table in shared
memory and each product one gather from it, bound by INT32 operations; ``approx_matmul``'s *wide* design (:func:`wide_design`,
``csrc/wide_contract.cuh``) takes widths 9..16 at any shape, the closed form
as a few dozen byte GEMMs on the INT8 tensor cores
(``monomials.wide_planes``), bound by them. The *tile* design (16×16 output
tiles, the generic closed form or an L2 gather per product) takes every
shape; the wide design took all of its closed-form calls, and of its table
calls it keeps the narrow-N ones under a table beyond int16 (the edge
shapes), where the gather design is slower.
:func:`narrow_matmul_plain`, :func:`decode_matmul_plain`,
:func:`tensor_matmul_plain`, :func:`rows_matmul_plain` and
:func:`wide_matmul_plain` are the plain twins of the others; the gather
design's is the table contraction itself (``lut_matmul_plain``): its
windows split the sum by activation code, which an int32-ring sum does not
see.

The decode, tensor, rows and gather designs take the int8 codes that
``dense`` hands over as they are (:func:`codes8`); the narrow, wide and tile
designs take int32.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

# the wide design's widths (WD_MIN_BITS / WD_MAX_BITS in wide_contract.cuh)
from repro_torch.kernels.monomials import WIDE_MAX_BITS, WIDE_MIN_BITS

#: elements of one (B, M, k_chunk, N) product slab in a plain contraction
_SLAB_ELEMS = 1 << 22
_MAX_K_CHUNK = 16

#: Thresholds of the narrow design (``NC_MAX_*`` in narrow_contract.cuh).
#: N: a thread keeps one sum per output column for each of its 4 rows, 32
#: registers at 8. K: the kernel is compiled for each K up to 16, and a tile
#: of 1024 rows takes 4·K KiB of shared memory per pipeline stage (128 KiB in
#: 2 stages at 16). Width: one int16 column of 2^n entries per coefficient.
#: Together they bound the columns a block stages to K·N·2^n·2 B ≤ 64 KiB.
NARROW_MAX_N = 8
NARROW_MAX_K = 16
NARROW_MAX_BITS = 8
#: Thresholds of the decode design (``DC_MAX_*`` in decode_contract.cuh): a
#: thread keeps 4 sums per row, 64 registers at 16 rows; the int16 table of
#: 2^(2n) entries is 128 KiB of shared memory at width 8.
DECODE_MAX_M = 16
DECODE_MAX_BITS = 8
#: Thresholds of the tensor design (``TC_MAX_*`` in lut_matmul.cu): two n8
#: groups of rows per mma; at K ≤ 131071 no int32 sum of products of
#: signed 8-bit codes (|a·b| ≤ 2^14) can overflow.
TENSOR_MAX_M = 16
TENSOR_MAX_K = 131071
#: Widths of the rows design (``RC_MIN_BITS`` / ``RC_MAX_BITS`` in
#: rows_contract.cuh): the product tables of the CSP wirings (widths 3..16)
#: that fit int8 codes.
ROWS_MIN_BITS = 3
ROWS_MAX_BITS = 8
#: The wide design's block tile (``WD_BM``, ``WD_BN``, ``WD_BK``): its
#: scratch byte planes pad M and N to 128 and K to 32.
WIDE_TILE = (128, 128, 32)
#: Widths of the gather design (``GC_MAX_BITS`` in gather_contract.cuh),
#: and the shared memory of one window of its table (``GC_WINDOW_BYTES``).
GATHER_MAX_BITS = 8
GATHER_WINDOW_BYTES = 128 << 10
#: Where the gather design beats the tile design (``tools/gather_sweep.py``
#: on the card): its lanes hold 4 weight columns each and every (16-row,
#: 128-column) segment pays a fixed cost, so it needs K ≥ GATHER_MIN_K and
#: N ≥ GATHER_MIN_N (GATHER_MIN_N_LONG_K from K ≥ GATHER_LONG_K), unless the
#: tile design's grid has at most GATHER_TILE_STARVED 16×16 output tiles
#: (too few to fill the card: M = 256 at N ≤ 256, decode rows).
GATHER_MIN_K = 64
GATHER_MIN_N = 64
GATHER_LONG_K = 512
GATHER_MIN_N_LONG_K = 32
GATHER_TILE_STARVED = 256


def _is_int(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex
                or t.dtype == torch.bool)


def as3(a: torch.Tensor, b: torch.Tensor):
    """(M,K)@(K,N) or (B,M,K)@(B,K,N) operands → (B,M,K), (B,K,N); raises
    on any other rank or a shape mismatch. Integer operands keep their
    dtype and are not copied (int8 codes stay int8: each design casts what
    it needs); any other dtype is cast to int32."""
    if a.dim() != b.dim() or a.dim() not in (2, 3):
        raise ValueError(f"expected (M,K)@(K,N) or (B,M,K)@(B,K,N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dim() == 2:
        a, b = a[None], b[None]
    if a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    return tuple(x if _is_int(x) else x.to(torch.int32) for x in (a, b))


def codes8(x: torch.Tensor) -> torch.Tensor:
    """Integer operands as int8 codes: their low 8 bits, reinterpreted as
    signed. An int8 tensor is returned as it is (no copy). At widths ≤ 8 the
    product depends on the low n bits alone (the closed form and the table
    index both wrap an operand first), so the codes give the same integers
    as the operands."""
    if x.dtype == torch.int8:
        return x
    return (x & 0xFF).to(torch.uint8).view(torch.int8)


def narrow_design(k: int, n: int, n_bits: int) -> bool:
    """Whether a (B,M,k)@(B,k,n) contraction at operand width ``n_bits``
    runs the narrow design on the card (else the tile design). A pure
    function of shape and width; every shape the served paths give the
    contraction kernels (n = 1, k ≤ 9, width ≤ 8) is narrow."""
    return (1 <= n <= NARROW_MAX_N and 1 <= k <= NARROW_MAX_K
            and 1 <= n_bits <= NARROW_MAX_BITS)


def decode_design(m: int, k: int, n: int, n_bits: int) -> bool:
    """Whether a (B,m,k)@(B,k,n) contraction at operand width ``n_bits``
    runs the decode design on the card: few rows (an LM decode step's M =
    8), width ≤ 8, and a shape the narrow design does not take. A pure
    function of shape and width."""
    return (1 <= m <= DECODE_MAX_M and 1 <= n_bits <= DECODE_MAX_BITS
            and k >= 1 and n >= 1 and not narrow_design(k, n, n_bits))


def tensor_design(m: int, k: int, n: int, n_bits: int) -> bool:
    """Whether a (B,m,k)@(B,k,n) contraction at width ``n_bits`` can run
    ``lut_matmul``'s tensor design, given a table that is the exact product
    of signed 8-bit codes (the caller checks the table): width 8, few rows,
    K ≤ 131071, and a shape the narrow design does not take."""
    return (1 <= m <= TENSOR_MAX_M and n_bits == 8 and 1 <= k <= TENSOR_MAX_K
            and n >= 1 and not narrow_design(k, n, n_bits))


def rows_design(m: int, k: int, n: int, n_bits: int) -> bool:
    """Whether a (B,m,k)@(B,k,n) contraction at operand width ``n_bits``
    runs the rows design on the card (``lut_matmul`` also needs a table of
    at most ``monomials.MAX_PLANES`` planes): many rows (a training step's
    or a prefill's M = 256), widths 3..8, and a shape the narrow design does
    not take. A pure function of shape and width."""
    return (m > DECODE_MAX_M and ROWS_MIN_BITS <= n_bits <= ROWS_MAX_BITS
            and k >= 1 and n >= 1 and not narrow_design(k, n, n_bits))


def wide_design(m: int, k: int, n: int, n_bits: int) -> bool:
    """Whether a (B,m,k)@(B,k,n) contraction at operand width ``n_bits``
    runs ``approx_matmul``'s wide design on the card: widths 9..16, any
    non-empty shape. A pure function of shape and width."""
    return (WIDE_MIN_BITS <= n_bits <= WIDE_MAX_BITS and m >= 1 and k >= 1
            and n >= 1)


def gather_takes(m: int, k: int, n: int, n_bits: int) -> bool:
    """Whether ``lut_matmul``'s gather kernel can run a (B,m,k)@(B,k,n)
    contraction at width ``n_bits``: any non-empty shape at a table width of
    at most 8 (a forced ``design="gather"``; :func:`gather_design` is where
    the dispatch picks it)."""
    return 1 <= n_bits <= GATHER_MAX_BITS and m >= 1 and k >= 1 and n >= 1


def gather_design(m: int, k: int, n: int, n_bits: int) -> bool:
    """Whether a (B,m,k)@(B,k,n) contraction at width ``n_bits`` can run
    ``lut_matmul``'s gather design: a table width of at most 8 (every flat
    table; it is the last design before the tile one, so it takes what the
    others refuse) at a shape where it beats the tile design: K and N wide
    enough for its segments and lanes (:data:`GATHER_MIN_K`,
    :data:`GATHER_MIN_N`), or a tile grid too small to fill the card
    (:data:`GATHER_TILE_STARVED`). The tile design takes the rest: narrow-N
    contractions (the edge shapes) under a table beyond int16. A pure
    function of shape and width."""
    if not gather_takes(m, k, n, n_bits):
        return False
    min_n = GATHER_MIN_N_LONG_K if k >= GATHER_LONG_K else GATHER_MIN_N
    tiles = -(-m // 16) * -(-n // 16)
    return (k >= GATHER_MIN_K and n >= min_n) or tiles <= GATHER_TILE_STARVED


def gather_window_rows(n_bits: int, entry_bytes: int) -> int:
    """Table rows (activation codes) of one shared-memory window of the
    gather design (``gc_window_rows``): every row where the table fits
    ``GATHER_WINDOW_BYTES``, else as many as do (128 of an int32 table at
    width 8, so two windows)."""
    row = (1 << n_bits) * entry_bytes
    return 1 << n_bits if row << n_bits <= GATHER_WINDOW_BYTES \
        else GATHER_WINDOW_BYTES // row


def wide_scratch_bytes(bsz: int, m: int, k: int, n: int) -> int:
    """Bytes of the wide design's scratch (``wide_scratch_bytes``): the low
    and high byte planes of A (B, Mp, Kp) and of the transposed weight (B,
    Np, Kp), M and N rounded up to 128, K to 32."""
    bm, bn, bk = WIDE_TILE
    up = lambda x, to: -(-x // to) * to  # noqa: E731
    return 2 * bsz * (up(m, bm) + up(n, bn)) * up(k, bk)


def decode_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                        table16: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Plain twin of the decode design on any device: (B,M,K) rows against
    (B,K,N) coefficients through the flat (2^(2n),) int16 product table (or
    a table of any integer dtype: ``lut_matmul_plain``),
    ``out[z,m,j] = Σ_k table16[xa << n | xb]`` with ``xa = (a[z,m,k] +
    2^(n-1)) & (2^n − 1)`` and ``xb`` likewise, summed in the int32 ring, k
    walked in slabs."""
    off, mask = 1 << (n_bits - 1), (1 << n_bits) - 1
    ai = ((a.to(torch.int32) + off) & mask) << n_bits
    bi = (b.to(torch.int32) + off) & mask
    t = table16.to(torch.int32)
    bsz, m, k = a.shape
    nn = b.shape[2]
    k_chunk = plain_k_chunk(bsz, m, nn)
    acc = torch.zeros((bsz, m, nn), dtype=torch.int32, device=a.device)
    for k0 in range(0, k, k_chunk):
        idx = ai[:, :, k0:k0 + k_chunk, None] | bi[:, None, k0:k0 + k_chunk, :]
        acc += t[idx.long()].sum(dim=2, dtype=torch.int32)
    return acc


def tensor_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of the tensor design: the exact product of the operands'
    int8 codes (:func:`codes8`), an int64 matmul cast through int64 to
    int32 (which wraps as the int32 ring does). The card has no int64
    matmul: there it is a float64 one, exact while every sum stays below
    2^53 (|a·b| ≤ 2^14, so for K < 2^39)."""
    dt = torch.int64 if a.device.type == "cpu" else torch.float64
    return torch.matmul(codes8(a).to(dt), codes8(b).to(dt)).to(
        torch.int64).to(torch.int32)


def _wrapped(x: torch.Tensor, n_bits: int) -> torch.Tensor:
    """The wrapped n-bit values of integer operands: their low n bits,
    sign-extended, as int64."""
    x = x.to(torch.int64) & ((1 << n_bits) - 1)
    return x - ((x >> (n_bits - 1)) << n_bits)


def rows_matmul_plain(a: torch.Tensor, b: torch.Tensor, decomp,
                      n_bits: int) -> torch.Tensor:
    """Plain twin of the rows design on any device: (B,M,K)@(B,K,N) as
    ``(A @ W) + Σ_r scale_r·(A_{S_r} @ F_r(W)) + K·f00`` with the planes of
    ``decomp`` (a ``kernels.monomials.Decomposition`` of width ``n_bits``),
    A and W the wrapped n-bit values of the operands, ``A_S = [u(a) & S ==
    S]`` on their unsigned n-bit codes u; summed in int64, then wrapped to
    the int32 ring. The card has no int64 matmul: there each GEMM is a
    float64 one, exact while its sums stay below 2^53 (|a·w| ≤ 2^14, so for
    K < 2^39)."""
    if decomp.n_bits != n_bits:
        raise ValueError(f"a width-{decomp.n_bits} decomposition at width "
                         f"{n_bits}")
    dt = torch.int64 if a.device.type == "cpu" else torch.float64

    def mm(x, y):
        return torch.matmul(x.to(dt), y.to(dt)).to(torch.int64)

    ua = a.to(torch.int64) & ((1 << n_bits) - 1)
    ub = (b.to(torch.int64) & ((1 << n_bits) - 1))
    acc = mm(_wrapped(a, n_bits), _wrapped(b, n_bits))
    factors = torch.from_numpy(decomp.factors.astype(np.int64)).to(a.device)
    for mask, scale, fac in zip(decomp.masks, decomp.scales, factors):
        acc += scale * mm((ua & mask) == mask, fac[ub])
    acc += a.shape[2] * decomp.f00
    return acc.to(torch.int32)


def wide_matmul_plain(a: torch.Tensor, b: torch.Tensor, planes,
                      n_bits: int) -> torch.Tensor:
    """Plain twin of the wide design on any device: (B,M,K)@(B,K,N) as
    ``Σ_p sign_p·2^shift_p·(A_p @ B_p) + K·f00`` with the planes of
    ``planes`` (a ``kernels.monomials.WidePlanes`` of width ``n_bits``),
    each side a byte function of the wrapped n-bit operands; summed in
    int64, then wrapped to the int32 ring. The card has no int64 matmul:
    there each GEMM is a float64 one, exact while its sums stay below 2^53
    (|a plane's product| < 2^16, so for K < 2^37)."""
    if planes.n_bits != n_bits:
        raise ValueError(f"width-{planes.n_bits} wide planes at width {n_bits}")
    dt = torch.int64 if a.device.type == "cpu" else torch.float64
    xa, xb = _wrapped(a, n_bits), _wrapped(b, n_bits)
    acc = torch.zeros((a.shape[0], a.shape[1], b.shape[2]), dtype=torch.int64,
                      device=a.device)
    for p in planes.planes:
        prod = torch.matmul(p.a.value(xa, n_bits).to(dt),
                            p.b.value(xb, n_bits).to(dt)).to(torch.int64)
        acc += (p.sign << p.shift) * prod
    acc += a.shape[2] * planes.f00
    return acc.to(torch.int32)


def narrow_matmul_plain(a: torch.Tensor, cols: torch.Tensor,
                        n_bits: int) -> torch.Tensor:
    """Plain twin of the narrow design on any device: (B,M,K) int32 rows
    against (B,K,N,2^n) product columns, ``out[z,m,j] = Σ_k cols[z,k,j,
    (a[z,m,k] + 2^(n-1)) & (2^n − 1)]`` summed in the int32 ring."""
    off, mask = 1 << (n_bits - 1), (1 << n_bits) - 1
    bsz, m, k = a.shape
    n = cols.shape[2]
    acc = torch.zeros((bsz, n, m), dtype=torch.int32, device=a.device)
    for kk in range(k):
        idx = ((a[:, :, kk] + off) & mask).long()  # (B, M)
        acc += torch.gather(cols[:, kk].to(torch.int32), 2,
                            idx[:, None, :].expand(bsz, n, m))
    return acc.transpose(1, 2).contiguous()


#: The dispatch order of both contraction kernels; ``lut_matmul`` alone has
#: the tensor design (the exact product at few rows), ahead of the decode
#: design that would also take its shapes, and the gather design (any other
#: table, at the shapes where it wins); ``approx_matmul`` alone has the wide
#: design (widths 9..16). The tile design takes everything: for
#: ``approx_matmul`` the wide design already does, so it runs only where
#: forced; for ``lut_matmul`` it keeps the narrow-N tables beyond int16.
DESIGN_ORDER = ("narrow", "tensor", "decode", "rows", "gather", "wide", "tile")
_TABLE_DESIGNS = ("tensor", "gather")  # lut_matmul's alone
_CLOSED_FORM_DESIGNS = ("wide",)  # approx_matmul's alone


def eligible_designs(m: int, k: int, n: int, n_bits: int,
                     table_checks: "dict | None" = None,
                     forced: "str | None" = None) -> dict:
    """Design name → whether it takes a (B,m,k)@(B,k,n) contraction at
    width ``n_bits``, in :data:`DESIGN_ORDER`, the tile design taking
    everything. ``table_checks`` (``lut_matmul``): design name → a callable
    that checks the product table for that design, called only where the
    shape fits (a check may synchronise once per table version); with it the
    wide design is left out, without it (``approx_matmul``) the tensor and
    gather designs. ``forced``: the design a caller names, eligible wherever
    its kernel can run (the gather design at any shape, though the dispatch
    picks it only where it beats the tile design). A pure function of shape
    and width, and of the table's checks."""
    shape = {"narrow": narrow_design(k, n, n_bits),
             "tensor": tensor_design(m, k, n, n_bits),
             "decode": decode_design(m, k, n, n_bits),
             "rows": rows_design(m, k, n, n_bits),
             "gather": (gather_takes if forced == "gather" else gather_design)(
                 m, k, n, n_bits),
             "wide": wide_design(m, k, n, n_bits),
             "tile": True}
    checks = table_checks or {}
    left_out = _CLOSED_FORM_DESIGNS if table_checks is not None else _TABLE_DESIGNS
    return {name: shape[name] and (name not in checks or bool(checks[name]()))
            for name in DESIGN_ORDER if name not in left_out}


def resolve_design(design: "str | None", eligible: dict, kernel: str,
                   what: str) -> str:
    """One of the designs in ``eligible`` (name → whether it takes the call,
    in dispatch order, the last one taking everything): ``design`` where
    given (raising if it cannot take ``what``), else the first that can."""
    if design is None:
        return next(name for name, ok in eligible.items() if ok)
    if design not in eligible:
        raise ValueError(f"unknown {kernel} design {design!r}")
    if not eligible[design]:
        raise ValueError(f"the {design} design does not take {what}")
    return design


def narrow_operands(a: torch.Tensor, b: torch.Tensor, n_bits: int):
    """(A, B, out, cols, rows to crop to or None) for a narrow launch on
    (B,M,K)@(B,K,N): contiguous operands with every batch of A and of the
    output 16-byte aligned, as the kernel requires, and the empty output
    and int16 column scratch on the operands' device (and so the caller's
    stream). A is copied only where it would not be aligned, its rows
    zero-padded to a multiple of 4 when batched; the caller crops."""
    a = a.contiguous()
    bsz, m, k = a.shape
    pad = (-m) % 4 if bsz > 1 else 0
    if pad:
        a = F.pad(a, (0, 0, 0, pad))
    elif a.data_ptr() % 16:
        a = a.clone()
    n = b.shape[2]
    out = torch.empty((bsz, m + pad, n), dtype=torch.int32, device=a.device)
    cols = torch.empty((bsz, k, n, 1 << n_bits), dtype=torch.int16,
                       device=a.device)
    return a, b.contiguous(), out, cols, (m if pad else None)


def plain_k_chunk(bsz: int, m: int, n: int) -> int:
    """k-slab width of a plain contraction: a (B, M, k, N) slab stays near
    ``_SLAB_ELEMS`` elements, between 1 and ``_MAX_K_CHUNK``."""
    return max(1, min(_MAX_K_CHUNK, _SLAB_ELEMS // max(1, bsz * m * n)))


def check_kernel_shapes(kernel_name: str, ops_name: str, a_shape, b_shape,
                        block_m: int, block_n: int, block_k: int) -> None:
    """Loud shape contract for a block-multiple-only contraction of
    ``(..., M, K) @ (..., K, N)``: raises on a contraction-dim mismatch or
    any non-block-multiple dim."""
    m, k = a_shape[-2:]
    k2, n = b_shape[-2:]
    if k != k2:
        raise ValueError(
            f"contraction-dim mismatch: a is {tuple(a_shape)}, "
            f"b is {tuple(b_shape)}")
    if m % block_m or n % block_n or k % block_k:
        raise ValueError(
            f"{kernel_name} requires every dim to be a multiple of its "
            f"block size: got (M, K, N)=({m}, {k}, {n}) with blocks "
            f"(block_m, block_k, block_n)=({block_m}, {block_k}, {block_n})."
            f" Call {ops_name}, which pads and corrects the f(0,0) padding "
            "artifact.")


def pad_crop_correct(a: torch.Tensor, b: torch.Tensor, f00: int,
                     kernel_call: Callable, *, block_m: int, block_n: int,
                     block_k: int) -> torch.Tensor:
    """Run a block-multiple-only contraction on arbitrary
    ``(..., M, K) @ (..., K, N)``.

    ``kernel_call(ap, bp)`` receives the zero-padded operands; the result is
    cropped to (M, N) and corrected by ``f00`` (the scalar-product model's
    value at (0, 0)) per padded k element.
    """
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2:
        raise ValueError(f"contraction-dim mismatch: a is {tuple(a.shape)}, "
                         f"b is {tuple(b.shape)}")
    pm, pn, pk = (-m) % block_m, (-n) % block_n, (-k) % block_k
    ap = F.pad(a, (0, pk, 0, pm))
    bp = F.pad(b, (0, pn, 0, pk))
    out = kernel_call(ap, bp)[..., :m, :n]
    if pk:
        out = out - f00 * pk
    return out
