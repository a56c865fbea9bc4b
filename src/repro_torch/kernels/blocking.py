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

Both contraction kernels have two designs on the card, chosen by
:func:`narrow_design` from the shape and the operand width alone: the
*narrow* design (``csrc/narrow_contract.cuh``) contracts the rows against
one 2^n-entry product column per coefficient, and the *tile* design (16×16
output tiles) takes every other shape. :func:`narrow_matmul_plain` is the
narrow design's plain twin.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

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


def as3(a: torch.Tensor, b: torch.Tensor):
    """(M,K)@(K,N) or (B,M,K)@(B,K,N) operands → int32 (B,M,K), (B,K,N);
    raises on any other rank or a shape mismatch."""
    if a.dim() != b.dim() or a.dim() not in (2, 3):
        raise ValueError(f"expected (M,K)@(K,N) or (B,M,K)@(B,K,N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dim() == 2:
        a, b = a[None], b[None]
    if a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    return a.to(torch.int32), b.to(torch.int32)


def narrow_design(k: int, n: int, n_bits: int) -> bool:
    """Whether a (B,M,k)@(B,k,n) contraction at operand width ``n_bits``
    runs the narrow design on the card (else the tile design). A pure
    function of shape and width; every shape the served paths give the
    contraction kernels (n = 1, k ≤ 9, width ≤ 8) is narrow."""
    return (1 <= n <= NARROW_MAX_N and 1 <= k <= NARROW_MAX_K
            and 1 <= n_bits <= NARROW_MAX_BITS)


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


def resolve_design(design: "str | None", special_ok: bool, kernel: str,
                   what: str, designs: tuple = ("narrow", "tile")) -> str:
    """One of ``designs`` (the specialised design first, then the one that
    takes everything): ``design`` where given (raising if the specialised
    design cannot take ``what``), else the specialised one wherever it can."""
    special, general = designs
    if design is None:
        return special if special_ok else general
    if design not in designs:
        raise ValueError(f"unknown {kernel} design {design!r}")
    if design == special and not special_ok:
        raise ValueError(f"the {special} design does not take {what}")
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
