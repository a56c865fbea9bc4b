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
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

#: elements of one (B, M, k_chunk, N) product slab in a plain contraction
_SLAB_ELEMS = 1 << 22
_MAX_K_CHUNK = 16


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
