"""Approximate contraction: the wrapper of ``csrc/approx_matmul.cu``.

Counterpart of ``repro.kernels.approx_matmul.ops``.
``closed_form_matmul(a, b, mult_key)`` computes (M,K)@(K,N), or batched
(B,M,K)@(B,K,N), int32, with every scalar product the wiring's closed form
and an exact int32-ring sum:

* a CUDA tensor launches a hand-written kernel (they replace the TPU kernel
  ``repro/kernels/approx_matmul/kernel.py``, ``approx_matmul_pallas``;
  designs and bounds in the source's header) or raises — there is no
  fallback. The shape and width pick the design, in this order
  (``kernels.blocking``): the *narrow* design (N ≤ 8, K ≤ 16, width ≤ 8:
  every shape the edge paths give it) tabulates the closed form per
  coefficient (:func:`closed_form_columns`) and streams the rows against
  those columns; the *decode* design (M ≤ 16, width ≤ 8: every dense layer
  of an LM decode step) gathers every product from the whole int16 product
  table (:func:`closed_form_table16`, built on the card once per key and
  device) in shared memory, taking the int8 codes ``dense`` hands over
  without a copy; the *rows* design (M > 16, widths 3..8: every dense
  layer of a training step or a prefill) runs the closed form's table,
  taken apart into an exact int8 GEMM plus a few bit-monomial int8 GEMMs
  (:func:`rows_decomposition`, ``kernels.monomials``), on the INT8 tensor
  cores, on the int8 codes as they are; the *wide* design (widths 9–16,
  any shape: the public entry point at those widths, no served path) runs
  the closed form taken apart from its parameter block into byte GEMMs
  (:func:`wide_decomposition`, ``monomials.wide_planes``: the exact
  product in four, the truncation one a bit, those of one b side and
  scale merged, a few bit-monomial pairs; 26 at proposed@12, 29 at
  proposed@16) on the INT8 tensor cores, each side of
  a plane built in registers from the operands' byte planes. The *tile*
  design (16×16 output tiles, the generic closed form per product) remains
  as a forced design (``_launch(..., design="tile")``); no path reaches it
  since the wide design replaced it at widths 9–16. The
  narrow design needs 16-byte
  aligned batches: an A whose base is not 16-byte aligned (a view with a
  storage offset), or a batched A with M % 4 ≠ 0, is first copied into a
  fresh buffer, its rows zero-padded to a multiple of 4, and the result
  cropped;
* a CPU tensor runs :func:`closed_form_matmul_plain`: k walked in slabs
  under the pad / crop / f(0,0) contract of ``kernels.blocking``.

``closed_form_matmul.launches`` counts tile launches,
``closed_form_matmul.narrow_launches`` narrow ones,
``closed_form_matmul.decode_launches`` decode ones,
``closed_form_matmul.rows_launches`` rows ones and
``closed_form_matmul.wide_launches`` wide ones, each also by its
``(B, M, K, N)`` (``.by_shape()``). The narrow design's
plain twin is :func:`closed_form_columns` with
:func:`~repro_torch.kernels.blocking.narrow_matmul_plain`; the decode
design's is :func:`closed_form_table16` with
:func:`~repro_torch.kernels.blocking.decode_matmul_plain`; the rows
design's is :func:`rows_decomposition` with
:func:`~repro_torch.kernels.blocking.rows_matmul_plain`; the wide design's
is :func:`wide_decomposition` with
:func:`~repro_torch.kernels.blocking.wide_matmul_plain`.

:func:`approx_matmul` is the historical proposed@8 entry point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import multiplier as mult
from repro_torch.kernels import blocking, build, monomials
from repro_torch.kernels.blocking import (decode_matmul_plain,  # noqa: F401
                                          narrow_matmul_plain,
                                          rows_matmul_plain,
                                          wide_matmul_plain)
from repro_torch.kernels.closed_form import (closed_form_f00, closed_form_params,
                                             make_closed_form)
from repro_torch.obs.trace import trace_span

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p)
_NARROW_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
_DECODE_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_TABLE_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
_ROWS_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p)
_WIDE_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_void_p)


def closed_form_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                             key: str) -> torch.Tensor:
    """Plain torch version of the kernel on (B,M,K)@(B,K,N), any device:
    k walked in zero-padded slabs, the padding's f(0,0) subtracted back."""
    bsz, m, _ = a.shape
    n = b.shape[2]
    cf = make_closed_form(key)
    k_chunk = blocking.plain_k_chunk(bsz, m, n)

    def walk(ap, bp):
        blocking.check_kernel_shapes(
            "closed_form_matmul_plain", "closed_form_matmul", ap.shape,
            bp.shape, 1, 1, k_chunk)
        acc = torch.zeros((bsz, m, n), dtype=torch.int32, device=a.device)
        for k0 in range(0, ap.shape[2], k_chunk):
            prod = cf(ap[:, :, k0:k0 + k_chunk, None],
                      bp[:, None, k0:k0 + k_chunk, :])
            acc += prod.sum(dim=2, dtype=torch.int32)
        return acc

    return blocking.pad_crop_correct(a, b, closed_form_f00(key), walk,
                                     block_m=1, block_n=1, block_k=k_chunk)


def closed_form_columns(b: torch.Tensor, key: str) -> torch.Tensor:
    """The narrow design's product columns, plain, on any device: (B,K,N)
    coefficients → (B,K,N,2^n) int32 with ``[z,k,j,x] = f(x − 2^(n−1),
    b[z,k,j])``, the closed form of ``key`` at its width n."""
    n = mult.split_width(key)[1]
    x = torch.arange(1 << n, dtype=torch.int32, device=b.device) - (1 << (n - 1))
    return make_closed_form(key)(x, b.to(torch.int32)[..., None])


def closed_form_table16(key: str, device) -> torch.Tensor:
    """The decode design's product table of ``key`` (width n ≤ 8) on
    ``device``: flat (2^(2n),) int16, ``[xa << n | xb] = f(xa − 2^(n−1),
    xb − 2^(n−1))``, laid out as ``core.lut.flat_lut``. Built once per (key,
    device): by the table kernel on the card (``approx_matmul_table_
    launch``), never from the host table; by the closed form in torch on
    the CPU. Raises for widths above 8 (products beyond int16)."""
    key = mult.canonical_key(key)
    n = mult.split_width(key)[1]
    if not 1 <= n <= blocking.DECODE_MAX_BITS:
        raise ValueError(f"{key}: the product table needs a width <= "
                         f"{blocking.DECODE_MAX_BITS}, got {n}")
    device = torch.device(device)

    def make():
        if device.type == "cpu":
            x = torch.arange(1 << n, dtype=torch.int32) - (1 << (n - 1))
            return make_closed_form(key)(x[:, None], x[None, :]).to(
                torch.int16).reshape(-1)
        params = closed_form_params(key)
        table = torch.empty(1 << (2 * n), dtype=torch.int16, device=device)
        fn = build.load_function("approx_matmul", "approx_matmul_table_launch",
                                 _TABLE_ARGTYPES)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(table.data_ptr(), params.ctypes.data, stream)
        build.check(rc, "approx_matmul_table_launch")
        return table

    return build.device_constant(("cf_table16", key), device, make)


def rows_decomposition(key: str) -> monomials.Decomposition:
    """The rows design's planes of ``key`` (width n ≤ 8): its product table
    (:func:`closed_form_table16`, built by the closed form on the host) as
    an exact int8 GEMM plus bit-monomial int8 GEMMs, once per key."""
    key = mult.canonical_key(key)
    return monomials.cached(("closed_form", key), lambda: monomials.decompose(
        closed_form_table16(key, "cpu").numpy()))


def wide_decomposition(key: str) -> monomials.WidePlanes:
    """The wide design's planes of ``key`` (widths 9..16): the closed form
    taken apart from its parameter block (``monomials.wide_planes``), once
    per key."""
    key = mult.canonical_key(key)
    return monomials.cached(("wide", key), lambda: monomials.wide_planes(
        closed_form_params(key)))


def _wide_params(key: str):
    """:func:`wide_decomposition` as the kernel's parameter block (host
    int32), once per key."""
    planes = wide_decomposition(key)  # outside the cache's lock
    return monomials.cached(("wide_params", key),
                            lambda: monomials.wide_device_params(planes))


def _rows_planes(key: str, device) -> torch.Tensor:
    """:func:`rows_decomposition` as the kernel reads it, on ``device``."""
    d = rows_decomposition(key)  # outside device_constant's lock
    return build.device_constant(("cf_rows", key), device,
                                 lambda: monomials.device_planes(d))


def _launch(a: torch.Tensor, b: torch.Tensor, key: str,
            design: "str | None" = None) -> torch.Tensor:
    """Launch the kernel of ``design`` (``"narrow"``, ``"decode"``,
    ``"rows"``, ``"wide"`` or ``"tile"``; None: the first of them that takes
    the shape,
    by :func:`~repro_torch.kernels.blocking.eligible_designs`) on CUDA
    (B,M,K)@(B,K,N) integer operands."""
    bsz, m, k = a.shape
    n = b.shape[2]
    n_bits = mult.split_width(key)[1]
    design = blocking.resolve_design(
        design, blocking.eligible_designs(m, k, n, n_bits),
        "approx_matmul", f"M={m}, K={k}, N={n} at width {n_bits}")
    if not (bsz <= 65535 and (n + 15) // 16 <= 65535 and max(m, k) < 2**31):
        raise ValueError(f"approx_matmul grid limit exceeded by "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if bsz * m * n == 0 or k == 0:
        return torch.zeros((bsz, m, n), dtype=torch.int32, device=a.device)
    if design == "decode":
        a8 = blocking.codes8(a).contiguous()
        b8 = blocking.codes8(b).contiguous()
        table = closed_form_table16(key, a.device)
        out = torch.empty((bsz, m, n), dtype=torch.int32, device=a.device)
        fn = build.load_function("approx_matmul", "approx_matmul_decode_launch",
                                 _DECODE_ARGTYPES)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = fn(a8.data_ptr(), b8.data_ptr(), table.data_ptr(),
                    out.data_ptr(), bsz, m, k, n, n_bits, stream)
        build.check(rc, "approx_matmul_decode_launch")
        closed_form_matmul.decode_launches.add((bsz, m, k, n))
        return out
    if design == "rows":
        a8 = blocking.codes8(a).contiguous()
        b8 = blocking.codes8(b).contiguous()
        d = rows_decomposition(key)
        planes = _rows_planes(key, a.device)
        out = torch.empty((bsz, m, n), dtype=torch.int32, device=a.device)
        fn = build.load_function("approx_matmul", "approx_matmul_rows_launch",
                                 _ROWS_ARGTYPES)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = fn(a8.data_ptr(), b8.data_ptr(), planes.data_ptr(),
                    out.data_ptr(), bsz, m, k, n, n_bits, d.planes, d.f00,
                    stream)
        build.check(rc, "approx_matmul_rows_launch")
        closed_form_matmul.rows_launches.add((bsz, m, k, n))
        return out
    params = closed_form_params(key)
    a, b = a.to(torch.int32), b.to(torch.int32)
    if design == "wide":
        a, b = a.contiguous(), b.contiguous()
        out = torch.empty((bsz, m, n), dtype=torch.int32, device=a.device)
        n_scratch = blocking.wide_scratch_bytes(bsz, m, k, n)
        scratch = torch.empty(n_scratch, dtype=torch.uint8, device=a.device)
        wide = _wide_params(key)
        fn = build.load_function("approx_matmul", "approx_matmul_wide_launch",
                                 _WIDE_ARGTYPES)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), n_scratch, bsz, m, k, n, n_bits,
                    wide.ctypes.data, wide_decomposition(key).f00, stream)
        build.check(rc, "approx_matmul_wide_launch")
        closed_form_matmul.wide_launches.add((bsz, m, k, n))
        return out
    if design == "narrow":
        a, b, out, cols, crop = blocking.narrow_operands(a, b, n_bits)
        fn = build.load_function("approx_matmul", "approx_matmul_narrow_launch",
                                 _NARROW_ARGTYPES)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), cols.data_ptr(),
                    bsz, a.shape[1], k, n, params.ctypes.data, stream)
        build.check(rc, "approx_matmul_narrow_launch")
        closed_form_matmul.narrow_launches.add((bsz, m, k, n))
        return out if crop is None else out[:, :crop].contiguous()
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty((bsz, m, n), dtype=torch.int32, device=a.device)
    fn = build.load_function("approx_matmul", "approx_matmul_launch", _ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, m, k, n,
                params.ctypes.data, stream)
    build.check(rc, "approx_matmul_launch")
    closed_form_matmul.launches.add((bsz, m, k, n))
    return out


def closed_form_matmul(a: torch.Tensor, b: torch.Tensor,
                       mult_key: str = "proposed") -> torch.Tensor:
    """(M,K)@(K,N) or (B,M,K)@(B,K,N) under any CSP wiring's closed form.

    ``mult_key``: ``"name[@N]"`` (aliases resolve). Returns int32 of shape
    (M,N) or (B,M,N). The operands' device decides: CUDA launches the
    kernel of the design the shape takes (or raises), CPU runs
    :func:`closed_form_matmul_plain`. Integer operands of any dtype give the
    same integers; the decode and rows designs read int8 codes without a
    copy.
    """
    if not (torch.is_tensor(a) and torch.is_tensor(b)) or a.device != b.device:
        raise ValueError("operands must be tensors on one device")
    key = mult.canonical_key(mult_key)
    squeeze = a.dim() == 2
    with trace_span("kernel.closed_form_matmul", "kernel", mult=key,
                    m=a.shape[-2], k=a.shape[-1], n=b.shape[-1]):
        a3, b3 = blocking.as3(a, b)
        if a.device.type == "cpu":
            out = closed_form_matmul_plain(a3.to(torch.int32),
                                           b3.to(torch.int32), key)
        elif a.device.type == "cuda":
            out = _launch(a3, b3, key)
        else:
            raise ValueError(f"closed_form_matmul runs on cpu or cuda "
                             f"tensors, got {a.device}")
    return out[0] if squeeze else out


closed_form_matmul.launches = build.LaunchCounter()         # tile design
closed_form_matmul.narrow_launches = build.LaunchCounter()  # narrow design
closed_form_matmul.decode_launches = build.LaunchCounter()  # decode design
closed_form_matmul.rows_launches = build.LaunchCounter()    # rows design
closed_form_matmul.wide_launches = build.LaunchCounter()    # wide design


def approx_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M,K)@(K,N) under the paper's proposed 8-bit multiplier."""
    return closed_form_matmul(a, b, "proposed")
