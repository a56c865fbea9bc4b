"""LUT-input contraction: the wrapper of ``csrc/lut_matmul.cu``.

Counterpart of ``repro.kernels.lut_matmul.ops``. ``lut_matmul(a, b, table)``
computes (M,K)@(K,N), or batched (B,M,K)@(B,K,N), int32, with every scalar
product read from the flat (2^{2N},) product table of any wiring at widths
3..8 (``core.lut.flat_lut``):

    f(a, b) = table[((a + 2^(N-1)) & (2^N - 1)) << N | ((b + 2^(N-1)) & (2^N - 1))]

which biases the signed operands into table rows/columns and wraps
out-of-range ints to their low N bits; the sum is exact in the int32 ring.

* a CUDA tensor launches a hand-written kernel (they replace the TPU kernel
  ``repro/kernels/lut_matmul/kernel.py``, ``lut_matmul_pallas``; designs
  and bounds in the source's header) or raises — there is no fallback.
  The shape, the width and the table pick the design, in this order
  (``kernels.blocking``): the *narrow* design (N ≤ 8, K ≤ 16: every shape
  the edge plans give it) copies each coefficient's table column
  (:func:`table_columns`) into int16 and streams the rows against it; the
  *tensor* design (the table is the exact product at width 8, M ≤ 16, K ≤
  131071: the ``exact`` dense layers of an LM decode step) computes the
  int8 product on the INT8 tensor cores and reads no table; the *decode*
  design (M ≤ 16) gathers every product from an int16 twin of the table
  (:func:`table16`) in shared memory; the *rows* design (M > 16, widths
  3..8, a table that :func:`rows_decomposition` takes apart into at most
  ``monomials.MAX_PLANES`` bit-monomial planes: every product table of a
  CSP wiring, and ``exact`` with none) runs an exact int8 GEMM plus those
  planes on the INT8 tensor cores; the *gather* design takes every other
  table (entries beyond int16, or an int16 table beyond the rows planes at
  M > 16; no served path) at the shapes where it beats the tile design
  (``blocking.gather_design``): the table in shared memory (its int16
  twin, else the int32 table in row windows of 128 KiB, two at width 8),
  one gather per product, each weight code read once per 16-row tile. The
  *tile* design (16×16 output tiles, an L2 gather per product) keeps the
  rest, narrow N at many rows under a table beyond int16 (the edge
  contraction), and is the forced ``_launch(..., design="tile")``. A
  table not from
  :func:`device_table` is checked once per tensor version (int16 range,
  exact product, planes), which synchronises. The tensor, decode, rows and
  gather designs take the int8 codes ``dense`` hands over without a copy.
  A narrow batch that is not 16-byte aligned is copied first, as in
  ``kernels.approx_matmul``;
* a CPU tensor runs :func:`lut_matmul_plain`, k walked in slabs.

``lut_matmul.launches`` counts tile launches, ``.narrow_launches``,
``.tensor_launches``, ``.decode_launches``, ``.rows_launches`` and
``.gather_launches`` those of the other designs, each also by its ``(B, M,
K, N)`` (``.by_shape()``). Plain twins: :func:`table_columns` with
:func:`~repro_torch.kernels.blocking.narrow_matmul_plain` (narrow),
:func:`~repro_torch.kernels.blocking.tensor_matmul_plain` (tensor),
:func:`table16` with :func:`~repro_torch.kernels.blocking.decode_matmul_plain`
(decode), :func:`rows_decomposition` with
:func:`~repro_torch.kernels.blocking.rows_matmul_plain` (rows),
:func:`lut_matmul_plain` itself (gather: its windows split the sum by
activation code, which the int32 ring does not see).

The table must lie on the operands' device: :func:`device_table` keeps one
per (wiring, device), uploaded once, so no call copies a table.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core import multiplier as mult
from repro_torch.kernels import blocking, build, monomials
from repro_torch.kernels.blocking import (decode_matmul_plain,  # noqa: F401
                                          narrow_matmul_plain,
                                          rows_matmul_plain,
                                          tensor_matmul_plain)
from repro_torch.obs.trace import trace_span

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_NARROW_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p)
_DECODE_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_TENSOR_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p)
_ROWS_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p)
_GATHER_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_INT16 = (-(1 << 15), (1 << 15) - 1)


def _exact_product8() -> np.ndarray:
    """The flat table of the exact product of signed 8-bit codes,
    ``[xa << 8 | xb] = (xa − 128)·(xb − 128)``: what the tensor design
    computes."""
    x = np.arange(256, dtype=np.int32) - 128
    return (x[:, None] * x[None, :]).reshape(-1)


def table_width(size: int) -> int:
    """Operand width N implied by a flat table length 2^(2N)."""
    n = (max(int(size), 1).bit_length() - 1) // 2
    if (1 << (2 * n)) != size:
        raise ValueError(
            f"not a flat product-LUT length: {size} (expected 2^(2N) for an "
            "operand width N; build it with core.lut.flat_lut)")
    return n


def device_table(mult_key: str, device) -> torch.Tensor:
    """The flat int32 product table of ``mult_key`` on ``device``, built and
    uploaded once per (key, device)."""
    key = mult.canonical_key(mult_key)
    t = build.device_constant(("flat_lut", key), device,
                              lambda: lut_lib.flat_lut(key))
    if not hasattr(t, "_int16_at"):  # checked on the host copy, no sync
        host = lut_lib.flat_lut(key)
        fits = bool(host.min() >= _INT16[0] and host.max() <= _INT16[1])
        if fits:  # the decode design's twin, complete before any stream reads it
            t._table16 = (t._version, build.device_constant(
                ("flat_lut16", key), device, lambda: host.astype(np.int16)))
        t._exact_at = (t._version, bool(np.array_equal(host, _exact_product8())))
        d = monomials.cached(("flat_lut", key), lambda: monomials.try_decompose(host))
        t._rows_at = (t._version, d, None if d is None else build.device_constant(
            ("flat_lut_rows", key), device, lambda: monomials.device_planes(d)))
        t._int16_at = (t._version, fits)
    return t


def _fits_int16(table: torch.Tensor) -> bool:
    """Whether every entry of ``table`` is an int16, as the narrow design's
    columns store it; computed once per tensor version."""
    version, ok = getattr(table, "_int16_at", (None, False))
    if version != table._version:
        ok = bool(((table >= _INT16[0]) & (table <= _INT16[1])).all())
        table._int16_at = (table._version, ok)
    return ok


def _is_exact(table: torch.Tensor) -> bool:
    """Whether ``table`` is the exact product of signed 8-bit codes, which
    the tensor design computes; marked by :func:`device_table`, else
    computed once per tensor version."""
    version, ok = getattr(table, "_exact_at", (None, False))
    if version != table._version:
        ok = table.numel() == 1 << 16 and bool(torch.equal(
            table, torch.from_numpy(_exact_product8()).to(table.device)))
        table._exact_at = (table._version, ok)
    return ok


def _rows(table: torch.Tensor) -> tuple:
    """(decomposition, its device planes) of ``table`` for the rows design,
    or (None, None) where its factors do not fit int8 planes or need more
    than ``monomials.MAX_PLANES``; marked by :func:`device_table`, else
    computed once per tensor version (which synchronises)."""
    version, d, planes = getattr(table, "_rows_at", (None, None, None))
    if version != table._version:
        d = monomials.try_decompose(table.cpu().numpy())
        planes = None
        if d is not None:
            planes = torch.from_numpy(monomials.device_planes(d)).to(table.device)
            if planes.is_cuda:  # complete before another stream reads it
                torch.cuda.current_stream(planes.device).synchronize()
        table._rows_at = (table._version, d, planes)
    return d, planes


def rows_decomposition(table: torch.Tensor) -> "monomials.Decomposition | None":
    """The rows design's planes of a flat product table (an exact int8 GEMM
    plus bit-monomial int8 GEMMs; ``kernels.monomials``), or None for a
    table the rows design does not take."""
    return _rows(table)[0]


def table16(table: torch.Tensor) -> torch.Tensor:
    """The decode design's int16 twin of a flat table whose entries all fit
    int16 (:func:`_fits_int16`): the same (2^(2n),) layout. Kept once per
    tensor version; one from :func:`device_table` is built with the table."""
    version, t16 = getattr(table, "_table16", (None, None))
    if version != table._version:
        t16 = table.to(torch.int16)
        if t16.is_cuda:  # complete before another stream reads it
            torch.cuda.current_stream(t16.device).synchronize()
        table._table16 = (table._version, t16)
    return t16


def gather_table(table: torch.Tensor) -> torch.Tensor:
    """The table the gather design keeps in shared memory: its int16 twin
    (:func:`table16`) where every entry fits int16, else the int32 table
    itself (read in row windows)."""
    return table16(table) if _fits_int16(table) else table


def table_columns(b: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The narrow design's product columns, plain, on any device: (B,K,N)
    coefficients → (B,K,N,2^n) int32 with ``[z,k,j,x] = table[x << n |
    ((b[z,k,j] + off) & mask)]``: the table's column of each coefficient
    (the pixel is the row operand)."""
    n = table_width(table.shape[0])
    off, mask = 1 << (n - 1), (1 << n) - 1
    x = torch.arange(1 << n, dtype=torch.int32, device=b.device)
    bi = (b.to(torch.int32)[..., None] + off) & mask
    return table[((x << n) | bi).long()]


def _check_table(table: torch.Tensor, device) -> int:
    if not torch.is_tensor(table) or table.dim() != 1 \
            or table.dtype != torch.int32:
        raise ValueError("table must be a flat (2^(2N),) int32 tensor "
                         "(device_table or core.lut.flat_lut)")
    if table.device != device:
        raise ValueError(f"table lies on {table.device}, operands on {device}: "
                         "use device_table(key, device)")
    n = table_width(table.shape[0])
    if not 1 <= n <= lut_lib.MAX_LUT_BITS:
        raise ValueError(f"table width {n} outside 1..{lut_lib.MAX_LUT_BITS}")
    return n


def lut_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel on (B,M,K)@(B,K,N), any device: k
    walked in slabs, each a batched gather
    (:func:`~repro_torch.kernels.blocking.decode_matmul_plain`, which takes
    a table of any integer dtype). The last slab is just shorter (no zero
    padding, so no f(0,0) to subtract)."""
    return blocking.decode_matmul_plain(a, b, table, table_width(table.shape[0]))


def table_checks(table: torch.Tensor) -> dict:
    """What each design needs of the table, for
    :func:`~repro_torch.kernels.blocking.eligible_designs`: entries within
    int16 (narrow, decode), the exact product of 8-bit codes (tensor), at
    most ``monomials.MAX_PLANES`` int8 planes (rows), a width the gather
    design's windows take (gather: every flat table of width ≤ 8)."""
    return {"narrow": lambda: _fits_int16(table),
            "tensor": lambda: _is_exact(table),
            "decode": lambda: _fits_int16(table),
            "rows": lambda: rows_decomposition(table) is not None,
            "gather": lambda: table_width(table.numel()) <= blocking.GATHER_MAX_BITS}


def _launch(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor,
            n_bits: int, design: "str | None" = None) -> torch.Tensor:
    """Launch the kernel of ``design`` (``"narrow"``, ``"tensor"``,
    ``"decode"``, ``"rows"``, ``"gather"`` or ``"tile"``; None: the first of
    them that takes the shape, width and table) on CUDA (B,M,K)@(B,K,N)
    integer operands."""
    bsz, m, k = a.shape
    n = b.shape[2]
    design = blocking.resolve_design(
        design, blocking.eligible_designs(m, k, n, n_bits, table_checks(table),
                                          forced=design),
        "lut_matmul", f"M={m}, K={k}, N={n} at width {n_bits}, or a table "
        "beyond int16 (the tensor design: a table that is not the exact "
        "product; the rows design: one beyond its int8 planes)")
    if not (bsz <= 65535 and (n + 15) // 16 <= 65535 and max(m, k) < 2**31):
        raise ValueError(f"lut_matmul grid limit exceeded by "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if bsz * m * n == 0 or k == 0:
        return torch.zeros((bsz, m, n), dtype=torch.int32, device=a.device)
    if design in ("tensor", "decode"):
        a8 = blocking.codes8(a).contiguous()
        b8 = blocking.codes8(b).contiguous()
        out = torch.empty((bsz, m, n), dtype=torch.int32, device=a.device)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            if design == "tensor":
                fn = build.load_function("lut_matmul", "lut_matmul_tensor_launch",
                                         _TENSOR_ARGTYPES)
                rc = fn(a8.data_ptr(), b8.data_ptr(), out.data_ptr(), bsz, m, k,
                        n, stream)
            else:
                fn = build.load_function("lut_matmul", "lut_matmul_decode_launch",
                                         _DECODE_ARGTYPES)
                rc = fn(a8.data_ptr(), b8.data_ptr(), table16(table).data_ptr(),
                        out.data_ptr(), bsz, m, k, n, n_bits, stream)
        build.check(rc, f"lut_matmul_{design}_launch")
        counter = (lut_matmul.tensor_launches if design == "tensor"
                   else lut_matmul.decode_launches)
        counter.add((bsz, m, k, n))
        return out
    if design == "gather":
        a8 = blocking.codes8(a).contiguous()
        b8 = blocking.codes8(b).contiguous()
        t = gather_table(table)
        out = torch.empty((bsz, m, n), dtype=torch.int32, device=a.device)
        fn = build.load_function("lut_matmul", "lut_matmul_gather_launch",
                                 _GATHER_ARGTYPES)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = fn(a8.data_ptr(), b8.data_ptr(), t.data_ptr(), t.element_size(),
                    out.data_ptr(), bsz, m, k, n, n_bits, stream)
        build.check(rc, "lut_matmul_gather_launch")
        lut_matmul.gather_launches.add((bsz, m, k, n))
        return out
    if design == "rows":
        a8 = blocking.codes8(a).contiguous()
        b8 = blocking.codes8(b).contiguous()
        d, planes = _rows(table)
        out = torch.empty((bsz, m, n), dtype=torch.int32, device=a.device)
        fn = build.load_function("lut_matmul", "lut_matmul_rows_launch",
                                 _ROWS_ARGTYPES)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = fn(a8.data_ptr(), b8.data_ptr(), planes.data_ptr(),
                    out.data_ptr(), bsz, m, k, n, n_bits, d.planes, d.f00,
                    stream)
        build.check(rc, "lut_matmul_rows_launch")
        lut_matmul.rows_launches.add((bsz, m, k, n))
        return out
    a, b = a.to(torch.int32), b.to(torch.int32)
    if design == "narrow":
        a, b, out, cols, crop = blocking.narrow_operands(a, b, n_bits)
        fn = build.load_function("lut_matmul", "lut_matmul_narrow_launch",
                                 _NARROW_ARGTYPES)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = fn(a.data_ptr(), b.data_ptr(), table.data_ptr(),
                    out.data_ptr(), cols.data_ptr(), bsz, a.shape[1], k, n,
                    n_bits, stream)
        build.check(rc, "lut_matmul_narrow_launch")
        lut_matmul.narrow_launches.add((bsz, m, k, n))
        return out if crop is None else out[:, :crop].contiguous()
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty((bsz, m, n), dtype=torch.int32, device=a.device)
    fn = build.load_function("lut_matmul", "lut_matmul_launch", _ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), table.data_ptr(), out.data_ptr(),
                bsz, m, k, n, n_bits, stream)
    build.check(rc, "lut_matmul_launch")
    lut_matmul.launches.add((bsz, m, k, n))
    return out


def lut_matmul(a: torch.Tensor, b: torch.Tensor,
               table: torch.Tensor) -> torch.Tensor:
    """(M,K)@(K,N) or (B,M,K)@(B,K,N) under the product model in ``table``.

    ``table``: flat (2^{2N},) int32 tensor on the operands' device (raises
    otherwise). Returns int32 of shape (M,N) or (B,M,N). The operands'
    device decides: CUDA launches the kernel of the design the shape takes
    (or raises), CPU runs :func:`lut_matmul_plain`. Integer operands of any
    dtype give the same integers.
    """
    if not (torch.is_tensor(a) and torch.is_tensor(b)) or a.device != b.device:
        raise ValueError("operands must be tensors on one device")
    n_bits = _check_table(table, a.device)
    squeeze = a.dim() == 2
    with trace_span("kernel.lut_matmul", "kernel", m=a.shape[-2],
                    k=a.shape[-1], n=b.shape[-1]):
        a3, b3 = blocking.as3(a, b)
        if a.device.type == "cpu":
            out = lut_matmul_plain(a3.to(torch.int32), b3.to(torch.int32),
                                   table)
        elif a.device.type == "cuda":
            out = _launch(a3, b3, table, n_bits)
        else:
            raise ValueError(f"lut_matmul runs on cpu or cuda tensors, "
                             f"got {a.device}")
    return out[0] if squeeze else out


lut_matmul.launches = build.LaunchCounter()         # tile design
lut_matmul.narrow_launches = build.LaunchCounter()  # narrow design
lut_matmul.tensor_launches = build.LaunchCounter()  # tensor design
lut_matmul.decode_launches = build.LaunchCounter()  # decode design
lut_matmul.rows_launches = build.LaunchCounter()    # rows design
lut_matmul.gather_launches = build.LaunchCounter()  # gather design
