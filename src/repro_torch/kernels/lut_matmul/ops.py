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
  :func:`~repro_torch.kernels.blocking.narrow_design` picks the design from
  the shape and width: the *narrow* design (N ≤ 8, K ≤ 16: every shape the
  served plans give it) copies each coefficient's table column
  (:func:`table_columns`) into int16 and streams the rows against it; the
  *tile* design (16×16 output tiles, the batch as grid z) takes every
  other shape, and any table with an entry beyond int16 (no product table
  of a width ≤ 8 has one; a table not from :func:`device_table` is checked
  once per tensor version, which synchronises). A batch that is not
  16-byte aligned is copied first, as in ``kernels.approx_matmul``;
* a CPU tensor runs :func:`lut_matmul_plain`, k walked in slabs.

``lut_matmul.launches`` counts tile launches and
``lut_matmul.narrow_launches`` narrow ones. The narrow design's plain twin
is :func:`table_columns` with
:func:`~repro_torch.kernels.blocking.narrow_matmul_plain`.

The table must lie on the operands' device: :func:`device_table` keeps one
per (wiring, device), uploaded once, so no call copies a table.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core import multiplier as mult
from repro_torch.kernels import blocking, build
from repro_torch.kernels.blocking import narrow_matmul_plain  # noqa: F401
from repro_torch.obs.trace import trace_span

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_NARROW_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p)
_INT16 = (-(1 << 15), (1 << 15) - 1)


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
        t._int16_at = (t._version, bool(host.min() >= _INT16[0]
                                        and host.max() <= _INT16[1]))
    return t


def _fits_int16(table: torch.Tensor) -> bool:
    """Whether every entry of ``table`` is an int16, as the narrow design's
    columns store it; computed once per tensor version."""
    version, ok = getattr(table, "_int16_at", (None, False))
    if version != table._version:
        ok = bool(((table >= _INT16[0]) & (table <= _INT16[1])).all())
        table._int16_at = (table._version, ok)
    return ok


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
    walked in slabs, each a batched gather. The last slab is just shorter
    (no zero padding, so no f(0,0) to subtract)."""
    n = table_width(table.shape[0])
    off, mask = 1 << (n - 1), (1 << n) - 1
    bsz, m, k = a.shape
    nn = b.shape[2]
    ai = ((a + off) & mask) << n
    bi = (b + off) & mask
    k_chunk = blocking.plain_k_chunk(bsz, m, nn)
    acc = torch.zeros((bsz, m, nn), dtype=torch.int32, device=a.device)
    for k0 in range(0, k, k_chunk):
        idx = ai[:, :, k0:k0 + k_chunk, None] | bi[:, None, k0:k0 + k_chunk, :]
        acc += table[idx.long()].sum(dim=2, dtype=torch.int32)
    return acc


def _launch(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor,
            n_bits: int, design: "str | None" = None) -> torch.Tensor:
    """Launch the kernel of ``design`` (``"narrow"`` or ``"tile"``; None:
    :func:`~repro_torch.kernels.blocking.narrow_design` and the table's
    range decide) on CUDA (B,M,K)@(B,K,N) int32."""
    bsz, m, k = a.shape
    n = b.shape[2]
    design = blocking.resolve_design(
        design, blocking.narrow_design(k, n, n_bits) and _fits_int16(table),
        "lut_matmul", f"K={k}, N={n} at width {n_bits}, or a table beyond int16")
    if not (bsz <= 65535 and (n + 15) // 16 <= 65535 and max(m, k) < 2**31):
        raise ValueError(f"lut_matmul grid limit exceeded by "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if bsz * m * n == 0 or k == 0:
        return torch.zeros((bsz, m, n), dtype=torch.int32, device=a.device)
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
        lut_matmul.narrow_launches.add()
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
    lut_matmul.launches.add()
    return out


def lut_matmul(a: torch.Tensor, b: torch.Tensor,
               table: torch.Tensor) -> torch.Tensor:
    """(M,K)@(K,N) or (B,M,K)@(B,K,N) under the product model in ``table``.

    ``table``: flat (2^{2N},) int32 tensor on the operands' device (raises
    otherwise). Returns int32 of shape (M,N) or (B,M,N). The operands'
    device decides: CUDA launches the kernel of the design the shape takes
    (or raises), CPU runs :func:`lut_matmul_plain`.
    """
    if not (torch.is_tensor(a) and torch.is_tensor(b)) or a.device != b.device:
        raise ValueError("operands must be tensors on one device")
    n_bits = _check_table(table, a.device)
    squeeze = a.dim() == 2
    with trace_span("kernel.lut_matmul", "kernel", m=a.shape[-2],
                    k=a.shape[-1], n=b.shape[-1]):
        a3, b3 = blocking.as3(a, b)
        if a.device.type == "cpu":
            out = lut_matmul_plain(a3, b3, table)
        elif a.device.type == "cuda":
            out = _launch(a3, b3, table, n_bits)
        else:
            raise ValueError(f"lut_matmul runs on cpu or cuda tensors, "
                             f"got {a.device}")
    return out[0] if squeeze else out


lut_matmul.launches = build.LaunchCounter()         # tile design
lut_matmul.narrow_launches = build.LaunchCounter()  # narrow design
