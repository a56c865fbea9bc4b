"""Fused conv + approximate multiply: the wrapper of ``csrc/fused_conv.cu``.

Counterpart of ``repro.kernels.fused_conv.ops``. ``fused_conv2d(imgs,
kernel, mult_key, kernel_kind=)`` computes a batched 'same' integer
convolution of (B, H, W) int32 images in which every pixel × tap product
goes through the wiring's multiplier and the sum is exact in the int32
ring. Two product kinds, as in the reference:

* ``"closed_form"`` — the wiring's closed form;
* ``"lut"`` — a read of the wiring's product table at
  ``((x + off) & mask) << N | ((c + off) & mask)`` (pixel first, tap
  second), the kind for product models with no closed form (``"exact"``);

``"auto"`` picks the closed form where the wiring has one, else the table.

* a CUDA tensor launches a hand-written kernel (they replace the TPU kernel
  ``repro/kernels/fused_conv/kernel.py``, ``fused_conv_pallas``; designs and
  bound in the sources' headers) or raises — there is no fallback.
  :func:`conv_design` picks the design from the width, the kernel size
  and the distinct taps: the *stencil* design (:func:`stencil_design`:
  width ≤ 8, kh and kw ≤ 5; every served conv, both kinds) reads one int16
  product column per distinct tap (:func:`fused_conv_columns`, built once
  per key, taps and device) and walks row strips, gathering each input row
  once per column; the *tiled* design (``csrc/conv_tiles.cuh``: every other
  conv, to 16 × 16 taps and width 16) stages output tiles and their halo
  by ``cp.async`` in persistent blocks and reads each staged pixel's
  product once per run of equal taps down a kernel column, from the
  product data of :func:`tiled_products`: the int16 columns (width ≤ 8),
  int32 columns or int32 byte tables (widths 9..16, :func:`tiled_source`).
  The *generic* design (the closed form per pixel × tap, or one column
  read per tap) takes only kernels beyond 16 rows or columns (at most
  256 taps), which the tiled design does not stage; no path of the
  repository runs one, and tests and ``chip_smoke.py`` force it
  (``_launch(..., design=)``) to time it beside the tiled design. A view
  with a storage offset is copied to an aligned buffer before the stencil
  design's 16-byte loads; the tiled design copies such a view 4 bytes at
  a time;
* a CPU tensor runs :func:`fused_conv2d_plain`, the same algebra in torch:
  zero-pad, one product map per distinct coefficient per kernel row, then
  shifted adds (the TPU kernel's body, ``_fused_kernel``).

``fused_conv2d.launches`` counts closed-form launches and
``fused_conv2d.lut_launches`` table launches, in any design;
``fused_conv2d.stencil_launches``, ``.tiled_launches`` and
``.generic_launches`` count each design's, in either kind. The stencil
design's plain twin is :func:`fused_conv_columns` with
:func:`stencil_conv_plain`, the tiled design's :func:`tiled_products` with
:func:`tiled_conv_plain`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import lut as lut_lib
from repro_torch.core import multiplier as mult
from repro_torch.kernels import blocking, build
from repro_torch.kernels.closed_form import closed_form_params, make_closed_form
from repro_torch.kernels.lut_matmul.ops import device_table
from repro_torch.obs.trace import trace_span

MAX_TAPS = 256  # FC_MAX_TAPS: kh·kw taps travel by value with the launch
KERNEL_KINDS = ("auto", "closed_form", "lut")

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p)
#: the generic LUT kind and the stencil design take the same arguments
_LUT_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_COLUMNS_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_void_p)
_TILED_ARGTYPES = _LUT_ARGTYPES[:-1] + (ctypes.c_int, ctypes.c_void_p)

#: Limits of the stencil design (``ST_MAX_K``, ``ST_MAX_BITS`` in
#: fused_conv.cu). Kernel size: the kernel is compiled for each (kh, kw) up
#: to 5 × 5, since a thread's rolling window holds kh × 4 sums and 4 + kw − 1
#: pixels in registers. Width: one int16 column of 2^n entries per distinct
#: tap, at most 25 · 2^8 · 2 B = 12.5 KiB of shared memory.
STENCIL_MAX_K = 5
STENCIL_MAX_BITS = 8

#: Limits of the tiled design (``TL_MAX_K`` in conv_tiles.cuh): any kernel to
#: 16 × 16, any width the closed form serves.
TILED_MAX_K = 16
TILED_MAX_BITS = 16
#: Product data of the tiled design, by its ``source`` code in conv_tiles.cuh
#: (``TL_COL16`` .. ``TL_BYTES_G``): int16 columns (width ≤ 8), int32
#: columns or int32 byte tables (widths 9..16), in shared memory or read
#: from global memory.
TILED_SOURCES = {"columns16": 0, "columns32": 1, "columns32_global": 2,
                 "bytes": 3, "bytes_global": 4}
#: Widths 9..16 stage int32 columns in shared memory up to TILED_SMEM bytes
#: of them and read them from global memory (L1) up to TILED_L1 bytes, else
#: byte tables, staged up to TILED_SMEM bytes, else read from global
#: memory: the fastest of tools/fused_conv_sweep.py's sources at every
#: width and tap count it measures (beyond TILED_SMEM a block with its
#: two staged tiles leaves room for no second block on a multiprocessor).
TILED_SMEM = 64 << 10
TILED_L1 = 96 << 10

def _taps(kernel) -> tuple:
    """(kh, kw) nested tuples of Python int coefficients."""
    if torch.is_tensor(kernel):
        kernel = kernel.cpu().numpy()
    k = np.asarray(kernel)
    if k.ndim != 2 or k.size == 0:
        raise ValueError(f"conv kernel must be a non-empty (kh, kw) array, "
                         f"got shape {k.shape}")
    return tuple(tuple(int(c) for c in row) for row in k)


def resolve_kind(key: str, kernel_kind: str) -> str:
    """``"closed_form"`` or ``"lut"``; ``"auto"`` takes the closed form where
    the wiring has one. ``"closed_form"`` raises for a product model with
    none (``"exact"``)."""
    if kernel_kind not in KERNEL_KINDS:
        raise ValueError(f"unknown fused-conv kernel kind {kernel_kind!r} "
                         f"(known: {KERNEL_KINDS})")
    if kernel_kind != "auto":
        if kernel_kind == "closed_form":
            make_closed_form(key)
        return kernel_kind
    try:
        make_closed_form(key)
        return "closed_form"
    except ValueError:  # no CSP wiring (e.g. "exact"): serve via the table
        return "lut"


def _lut_tap_product(key: str, device):
    """Product fn reading the flat table at the tap's column: the pixel is
    the first operand, the tap the second."""
    table = device_table(key, device)
    n = mult.split_width(key)[1]
    off, mask = 1 << (n - 1), (1 << n) - 1

    def fn(tile, c):
        return table[((((tile + off) & mask) << n)
                      | ((int(c) + off) & mask)).long()]

    return fn


def fused_conv2d_plain(imgs: torch.Tensor, taps: tuple, key: str,
                       kernel_kind: str = "closed_form") -> torch.Tensor:
    """Plain torch version of the kernel, on any device: zero-pad the batch,
    then per kernel row one product map per distinct coefficient and kw
    column-shifted adds. Padded zeros are multiplied (f(0, c) ≠ 0)."""
    if resolve_kind(key, kernel_kind) == "lut":
        cf = _lut_tap_product(key, imgs.device)
    else:
        cf = make_closed_form(key)
    x = imgs.to(torch.int32)
    _, h, w = x.shape
    kh, kw = len(taps), len(taps[0])
    ph, pw = kh // 2, kw // 2
    padded = F.pad(x, (pw, pw, ph, ph))
    acc = torch.zeros_like(x)
    for di, row in enumerate(taps):
        band = padded[:, di:di + h, :]
        maps = {}
        for dj, c in enumerate(row):
            if c not in maps:
                maps[c] = cf(band, c)
            acc += maps[c][:, :, dj:dj + w]
    return acc


def stencil_design(n_bits: int, kh: int, kw: int, distinct: int) -> bool:
    """Whether a conv at operand width ``n_bits`` with a (kh, kw) kernel of
    ``distinct`` distinct (wrapped) taps runs the stencil design on the card
    (else the tiled design). A pure function of these four; every served
    conv (the 3×3 Laplacian, 2 distinct taps, width ≤ 8) is a stencil."""
    return (1 <= n_bits <= STENCIL_MAX_BITS and 1 <= kh <= STENCIL_MAX_K
            and 1 <= kw <= STENCIL_MAX_K and 1 <= distinct <= kh * kw)


def conv_design(taps: tuple, key: str) -> str:
    """``"stencil"``, ``"tiled"`` or ``"generic"``: the design
    :func:`fused_conv2d` launches on the card for ``taps`` under ``key``
    (:func:`stencil_design` on its width, kernel size and distinct wrapped
    taps; the tiled design takes every other kernel to 16 × 16, the
    generic design only a kernel of more rows or columns)."""
    n = mult.split_width(key)[1]
    kh, kw = len(taps), len(taps[0])
    if stencil_design(n, kh, kw, len(_wrapped_taps(taps, n)[0])):
        return "stencil"
    return "tiled" if tiled_design(n, kh, kw) else "generic"


def tiled_design(n_bits: int, kh: int, kw: int) -> bool:
    """Whether the tiled design takes a (kh, kw) kernel at width ``n_bits``
    (every conv the stencil design refuses, and any other, to 16 × 16 and
    width 16)."""
    return (1 <= n_bits <= TILED_MAX_BITS and 1 <= kh <= TILED_MAX_K
            and 1 <= kw <= TILED_MAX_K)


def tiled_source(n_bits: int, distinct: int) -> str:
    """The product data the tiled design reads for ``distinct`` distinct taps
    at width ``n_bits`` (a key of :data:`TILED_SOURCES`): the int16
    columns to width 8; at widths 9..16 int32 columns, in shared memory up
    to :data:`TILED_SMEM` bytes and read from global memory up to
    :data:`TILED_L1`, else byte tables, in shared memory up to
    :data:`TILED_SMEM`, else read from global memory."""
    if n_bits <= STENCIL_MAX_BITS:
        return "columns16"
    columns = distinct * (4 << n_bits)
    if columns <= TILED_SMEM:
        return "columns32"
    if columns <= TILED_L1:
        return "columns32_global"
    tables = distinct * 4 * (256 + (1 << (n_bits - 8)))
    return "bytes" if tables <= TILED_SMEM else "bytes_global"


def _wrapped_taps(taps: tuple, n_bits: int) -> tuple[list, np.ndarray]:
    """(distinct wrapped tap indices ``(c + off) & mask``, sorted; the slot of
    each tap in that list, row-major uint8). Both kinds wrap the tap to
    n bits before anything else, so taps equal modulo 2^n share a column."""
    off, mask = 1 << (n_bits - 1), (1 << n_bits) - 1
    idx = [(c + off) & mask for row in taps for c in row]
    distinct = sorted(set(idx))
    return distinct, np.array([distinct.index(i) for i in idx], dtype=np.uint8)


def fused_conv_columns(taps: tuple, key: str, kind: str, device):
    """(slot of each tap, row-major uint8 numpy; int16 (D, 2^n) columns on
    ``device``) with ``cols[slot[t], x] = f(x − 2^(n−1), tap[t])``: one
    column per distinct tap value modulo 2^n, built once per (key, kind,
    taps, device) and kept there. The LUT kind reads the product table's
    columns; the closed-form kind evaluates its closed form, on the card by
    a column kernel (``fused_conv2d_columns_launch``), never from the host
    table. Raises for widths above 8 (products beyond int16)."""
    n = mult.split_width(key)[1]
    if not 1 <= n <= STENCIL_MAX_BITS:
        raise ValueError(f"{key}: product columns need a width <= "
                         f"{STENCIL_MAX_BITS}, got {n}")
    distinct, slots = _wrapped_taps(taps, n)
    device = torch.device(device)
    if kind == "lut":
        def make():
            table = lut_lib.build_lut(key)  # [pixel operand, tap operand]
            cols = np.ascontiguousarray(table[:, distinct].T)
            if cols.min() < -(1 << 15) or cols.max() >= 1 << 15:
                raise ValueError(f"{key}: products exceed int16")
            return cols.astype(np.int16)
    else:
        coeffs = [i - (1 << (n - 1)) for i in distinct]  # the wrapped taps

        def make():
            return _closed_form_columns(coeffs, key, device)

    cols = build.device_constant(("fused_cols", kind, key, tuple(distinct)),
                                 device, make)
    return slots, cols


def _closed_form_columns(coeffs: list, key: str, device) -> torch.Tensor:
    """(D, 2^n) closed-form columns of ``coeffs`` on ``device``, int16 to
    width 8 and int32 beyond: the column kernel on the card, on the
    caller's stream (``build.device_constant`` synchronises it once), the
    closed form in torch on the CPU."""
    device = torch.device(device)
    n = mult.split_width(key)[1]
    dtype = torch.int16 if n <= STENCIL_MAX_BITS else torch.int32
    if device.type == "cpu":
        x = torch.arange(1 << n, dtype=torch.int32) - (1 << (n - 1))
        c = torch.tensor(coeffs, dtype=torch.int32)[:, None]
        return make_closed_form(key)(x[None, :], c).to(dtype)
    c = torch.tensor(coeffs, dtype=torch.int32).to(device)
    params = closed_form_params(key)
    cols = torch.empty((len(coeffs), 1 << n), dtype=dtype, device=device)
    fn = build.load_function("fused_conv", "fused_conv2d_columns_launch",
                             _COLUMNS_ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(c.data_ptr(), cols.data_ptr(), len(coeffs), params.ctypes.data,
                stream)
    build.check(rc, "fused_conv2d_columns_launch")
    return cols


def _wide_coeffs(taps: tuple, key: str) -> tuple[list, np.ndarray, list]:
    """(distinct wrapped tap indices, slots, their signed taps) at a width
    9..16 of the closed form; raises at another width or for the LUT-only
    product models."""
    n = mult.split_width(key)[1]
    if not STENCIL_MAX_BITS < n <= TILED_MAX_BITS:
        raise ValueError(f"{key}: int32 columns and byte tables take widths "
                         f"{STENCIL_MAX_BITS + 1}..{TILED_MAX_BITS}, got {n}")
    make_closed_form(key)  # raises for a product model with no closed form
    distinct, slots = _wrapped_taps(taps, n)
    return distinct, slots, [i - (1 << (n - 1)) for i in distinct]


def fused_conv_columns32(taps: tuple, key: str, device):
    """(slot of each tap, row-major uint8 numpy; int32 (D, 2^n) columns on
    ``device``) with ``cols[slot[t], x] = f(x − 2^(n−1), tap[t])`` under the
    closed form at a width 9..16: the tiled design's columns, evaluated on
    the card by the int32 column kernel, built once per (key, taps,
    device)."""
    distinct, slots, coeffs = _wide_coeffs(taps, key)
    cols = build.device_constant(
        ("fused_cols32", key, tuple(distinct)), device,
        lambda: _closed_form_columns(coeffs, key, device))
    return slots, cols


def byte_tables_from_columns(cols: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(D, 256 + 2^(n−8)) int32 byte tables of (D, 2^n) int32 columns at a
    width 9..16: ``lo = cols[:, :256]`` and ``hi[h] = cols[:, h << 8] −
    cols[:, 0]``, so that ``cols[:, u] = lo[u & 255] + hi[u >> 8]`` in the
    int32 ring, which is checked on every entry (raises where the columns
    do not split by byte)."""
    lo = cols[:, :256]
    hi = cols[:, ::256] - cols[:, :1]
    u = torch.arange(1 << n_bits, device=cols.device)
    if not torch.equal(lo[:, u & 255] + hi[:, u >> 8], cols):
        raise ValueError(f"width-{n_bits} product columns that do not split "
                         "into byte tables")
    return torch.cat([lo, hi], dim=1).contiguous()


def fused_conv_byte_tables(taps: tuple, key: str, device):
    """(slot of each tap, row-major uint8 numpy; int32 (D, 256 + 2^(n−8))
    byte tables on ``device``) of the closed form at a width 9..16:
    ``f(x, tap[t]) = tab[slot[t], u & 255] + tab[slot[t], 256 + (u >> 8)]``
    with ``u = (x + 2^(n−1)) & (2^n − 1)``. Split from the int32 columns
    (evaluated on the card, not kept) by :func:`byte_tables_from_columns`,
    built once per (key, taps, device)."""
    distinct, slots, coeffs = _wide_coeffs(taps, key)
    n = mult.split_width(key)[1]
    tabs = build.device_constant(
        ("fused_bytes", key, tuple(distinct)), device,
        lambda: byte_tables_from_columns(_closed_form_columns(coeffs, key, device),
                                         n))
    return slots, tabs


def tiled_products(taps: tuple, key: str, kind: str, device,
                   source: "str | None" = None):
    """(slots, product data, source) of the tiled design for ``taps`` under
    ``key`` in product kind ``kind``: :func:`fused_conv_columns` for
    ``"columns16"``, :func:`fused_conv_columns32` for ``"columns32*"``,
    :func:`fused_conv_byte_tables` for ``"bytes*"``; ``source`` None takes
    :func:`tiled_source`'s."""
    n = mult.split_width(key)[1]
    if source is None:
        source = tiled_source(n, len(_wrapped_taps(taps, n)[0]))
    if source not in TILED_SOURCES:
        raise ValueError(f"unknown tiled product source {source!r}")
    if source == "columns16":
        return (*fused_conv_columns(taps, key, kind, device), source)
    if kind != "closed_form":
        raise ValueError(f"the {source} product data is the closed form's; "
                         f"the {kind} kind takes widths <= {STENCIL_MAX_BITS}")
    build_ = fused_conv_byte_tables if source.startswith("bytes") \
        else fused_conv_columns32
    return (*build_(taps, key, device), source)


def tiled_conv_plain(x: torch.Tensor, slots, prod: torch.Tensor, n_bits: int,
                     kh: int, kw: int, source: str = "columns") -> torch.Tensor:
    """Plain twin of the tiled and stencil designs on any device: (B, H, W)
    int32 pixels against the product data the kernel stages, (D, 2^n)
    columns (``source`` ``"columns*"``) or (D, 256 + 2^(n−8)) byte tables
    (``"bytes*"``). Zero-pad, bias each pixel to its column index ``u = (x +
    2^(n−1)) & (2^n − 1)``, then per kernel row one product map per
    distinct column (``prod[d, u]``, or ``prod[d, u & 255] + prod[d, 256 +
    (u >> 8)]``) and kw column-shifted adds, summed in the int32 ring.
    Padded zeros are looked up (f(0, c) ≠ 0)."""
    off, mask = 1 << (n_bits - 1), (1 << n_bits) - 1
    x = x.to(torch.int32)
    _, h, w = x.shape
    ph, pw = kh // 2, kw // 2
    idx = ((F.pad(x, (pw, pw, ph, ph)) ^ off) & mask).long()
    prod32 = prod.to(device=x.device, dtype=torch.int32)
    slots = [int(v) for v in np.asarray(slots).reshape(-1)]

    def product(d, band):
        if source.startswith("bytes"):
            return prod32[d][band & 255] + prod32[d][256 + (band >> 8)]
        return prod32[d][band]

    acc = torch.zeros_like(x)
    for di in range(kh):
        band = idx[:, di:di + h, :]
        maps = {}
        for dj in range(kw):
            d = slots[di * kw + dj]
            if d not in maps:
                maps[d] = product(d, band)
            acc += maps[d][:, :, dj:dj + w]
    return acc


def stencil_conv_plain(x: torch.Tensor, slots, cols: torch.Tensor, n_bits: int,
                       kh: int, kw: int) -> torch.Tensor:
    """Plain twin of the stencil design on any device: (B, H, W) int32
    pixels against (D, 2^n) product columns, :func:`tiled_conv_plain` on
    columns (the two designs read the same int16 columns)."""
    return tiled_conv_plain(x, slots, cols, n_bits, kh, kw, "columns")


def _launch(imgs: torch.Tensor, taps: tuple, key: str, kind: str,
            design: "str | None" = None,
            source: "str | None" = None) -> torch.Tensor:
    """Launch the kernel of ``design`` (``"stencil"``, ``"tiled"`` or
    ``"generic"``; None: :func:`conv_design` decides) in product kind
    ``kind`` on a CUDA (B, H, W) batch; ``source`` forces the tiled
    design's product data (:data:`TILED_SOURCES`)."""
    x = imgs.to(torch.int32).contiguous()
    b, h, w = x.shape
    kh, kw = len(taps), len(taps[0])
    if kh * kw > MAX_TAPS:
        raise ValueError(f"fused conv kernel takes at most {MAX_TAPS} taps, "
                         f"got {kh}x{kw}")
    n_bits = mult.split_width(key)[1]
    design = blocking.resolve_design(
        design, {"stencil": conv_design(taps, key) == "stencil",
                 "tiled": tiled_design(n_bits, kh, kw), "generic": True},
        "fused_conv", f"a {kh}x{kw} kernel at width {n_bits}")
    if design == "generic" and not (b <= 65535 and (h + 7) // 8 <= 65535):
        raise ValueError(f"fused conv grid limit exceeded by {tuple(x.shape)}")
    counter = fused_conv2d.lut_launches if kind == "lut" else fused_conv2d.launches
    if x.numel() == 0:
        return torch.empty_like(x)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if design == "tiled":
        slots, prod, source = tiled_products(taps, key, kind, x.device, source)
        fn = build.load_function("fused_conv", "fused_conv2d_tiled_launch",
                                 _TILED_ARGTYPES)
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), out.data_ptr(), b, h, w, slots.ctypes.data,
                    kh, kw, prod.data_ptr(), prod.shape[0], n_bits,
                    TILED_SOURCES[source], stream)
        build.check(rc, "fused_conv2d_tiled_launch")
        fused_conv2d.tiled_launches.add((b, h, w, kh, kw))
    elif design == "stencil":
        if x.data_ptr() % 16:  # a view with a storage offset
            x = x.clone()
        slots, cols = fused_conv_columns(taps, key, kind, x.device)
        fn = build.load_function("fused_conv", "fused_conv2d_stencil_launch",
                                 _LUT_ARGTYPES)
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), out.data_ptr(), b, h, w, slots.ctypes.data,
                    kh, kw, cols.data_ptr(), cols.shape[0], n_bits, stream)
        build.check(rc, "fused_conv2d_stencil_launch")
        fused_conv2d.stencil_launches.add((b, h, w, kh, kw))
    elif kind == "lut":
        slots, cols = fused_conv_columns(taps, key, "lut", x.device)
        fn = build.load_function("fused_conv", "fused_conv2d_lut_launch",
                                 _LUT_ARGTYPES)
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), out.data_ptr(), b, h, w, slots.ctypes.data,
                    kh, kw, cols.data_ptr(), cols.shape[0], n_bits, stream)
        build.check(rc, "fused_conv2d_lut_launch")
        fused_conv2d.generic_launches.add((b, h, w, kh, kw))
    else:
        tap_arr = np.ascontiguousarray(taps, dtype=np.int32)
        params = closed_form_params(key)
        fn = build.load_function("fused_conv", "fused_conv2d_launch", _ARGTYPES)
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), out.data_ptr(), b, h, w, tap_arr.ctypes.data,
                    kh, kw, params.ctypes.data, stream)
        build.check(rc, "fused_conv2d_launch")
        fused_conv2d.generic_launches.add((b, h, w, kh, kw))
    counter.add((b, h, w, kh, kw))
    return out


def fused_conv2d(imgs: torch.Tensor, kernel, mult_key: str = "proposed", *,
                 kernel_kind: str = "auto") -> torch.Tensor:
    """Batched 'same' conv of (B, H, W) int32 images under ``mult_key``.

    ``kernel``: (kh, kw) integer taps (array, list or tensor). Coefficients
    outside the wiring's signed N-bit operand range wrap, as every
    multiplier operand does. ``kernel_kind``: one of :data:`KERNEL_KINDS`
    (the ``"lut"`` kind needs a width ≤ 8). The device of ``imgs`` decides:
    CUDA launches the kernel of the design :func:`conv_design` picks (or
    raises), CPU runs :func:`fused_conv2d_plain`.
    """
    if not torch.is_tensor(imgs) or imgs.dim() != 3:
        raise ValueError("imgs must be a (B, H, W) tensor")
    taps = _taps(kernel)
    key = mult.canonical_key(mult_key)
    kind = resolve_kind(key, kernel_kind)
    with trace_span("kernel.fused_conv2d", "kernel", mult=key, kind=kind,
                    shape="x".join(map(str, imgs.shape))):
        if imgs.device.type == "cpu":
            return fused_conv2d_plain(imgs, taps, key, kind)
        if imgs.device.type != "cuda":
            raise ValueError(f"fused_conv2d runs on cpu or cuda tensors, "
                             f"got {imgs.device}")
        return _launch(imgs, taps, key, kind)


fused_conv2d.launches = build.LaunchCounter()           # closed-form kind
fused_conv2d.lut_launches = build.LaunchCounter()       # LUT kind
fused_conv2d.stencil_launches = build.LaunchCounter()   # stencil design
fused_conv2d.tiled_launches = build.LaunchCounter()     # tiled design
fused_conv2d.generic_launches = build.LaunchCounter()   # generic design (forced)
