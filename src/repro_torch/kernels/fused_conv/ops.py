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
  bound in the source's header) or raises — there is no fallback.
  :func:`stencil_design` picks the design from the width, the kernel size
  and the distinct taps: the *stencil* design (width ≤ 8, kh and kw ≤ 5:
  every served conv, both kinds) reads one int16 product column per
  distinct tap (:func:`fused_conv_columns`, built once per key, taps and
  device) and walks row strips, gathering each input row once per column;
  the *generic* design (widths 9..16 of the closed form, larger kernels)
  evaluates the product per pixel × tap. A view with a storage offset is
  copied to an aligned buffer before the stencil design's 16-byte loads;
* a CPU tensor runs :func:`fused_conv2d_plain`, the same algebra in torch:
  zero-pad, one product map per distinct coefficient per kernel row, then
  shifted adds (the TPU kernel's body, ``_fused_kernel``).

``fused_conv2d.launches`` counts closed-form launches and
``fused_conv2d.lut_launches`` table launches, in either design;
``fused_conv2d.stencil_launches`` counts the stencil design's, in either
kind. The stencil design's plain twin is :func:`fused_conv_columns` with
:func:`stencil_conv_plain`.
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

#: Limits of the stencil design (``ST_MAX_K``, ``ST_MAX_BITS`` in
#: fused_conv.cu). Kernel size: the kernel is compiled for each (kh, kw) up
#: to 5 × 5, since a thread's rolling window holds kh × 4 sums and 4 + kw − 1
#: pixels in registers. Width: one int16 column of 2^n entries per distinct
#: tap, at most 25 · 2^8 · 2 B = 12.5 KiB of shared memory.
STENCIL_MAX_K = 5
STENCIL_MAX_BITS = 8


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
    (else the generic design). A pure function of these four; every served
    conv (the 3×3 Laplacian, 2 distinct taps, width ≤ 8) is a stencil."""
    return (1 <= n_bits <= STENCIL_MAX_BITS and 1 <= kh <= STENCIL_MAX_K
            and 1 <= kw <= STENCIL_MAX_K and 1 <= distinct <= kh * kw)


def conv_design(taps: tuple, key: str) -> str:
    """``"stencil"`` or ``"generic"``: the design :func:`fused_conv2d`
    launches on the card for ``taps`` under ``key`` (:func:`stencil_design`
    on its width, kernel size and distinct wrapped taps)."""
    n = mult.split_width(key)[1]
    distinct = len(_wrapped_taps(taps, n)[0])
    return ("stencil" if stencil_design(n, len(taps), len(taps[0]), distinct)
            else "generic")


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
            if device.type == "cpu":
                x = torch.arange(1 << n, dtype=torch.int32) - (1 << (n - 1))
                c = torch.tensor(coeffs, dtype=torch.int32)[:, None]
                return make_closed_form(key)(x[None, :], c).to(torch.int16)
            return _closed_form_columns_on_card(coeffs, key, device)

    cols = build.device_constant(("fused_cols", kind, key, tuple(distinct)),
                                 device, make)
    return slots, cols


def _closed_form_columns_on_card(coeffs: list, key: str,
                                 device) -> torch.Tensor:
    """The closed-form kind's columns, evaluated by the column kernel on the
    caller's stream (``build.device_constant`` synchronises it once)."""
    c = torch.tensor(coeffs, dtype=torch.int32).to(device)
    params = closed_form_params(key)
    cols = torch.empty((len(coeffs), 1 << int(params[0])), dtype=torch.int16,
                       device=device)
    fn = build.load_function("fused_conv", "fused_conv2d_columns_launch",
                             _COLUMNS_ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(c.data_ptr(), cols.data_ptr(), len(coeffs), params.ctypes.data,
                stream)
    build.check(rc, "fused_conv2d_columns_launch")
    return cols


def stencil_conv_plain(x: torch.Tensor, slots, cols: torch.Tensor, n_bits: int,
                       kh: int, kw: int) -> torch.Tensor:
    """Plain twin of the stencil design on any device: (B, H, W) int32
    pixels against (D, 2^n) product columns. Zero-pad, bias each pixel to
    its column index ``(x + 2^(n−1)) & (2^n − 1)``, then per kernel row one
    gather per distinct column and kw column-shifted adds, summed in the
    int32 ring. Padded zeros are looked up (f(0, c) ≠ 0)."""
    off, mask = 1 << (n_bits - 1), (1 << n_bits) - 1
    x = x.to(torch.int32)
    _, h, w = x.shape
    ph, pw = kh // 2, kw // 2
    idx = ((F.pad(x, (pw, pw, ph, ph)) ^ off) & mask).long()
    cols32 = cols.to(device=x.device, dtype=torch.int32)
    slots = [int(v) for v in np.asarray(slots).reshape(-1)]
    acc = torch.zeros_like(x)
    for di in range(kh):
        band = idx[:, di:di + h, :]
        maps = {}
        for dj in range(kw):
            d = slots[di * kw + dj]
            if d not in maps:
                maps[d] = cols32[d][band]
            acc += maps[d][:, :, dj:dj + w]
    return acc


def _launch(imgs: torch.Tensor, taps: tuple, key: str, kind: str,
            design: "str | None" = None) -> torch.Tensor:
    """Launch the kernel of ``design`` (``"stencil"`` or ``"generic"``;
    None: :func:`stencil_design` decides) in product kind ``kind`` on a CUDA
    (B, H, W) batch."""
    x = imgs.to(torch.int32).contiguous()
    b, h, w = x.shape
    kh, kw = len(taps), len(taps[0])
    if kh * kw > MAX_TAPS:
        raise ValueError(f"fused conv kernel takes at most {MAX_TAPS} taps, "
                         f"got {kh}x{kw}")
    n_bits = mult.split_width(key)[1]
    design = blocking.resolve_design(
        design, {"stencil": conv_design(taps, key) == "stencil", "generic": True},
        "fused_conv", f"a {kh}x{kw} kernel at width {n_bits}")
    if not (b <= 65535 and (h + 7) // 8 <= 65535):
        raise ValueError(f"fused conv grid limit exceeded by {tuple(x.shape)}")
    counter = fused_conv2d.lut_launches if kind == "lut" else fused_conv2d.launches
    if x.numel() == 0:
        return torch.empty_like(x)
    if design == "stencil":
        if x.data_ptr() % 16:  # a view with a storage offset
            x = x.clone()
        out = torch.empty_like(x)
        slots, cols = fused_conv_columns(taps, key, kind, x.device)
        fn = build.load_function("fused_conv", "fused_conv2d_stencil_launch",
                                 _LUT_ARGTYPES)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(x.data_ptr(), out.data_ptr(), b, h, w, slots.ctypes.data,
                    kh, kw, cols.data_ptr(), cols.shape[0], n_bits, stream)
        build.check(rc, "fused_conv2d_stencil_launch")
        fused_conv2d.stencil_launches.add((b, h, w, kh, kw))
        counter.add((b, h, w, kh, kw))
        return out
    out = torch.empty_like(x)
    if kind == "lut":
        slots, cols = fused_conv_columns(taps, key, "lut", x.device)
        fn = build.load_function("fused_conv", "fused_conv2d_lut_launch",
                                 _LUT_ARGTYPES)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(x.data_ptr(), out.data_ptr(), b, h, w, slots.ctypes.data,
                    kh, kw, cols.data_ptr(), cols.shape[0], n_bits, stream)
        build.check(rc, "fused_conv2d_lut_launch")
        counter.add((b, h, w, kh, kw))
        return out
    tap_arr = np.ascontiguousarray(taps, dtype=np.int32)
    params = closed_form_params(key)
    fn = build.load_function("fused_conv", "fused_conv2d_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), b, h, w, tap_arr.ctypes.data,
                kh, kw, params.ctypes.data, stream)
    build.check(rc, "fused_conv2d_launch")
    counter.add((b, h, w, kh, kw))
    return out


def fused_conv2d(imgs: torch.Tensor, kernel, mult_key: str = "proposed", *,
                 kernel_kind: str = "auto") -> torch.Tensor:
    """Batched 'same' conv of (B, H, W) int32 images under ``mult_key``.

    ``kernel``: (kh, kw) integer taps (array, list or tensor). Coefficients
    outside the wiring's signed N-bit operand range wrap, as every
    multiplier operand does. ``kernel_kind``: one of :data:`KERNEL_KINDS`
    (the ``"lut"`` kind needs a width ≤ 8). The device of ``imgs`` decides:
    CUDA launches the kernel of the design :func:`stencil_design` picks (or
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
