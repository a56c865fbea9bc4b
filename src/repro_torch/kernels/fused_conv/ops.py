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

* a CUDA tensor launches the hand-written kernel of its kind (they replace
  the TPU kernel ``repro/kernels/fused_conv/kernel.py``,
  ``fused_conv_pallas``; design and bound in the source's header) or
  raises — there is no fallback;
* a CPU tensor runs :func:`fused_conv2d_plain`, the same algebra in torch:
  zero-pad, one product map per distinct coefficient per kernel row, then
  shifted adds (the TPU kernel's body, ``_fused_kernel``).

``fused_conv2d.launches`` counts closed-form launches and
``fused_conv2d.lut_launches`` table launches. The LUT kind's per-tap table
columns stay on the card, built once per (wiring, taps, device).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import lut as lut_lib
from repro_torch.core import multiplier as mult
from repro_torch.kernels import build
from repro_torch.kernels.closed_form import closed_form_params, make_closed_form
from repro_torch.kernels.lut_matmul.ops import device_table
from repro_torch.obs.trace import trace_span

MAX_TAPS = 256  # FC_MAX_TAPS: kh·kw taps travel by value with the launch
KERNEL_KINDS = ("auto", "closed_form", "lut")

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p)
_LUT_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


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


def _lut_columns(key: str, taps: tuple, device):
    """(slot of each tap, row-major uint8; int16 columns on ``device``): one
    2^N-entry column f(·, c) of the product table per distinct wrapped tap
    value, built once per (key, taps, device)."""
    n = mult.split_width(key)[1]
    off, mask = 1 << (n - 1), (1 << n) - 1
    idx = [(c + off) & mask for row in taps for c in row]
    distinct = sorted(set(idx))
    slots = np.array([distinct.index(i) for i in idx], dtype=np.uint8)

    def make():
        table = lut_lib.build_lut(key)  # [pixel operand, tap operand]
        cols = np.ascontiguousarray(table[:, distinct].T)
        if cols.min() < -(1 << 15) or cols.max() >= 1 << 15:
            raise ValueError(f"{key}: products exceed int16")
        return cols.astype(np.int16)

    cols = build.device_constant(("fused_lut_cols", key, tuple(distinct)),
                                 device, make)
    return slots, cols


def _launch(imgs: torch.Tensor, taps: tuple, key: str,
            kind: str) -> torch.Tensor:
    x = imgs.to(torch.int32).contiguous()
    b, h, w = x.shape
    kh, kw = len(taps), len(taps[0])
    if kh * kw > MAX_TAPS:
        raise ValueError(f"fused conv kernel takes at most {MAX_TAPS} taps, "
                         f"got {kh}x{kw}")
    if not (b <= 65535 and (h + 7) // 8 <= 65535):
        raise ValueError(f"fused conv grid limit exceeded by {tuple(x.shape)}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if kind == "lut":
        slots, cols = _lut_columns(key, taps, x.device)
        n_bits = mult.split_width(key)[1]
        fn = build.load_function("fused_conv", "fused_conv2d_lut_launch",
                                 _LUT_ARGTYPES)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(x.data_ptr(), out.data_ptr(), b, h, w, slots.ctypes.data,
                    kh, kw, cols.data_ptr(), cols.shape[0], n_bits, stream)
        build.check(rc, "fused_conv2d_lut_launch")
        fused_conv2d.lut_launches.add()
        return out
    tap_arr = np.ascontiguousarray(taps, dtype=np.int32)
    params = closed_form_params(key)
    fn = build.load_function("fused_conv", "fused_conv2d_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), b, h, w, tap_arr.ctypes.data,
                kh, kw, params.ctypes.data, stream)
    build.check(rc, "fused_conv2d_launch")
    fused_conv2d.launches.add()
    return out


def fused_conv2d(imgs: torch.Tensor, kernel, mult_key: str = "proposed", *,
                 kernel_kind: str = "auto") -> torch.Tensor:
    """Batched 'same' conv of (B, H, W) int32 images under ``mult_key``.

    ``kernel``: (kh, kw) integer taps (array, list or tensor). Coefficients
    outside the wiring's signed N-bit operand range wrap, as every
    multiplier operand does. ``kernel_kind``: one of :data:`KERNEL_KINDS`
    (the ``"lut"`` kind needs a width ≤ 8). The device of ``imgs`` decides:
    CUDA launches the kernel (or raises), CPU runs
    :func:`fused_conv2d_plain`.
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


fused_conv2d.launches = build.LaunchCounter()      # closed-form kind
fused_conv2d.lut_launches = build.LaunchCounter()  # LUT kind
