"""Fused conv + approximate multiply: the wrapper of ``csrc/fused_conv.cu``.

Counterpart of ``repro.kernels.fused_conv.ops``. ``fused_conv2d(imgs,
kernel, mult_key)`` computes a batched 'same' integer convolution of
(B, H, W) int32 images in which every pixel × tap product is the wiring's
closed form and the sum is exact in the int32 ring:

* a CUDA tensor launches the hand-written kernel (it replaces the TPU kernel
  ``repro/kernels/fused_conv/kernel.py``, ``fused_conv_pallas``; design and
  bound in the source's header) or raises — there is no fallback;
* a CPU tensor runs :func:`fused_conv2d_plain`, the same algebra in torch:
  zero-pad, one product map per distinct coefficient per kernel row, then
  shifted adds (the TPU kernel's body, ``_fused_kernel``).

Only the closed-form product kind is ported: the LUT kind (``exact`` wiring,
``kernel="lut"``) comes with the LUT kernel.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import multiplier as mult
from repro_torch.kernels import build
from repro_torch.kernels.closed_form import closed_form_params, make_closed_form
from repro_torch.obs.trace import trace_span

MAX_TAPS = 256  # FC_MAX_TAPS: kh·kw taps travel by value with the launch

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p)


def _taps(kernel) -> tuple:
    """(kh, kw) nested tuples of Python int coefficients."""
    if torch.is_tensor(kernel):
        kernel = kernel.cpu().numpy()
    k = np.asarray(kernel)
    if k.ndim != 2 or k.size == 0:
        raise ValueError(f"conv kernel must be a non-empty (kh, kw) array, "
                         f"got shape {k.shape}")
    return tuple(tuple(int(c) for c in row) for row in k)


def fused_conv2d_plain(imgs: torch.Tensor, taps: tuple,
                       key: str) -> torch.Tensor:
    """Plain torch version of the kernel, on any device: zero-pad the batch,
    then per kernel row one product map per distinct coefficient and kw
    column-shifted adds. Padded zeros are multiplied (f(0, c) ≠ 0)."""
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


def _launch(imgs: torch.Tensor, taps: tuple, key: str) -> torch.Tensor:
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


def fused_conv2d(imgs: torch.Tensor, kernel, mult_key: str = "proposed"
                 ) -> torch.Tensor:
    """Batched 'same' conv of (B, H, W) int32 images under ``mult_key``.

    ``kernel``: (kh, kw) integer taps (array, list or tensor). Coefficients
    outside the wiring's signed N-bit operand range wrap, as every
    multiplier operand does. The device of ``imgs`` decides: CUDA launches
    the kernel (or raises), CPU runs :func:`fused_conv2d_plain`.
    """
    if not torch.is_tensor(imgs) or imgs.dim() != 3:
        raise ValueError("imgs must be a (B, H, W) tensor")
    taps = _taps(kernel)
    key = mult.canonical_key(mult_key)
    with trace_span("kernel.fused_conv2d", "kernel", mult=key,
                    shape="x".join(map(str, imgs.shape))):
        if imgs.device.type == "cpu":
            return fused_conv2d_plain(imgs, taps, key)
        if imgs.device.type != "cuda":
            raise ValueError(f"fused_conv2d runs on cpu or cuda tensors, "
                             f"got {imgs.device}")
        return _launch(imgs, taps, key)


fused_conv2d.launches = build.LaunchCounter()
