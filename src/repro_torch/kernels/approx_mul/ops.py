"""Elementwise approximate multiply: the wrapper of ``csrc/approx_mul.cu``.

Counterpart of ``repro.kernels.approx_mul.ops``. ``approx_mul(a, b)`` is the
elementwise product of the paper's proposed 8-bit multiplier on two int32
tensors of one shape (any shape), with the integers of the hand-derived
closed form ``kernels.closed_form.approx_product_i32`` on every int32 input:

* a CUDA tensor launches the hand-written kernel (it replaces the TPU kernel
  ``repro/kernels/approx_mul/kernel.py``, ``approx_mul_pallas``; design and
  bound in the source's header) over the flat tensor, or raises — there is
  no fallback;
* a CPU tensor runs :func:`approx_mul_plain`.

The TPU wrapper pads the flat array to (256, 128) tiles; the CUDA kernel
bounds-checks the flat length itself, so nothing is padded here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.closed_form import approx_product_i32
from repro_torch.obs.trace import trace_span

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_void_p)


def approx_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel, on any device."""
    return approx_product_i32(a, b)


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a.to(torch.int32).contiguous()
    b = b.to(torch.int32).contiguous()
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    fn = build.load_function("approx_mul", "approx_mul_launch", _ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), stream)
    build.check(rc, "approx_mul_launch")
    approx_mul.launches.add(tuple(a.shape))
    return out


def approx_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise proposed approximate product of two equal-shape integer
    tensors; returns int32 of that shape. The operands' device decides: CUDA
    launches the kernel (or raises), CPU runs :func:`approx_mul_plain`."""
    if not (torch.is_tensor(a) and torch.is_tensor(b)) or a.device != b.device:
        raise ValueError("operands must be tensors on one device")
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")
    with trace_span("kernel.approx_mul", "kernel",
                    shape="x".join(map(str, a.shape))):
        if a.device.type == "cpu":
            return approx_mul_plain(a, b)
        if a.device.type != "cuda":
            raise ValueError(f"approx_mul runs on cpu or cuda tensors, "
                             f"got {a.device}")
        return _launch(a, b)


approx_mul.launches = build.LaunchCounter()
