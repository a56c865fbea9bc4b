"""Approximate contraction: the wrapper of ``csrc/approx_matmul.cu``.

Counterpart of ``repro.kernels.approx_matmul.ops``.
``closed_form_matmul(a, b, mult_key)`` computes (M,K)@(K,N), or batched
(B,M,K)@(B,K,N), int32, with every scalar product the wiring's closed form
and an exact int32-ring sum:

* a CUDA tensor launches the hand-written kernel (it replaces the TPU kernel
  ``repro/kernels/approx_matmul/kernel.py``, ``approx_matmul_pallas``;
  design and bound in the source's header), with the batch as grid z, or
  raises — there is no fallback;
* a CPU tensor runs :func:`closed_form_matmul_plain`: k walked in slabs
  under the pad / crop / f(0,0) contract of ``kernels.blocking``.

:func:`approx_matmul` is the historical proposed@8 entry point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import multiplier as mult
from repro_torch.kernels import blocking, build
from repro_torch.kernels.closed_form import (closed_form_f00, closed_form_params,
                                             make_closed_form)
from repro_torch.obs.trace import trace_span

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p)


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


def _launch(a: torch.Tensor, b: torch.Tensor, key: str) -> torch.Tensor:
    a = a.contiguous()
    b = b.contiguous()
    bsz, m, k = a.shape
    n = b.shape[2]
    if not (bsz <= 65535 and (n + 15) // 16 <= 65535 and max(m, k) < 2**31):
        raise ValueError(f"approx_matmul grid limit exceeded by "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if bsz * m * n == 0 or k == 0:
        return torch.zeros((bsz, m, n), dtype=torch.int32, device=a.device)
    out = torch.empty((bsz, m, n), dtype=torch.int32, device=a.device)
    params = closed_form_params(key)
    fn = build.load_function("approx_matmul", "approx_matmul_launch", _ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, m, k, n,
                params.ctypes.data, stream)
    build.check(rc, "approx_matmul_launch")
    closed_form_matmul.launches.add()
    return out


def closed_form_matmul(a: torch.Tensor, b: torch.Tensor,
                       mult_key: str = "proposed") -> torch.Tensor:
    """(M,K)@(K,N) or (B,M,K)@(B,K,N) under any CSP wiring's closed form.

    ``mult_key``: ``"name[@N]"`` (aliases resolve). Returns int32 of shape
    (M,N) or (B,M,N). The operands' device decides: CUDA launches the kernel
    (or raises), CPU runs :func:`closed_form_matmul_plain`.
    """
    if not (torch.is_tensor(a) and torch.is_tensor(b)) or a.device != b.device:
        raise ValueError("operands must be tensors on one device")
    key = mult.canonical_key(mult_key)
    squeeze = a.dim() == 2
    a3, b3 = blocking.as3(a, b)
    with trace_span("kernel.closed_form_matmul", "kernel", mult=key,
                    m=a3.shape[1], k=a3.shape[2], n=b3.shape[2]):
        if a.device.type == "cpu":
            out = closed_form_matmul_plain(a3, b3, key)
        elif a.device.type == "cuda":
            out = _launch(a3, b3, key)
        else:
            raise ValueError(f"closed_form_matmul runs on cpu or cuda "
                             f"tensors, got {a.device}")
    return out[0] if squeeze else out


closed_form_matmul.launches = build.LaunchCounter()


def approx_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M,K)@(K,N) under the paper's proposed 8-bit multiplier."""
    return closed_form_matmul(a, b, "proposed")
