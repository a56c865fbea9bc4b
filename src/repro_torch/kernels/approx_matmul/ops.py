"""Approximate contraction: the wrapper of ``csrc/approx_matmul.cu``.

Counterpart of ``repro.kernels.approx_matmul.ops``.
``closed_form_matmul(a, b, mult_key)`` computes (M,K)@(K,N), or batched
(B,M,K)@(B,K,N), int32, with every scalar product the wiring's closed form
and an exact int32-ring sum:

* a CUDA tensor launches a hand-written kernel (they replace the TPU kernel
  ``repro/kernels/approx_matmul/kernel.py``, ``approx_matmul_pallas``;
  designs and bounds in the source's header) or raises — there is no
  fallback. :func:`~repro_torch.kernels.blocking.narrow_design` picks the
  design from the shape and width: the *narrow* design (N ≤ 8, K ≤ 16,
  width ≤ 8: every shape the served paths give it) tabulates the closed
  form per coefficient (:func:`closed_form_columns`) and streams the rows
  against those columns; the *tile* design (16×16 output tiles, the batch
  as grid z) takes every other shape. The narrow design needs 16-byte
  aligned batches: an A whose base is not 16-byte aligned (a view with a
  storage offset), or a batched A with M % 4 ≠ 0, is first copied into a
  fresh buffer, its rows zero-padded to a multiple of 4, and the result
  cropped;
* a CPU tensor runs :func:`closed_form_matmul_plain`: k walked in slabs
  under the pad / crop / f(0,0) contract of ``kernels.blocking``.

``closed_form_matmul.launches`` counts tile launches and
``closed_form_matmul.narrow_launches`` narrow ones. The narrow design's
plain twin is :func:`closed_form_columns` with
:func:`~repro_torch.kernels.blocking.narrow_matmul_plain`.

:func:`approx_matmul` is the historical proposed@8 entry point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import multiplier as mult
from repro_torch.kernels import blocking, build
from repro_torch.kernels.blocking import narrow_matmul_plain  # noqa: F401
from repro_torch.kernels.closed_form import (closed_form_f00, closed_form_params,
                                             make_closed_form)
from repro_torch.obs.trace import trace_span

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p)
_NARROW_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)


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


def _launch(a: torch.Tensor, b: torch.Tensor, key: str,
            design: "str | None" = None) -> torch.Tensor:
    """Launch the kernel of ``design`` (``"narrow"`` or ``"tile"``; None:
    :func:`~repro_torch.kernels.blocking.narrow_design` decides) on CUDA
    (B,M,K)@(B,K,N) int32."""
    bsz, m, k = a.shape
    n = b.shape[2]
    n_bits = mult.split_width(key)[1]
    design = blocking.resolve_design(
        design, blocking.narrow_design(k, n, n_bits), "approx_matmul",
        f"K={k}, N={n} at width {n_bits}")
    if not (bsz <= 65535 and (n + 15) // 16 <= 65535 and max(m, k) < 2**31):
        raise ValueError(f"approx_matmul grid limit exceeded by "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if bsz * m * n == 0 or k == 0:
        return torch.zeros((bsz, m, n), dtype=torch.int32, device=a.device)
    params = closed_form_params(key)
    if design == "narrow":
        a, b, out, cols, crop = blocking.narrow_operands(a, b, n_bits)
        fn = build.load_function("approx_matmul", "approx_matmul_narrow_launch",
                                 _NARROW_ARGTYPES)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), cols.data_ptr(),
                    bsz, a.shape[1], k, n, params.ctypes.data, stream)
        build.check(rc, "approx_matmul_narrow_launch")
        closed_form_matmul.narrow_launches.add()
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
    closed_form_matmul.launches.add()
    return out


def closed_form_matmul(a: torch.Tensor, b: torch.Tensor,
                       mult_key: str = "proposed") -> torch.Tensor:
    """(M,K)@(K,N) or (B,M,K)@(B,K,N) under any CSP wiring's closed form.

    ``mult_key``: ``"name[@N]"`` (aliases resolve). Returns int32 of shape
    (M,N) or (B,M,N). The operands' device decides: CUDA launches the
    kernel of the design the shape takes (or raises), CPU runs
    :func:`closed_form_matmul_plain`.
    """
    if not (torch.is_tensor(a) and torch.is_tensor(b)) or a.device != b.device:
        raise ValueError("operands must be tensors on one device")
    key = mult.canonical_key(mult_key)
    squeeze = a.dim() == 2
    with trace_span("kernel.closed_form_matmul", "kernel", mult=key,
                    m=a.shape[-2], k=a.shape[-1], n=b.shape[-1]):
        a3, b3 = blocking.as3(a, b)
        if a.device.type == "cpu":
            out = closed_form_matmul_plain(a3, b3, key)
        elif a.device.type == "cuda":
            out = _launch(a3, b3, key)
        else:
            raise ValueError(f"closed_form_matmul runs on cpu or cuda "
                             f"tensors, got {a.device}")
    return out[0] if squeeze else out


closed_form_matmul.launches = build.LaunchCounter()         # tile design
closed_form_matmul.narrow_launches = build.LaunchCounter()  # narrow design


def approx_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M,K)@(K,N) under the paper's proposed 8-bit multiplier."""
    return closed_form_matmul(a, b, "proposed")
