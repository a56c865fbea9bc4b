"""Matrix multiplication under the paper's approximate multiplier (façade).

Counterpart of ``repro.nn.approx_dot``: a thin layer over
:mod:`repro_torch.nn.substrate` that keeps the historical function
signatures and adds a spec-string front door for the ``dot_general``
contraction surface. Every product-mode choice goes through the substrate
registry:

* ``exact``           — plain dot in the compute dtype (float reference).
* ``int8``            — symmetric int8 quantization, exact integer matmul.
* ``approx_bitexact`` — width-N quantization, every scalar product the
                        paper's multiplier closed form (plain torch).
* ``approx_lut``      — the same contraction through the (2^N)² product
                        table.
* ``approx_stat``     — exact integer matmul + the separable statistical
                        error model E[e(a,b)] ≈ r[a] + c[b] − µ.
* ``approx_cuda``     — the hand-written CUDA kernels (alias
                        ``approx_pallas``); CPU tensors run their plain
                        versions.

A mode string may carry a multiplier wiring + width suffix
(``"approx_lut:design_du2022"``, ``"approx_bitexact:proposed@16"``); see
:func:`repro_torch.nn.substrate.get_substrate`. The operands are torch
tensors, and their device decides where the contraction runs.

:func:`approx_matmul_int` is the canonical integer-contraction entry point
(operands are int8 at widths ≤ 8 but int16 at wider widths);
``approx_matmul_int8`` survives as a deprecated alias.
"""
from __future__ import annotations

from typing import Literal, Optional

import torch

from repro_torch.nn import substrate as sub

Tensor = torch.Tensor
Mode = Literal["exact", "int8", "approx_bitexact", "approx_lut",
               "approx_stat", "approx_cuda", "approx_pallas"]

#: the historical ``dot``: plain matmul dims, the default quantization policy
_DEFAULT_FLOAT_SPEC = sub.ContractionSpec.matmul(quant=sub.QuantPolicy())


def approx_dot_general(x: Tensor, w: Tensor,
                       spec: Optional[sub.ContractionSpec] = None,
                       mode: Mode = "exact",
                       mult_name: str | None = None) -> Tensor:
    """General contraction under the chosen mode (spec-string front door).

    ``spec`` is a :class:`~repro_torch.nn.substrate.ContractionSpec` —
    dimension numbers and :class:`~repro_torch.nn.substrate.QuantPolicy`;
    None means plain integer matmul dims. mult_name defaults to the mode
    string's suffix, else ``"proposed"``.
    """
    return sub.get_substrate(mode, mult_name=mult_name).dot_general(x, w, spec)


def approx_matmul_int(a: Tensor, b: Tensor, mode: Mode = "approx_bitexact",
                      mult_name: str | None = None) -> Tensor:
    """Integer-domain (M,K)@(K,N) contraction under the chosen mode.

    Operands are int8 at widths ≤ 8, int16 at wider widths.
    mult_name defaults to the mode string's suffix, else ``"proposed"``.
    """
    return sub.get_substrate(mode, mult_name=mult_name).dot_int(a, b)


def approx_matmul_int8(a8: Tensor, b8: Tensor, mode: Mode = "approx_bitexact",
                       mult_name: str | None = None) -> Tensor:
    """Deprecated alias of :func:`approx_matmul_int` (the ``int8`` name was
    a lie at N=16, where operands are int16)."""
    return approx_matmul_int(a8, b8, mode=mode, mult_name=mult_name)


def approx_dot(x: Tensor, w: Tensor, mode: Mode = "exact",
               mult_name: str | None = None) -> Tensor:
    """``x @ w`` with the paper's multiplier as the scalar-product unit.

    x: (..., K) activations (any float dtype); w: (K, N) weights.
    Activations use a per-tensor dynamic scale; weights per-output-channel
    (= ``dot_general`` with the default ``QuantPolicy``). Returns the
    result in x's dtype.
    """
    return sub.get_substrate(mode, mult_name=mult_name).dot_general(
        x, w, _DEFAULT_FLOAT_SPEC)
