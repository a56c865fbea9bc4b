"""Adafactor: factored second moments, no momentum.

Counterpart of ``repro.optim.adafactor``, with its update rule. State per
parameter of two or more dimensions ``{"vr": shape[:-1], "vc": shape[:-2] +
shape[-1:]}``, else a full ``{"v": shape}``; the statistics in float32, the
update in the gradient's dtype, clipped to an RMS of ``clip_threshold``.

Dicts keyed by parameter name, as :mod:`repro_torch.optim.adamw`, and in
place as it is. The factoring and the clipping act per tensor, so the same
rule on the port's per-layer parameters is not ``repro``'s on its tree,
where each unit position's layers are one stacked tensor: there a layer
norm's scale is two-dimensional and factored, and the RMS clip spans all
the stacked layers. ``repro``'s launcher takes Adafactor only for MoE
configs, which the port does not have.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.optim.adamw import Optimizer

Tensor = torch.Tensor


def adafactor(decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    def init(params: Dict[str, Tensor]):
        def leaf(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32, device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}
        dev = next(iter(params.values())).device if params else None
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "mv": {k: leaf(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads: Dict[str, Tensor], state, params: Dict[str, Tensor], lr):
        state["step"] += 1
        beta = 1.0 - (state["step"].to(torch.float32) + 1.0) ** (-decay)
        for k, p in params.items():
            g, mv = grads[k], state["mv"][k]
            sq = torch.square(g.to(torch.float32))
            if p.dim() >= 2:
                vr = beta * mv["vr"] + (1 - beta) * (sq.mean(dim=-1) + eps)
                vc = beta * mv["vc"] + (1 - beta) * (sq.mean(dim=-2) + eps)
                denom = vr[..., None] * vc[..., None, :] / torch.clamp_min(
                    vr.mean(dim=-1)[..., None, None], eps)
                upd = g * torch.rsqrt(denom + eps).to(g.dtype)
                mv["vr"].copy_(vr)
                mv["vc"].copy_(vc)
            else:
                v = beta * mv["v"] + (1 - beta) * (sq + eps)
                upd = g * torch.rsqrt(v + eps).to(g.dtype)
                mv["v"].copy_(v)
            rms = torch.sqrt(torch.mean(torch.square(upd.to(torch.float32))) + eps)
            clip = 1.0 / torch.clamp_min(rms / clip_threshold, 1.0)
            p.copy_(p.to(torch.float32) - lr * clip * upd.to(torch.float32))
        return params, state

    return Optimizer(init, update)
