"""AdamW with decoupled weight decay.

Counterpart of ``repro.optim.adamw``, with its update rule: float32
moments, bias correction from the step count, decoupled weight decay, the
new parameter computed in float32 and cast to the parameter's dtype.

Parameters, gradients and state are dicts keyed by parameter name (the
state's layout ``{"step", "mv": {name: {"m", "v"}}}`` mirrors the params,
as ``repro``'s mirrors its tree). ``update`` works **in place**: the moments
and the parameters are overwritten with the same elementwise operations
``repro`` computes, so no second copy of either is held (at minitron-8b's
width the moments alone are 16 GB); it returns the same dicts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable    # params -> state
    # (grads, state, params, lr, shards=None) -> (params, state); shards:
    # the loop's map of which leaves are split over ranks (TrainLoop._shards)
    update: Callable


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01,
          moment_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params: Dict[str, Tensor]):
        dev = next(iter(params.values())).device if params else None
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "mv": {k: {"m": torch.zeros(p.shape, dtype=moment_dtype,
                                            device=p.device),
                           "v": torch.zeros(p.shape, dtype=moment_dtype,
                                            device=p.device)}
                       for k, p in params.items()}}

    @torch.no_grad()
    def update(grads: Dict[str, Tensor], state, params: Dict[str, Tensor], lr,
               shards=None):
        # elementwise: a shard's update is its part of the whole leaf's,
        # so ``shards`` changes nothing
        state["step"] += 1
        stepf = state["step"].to(torch.float32)
        c1 = 1.0 - b1 ** stepf
        c2 = 1.0 - b2 ** stepf
        for k, p in params.items():
            g32 = grads[k].to(moment_dtype)
            m, v = state["mv"][k]["m"], state["mv"][k]["v"]
            m.mul_(b1).add_(g32 * (1 - b1))
            v.mul_(b2).add_(torch.square(g32) * (1 - b2))
            del g32
            upd = (m / c1).div_(torch.sqrt(v / c2).add_(eps))
            p32 = p.to(torch.float32)
            upd = upd.to(torch.float32).add_(p32 * weight_decay).mul_(lr)
            p.copy_(p32.sub_(upd))
        return params, state

    return Optimizer(init, update)
