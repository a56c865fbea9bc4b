"""Adafactor: factored second moments, no momentum.

Counterpart of ``repro.optim.adafactor``, with its update rule. State per
leaf of two or more dimensions ``{"vr": shape[:-1], "vc": shape[:-2] +
shape[-1:]}``, else a full ``{"v": shape}``; the statistics in float32, the
update in the gradient's dtype, clipped to an RMS of ``clip_threshold``
over the leaf, the new parameter computed in float32.

A leaf is ``repro``'s. Without a ``layout`` the state is keyed by parameter
name and each parameter is a leaf, as in a flat dict of tensors. With one
(:class:`repro_torch.models.convert.TreeLayout`, a bundle's ``layout``),
the rule acts on ``repro``'s tree: the per-layer parameters that
``repro`` stacks over unit repeats (``layout.groups``) form one leaf, whose
state is keyed by its tree path. That is ``repro``'s rule on its tree, not
the per-tensor one:

* a norm scale or bias, one-dimensional per layer, is a stacked
  ``(n_units, d)`` leaf: factored, its column statistic ``vc`` (d,) shared
  by the stacked layers;
* the RMS clip spans every stacked layer.

A stacked leaf of two or more dimensions per layer is factored per layer
in ``repro`` too (its row and column means stay within a layer), so its
parts are updated one layer at a time with views of the stacked state,
and only the clip's mean square is summed across them. Tail layers and
unstacked leaves (``emb``, ``ln_f``) keep the per-tensor rule, which is
``repro``'s for them. ``repro``'s launcher trains the MoE configs with this
optimizer (``adafactor(bundle.layout)`` in ``launch/train.py``).

Dicts updated in place, as :mod:`repro_torch.optim.adamw`.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.optim.adamw import Optimizer

Tensor = torch.Tensor


def adafactor(layout=None, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    def groups(params: Dict[str, Tensor]):
        """{state key: (parameter names in stack order, stacked)}."""
        if layout is None:
            return {k: ([k], False) for k in params}
        return layout.groups(params)

    def init(params: Dict[str, Tensor]):
        def leaf(p, n_stacked):
            shape = (n_stacked,) + tuple(p.shape) if n_stacked else tuple(p.shape)
            f32 = dict(dtype=torch.float32, device=p.device)
            if len(shape) >= 2:
                return {"vr": torch.zeros(shape[:-1], **f32),
                        "vc": torch.zeros(shape[:-2] + shape[-1:], **f32)}
            return {"v": torch.zeros(shape, **f32)}
        dev = next(iter(params.values())).device if params else None
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "mv": {key: leaf(params[names[0]], len(names) if stacked else 0)
                       for key, (names, stacked) in groups(params).items()}}

    def scaled(g: Tensor, mv: Dict[str, Tensor], beta: Tensor) -> Tensor:
        """The unclipped update of one leaf (or one layer of a stacked one,
        ``mv`` then views of its statistics), its statistics updated."""
        sq = torch.square(g.to(torch.float32))
        if g.dim() >= 2:
            vr = beta * mv["vr"] + (1 - beta) * (sq.mean(dim=-1) + eps)
            vc = beta * mv["vc"] + (1 - beta) * (sq.mean(dim=-2) + eps)
            denom = vr[..., None] * vc[..., None, :] / torch.clamp_min(
                vr.mean(dim=-1)[..., None, None], eps)
            mv["vr"].copy_(vr)
            mv["vc"].copy_(vc)
            return g * torch.rsqrt(denom + eps).to(g.dtype)
        v = beta * mv["v"] + (1 - beta) * (sq + eps)
        mv["v"].copy_(v)
        return g * torch.rsqrt(v + eps).to(g.dtype)

    def stepped(p: Tensor, upd: Tensor, lr, clip) -> Tensor:
        return (p.to(torch.float32) - lr * clip * upd.to(torch.float32)).to(p.dtype)

    @torch.no_grad()
    def update(grads: Dict[str, Tensor], state, params: Dict[str, Tensor], lr):
        state["step"] += 1
        beta = 1.0 - (state["step"].to(torch.float32) + 1.0) ** (-decay)
        for key, (names, stacked) in groups(params).items():
            mv = state["mv"][key]
            gs = [grads[n] for n in names]
            vector = stacked and gs[0].dim() == 1
            if vector:      # (n_units, d): factored as one, vc shared
                upds = [scaled(torch.stack(gs), mv, beta)]
            elif stacked:   # factored layer by layer, on views of the stack
                upds = [scaled(g, {s: t[r] for s, t in mv.items()}, beta)
                        for r, g in enumerate(gs)]
            else:
                upds = [scaled(gs[0], mv, beta)]
            if len(upds) == 1:
                ms = torch.mean(torch.square(upds[0].to(torch.float32)))
            else:           # the mean square of the stack, from its layers'
                ms = torch.stack([torch.sum(torch.square(u.to(torch.float32)))
                                  for u in upds]).sum() / sum(u.numel() for u in upds)
            rms = torch.sqrt(ms + eps)
            clip = 1.0 / torch.clamp_min(rms / clip_threshold, 1.0)
            if vector:
                new = stepped(torch.stack([params[n] for n in names]), upds[0],
                              lr, clip)
                for r, n in enumerate(names):
                    params[n].copy_(new[r])
            else:
                for n, u in zip(names, upds):
                    params[n].copy_(stepped(params[n], u, lr, clip))
        return params, state

    return Optimizer(init, update)
