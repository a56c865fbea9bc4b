"""Parameters from ``repro``'s layout into the port's modules.

``repro.models.lm.init_params`` returns a pytree: ``{"embed": {"emb",
"ln_f"}, "unit": [per in-unit position u: that layer's dict stacked over
unit repeats], "tail": [layer dicts]}``. :func:`lm_params_from_jax` takes
that tree with numpy arrays at its leaves (``jax.tree.map(np.asarray,
params)``; this module imports neither ``jax`` nor ``repro``) and builds the
:class:`~repro_torch.models.lm.LM` that holds the same numbers: repeat ``r``
of position ``u`` becomes layer ``r * unit_period + u``, then the tail
follows. Dtypes are kept (numpy's ``bfloat16`` from ``ml_dtypes`` is read
bit for bit).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import common as cm
from repro_torch.models import lm


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: jax's arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes: same bits as torch.bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _dense(d: Dict[str, Any], device, r=None) -> cm.Dense:
    pick = (lambda a: a) if r is None else (lambda a: a[r])
    b = d.get("b")
    return cm.Dense(_tensor(pick(d["w"]), device),
                    None if b is None else _tensor(pick(b), device))


def _layer(p: Dict[str, Any], window: int, device, r=None) -> lm.Layer:
    pick = (lambda a: a) if r is None else (lambda a: a[r])
    a, f = p["attn"], p["ffn"]
    attn = cm.Attn(*(_dense(a[k], device, r) for k in ("wq", "wk", "wv", "wo")),
                   ln=_tensor(pick(a["ln"]), device))
    ffn = cm.FFN(*(_dense(f[k], device, r) for k in ("wi", "wg", "wo")),
                 ln=_tensor(pick(f["ln"]), device))
    return lm.Layer(attn, ffn, window)


def lm_params_from_jax(cfg: cm.ModelConfig, tree: Dict[str, Any],
                       device="cpu") -> lm.LM:
    """``repro``'s ``lm.init_params(cfg, key)`` tree, as numpy arrays, → the
    port's :class:`~repro_torch.models.lm.LM` on ``device``."""
    plan = lm.layer_plan(cfg)
    period = lm.unit_period(cfg)
    n_units = cfg.n_layers // period
    if len(tree["unit"]) != (period if n_units else 0) or \
            len(tree["tail"]) != cfg.n_layers - n_units * period:
        raise ValueError(f"{cfg.name}: the tree's unit/tail layout does not "
                         f"match {cfg.n_layers} layers in units of {period}")
    layers = [None] * cfg.n_layers
    for u, stacked in enumerate(tree["unit"]):
        for r in range(n_units):
            i = r * period + u
            layers[i] = _layer(stacked, plan[i]["window"], device, r)
    for t, p in enumerate(tree["tail"]):
        i = n_units * period + t
        layers[i] = _layer(p, plan[i]["window"], device)
    e = tree["embed"]
    return lm.LM(cm.Embed(_tensor(e["emb"], device), _tensor(e["ln_f"], device)),
                 layers)
