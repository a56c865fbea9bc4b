"""Architecture registry: config → init / loss / prefill / decode builders.

Counterpart of ``repro.models.registry``: every registered architecture
(:mod:`repro_torch.configs`) resolves here by name, and :func:`build_bundle`
binds a config to its family's model functions (``lm`` and ``vlm`` through
:mod:`~repro_torch.models.lm`, ``encdec`` through
:mod:`~repro_torch.models.encdec`, ``xlstm`` and ``zamba`` through
:mod:`~repro_torch.models.xlstm` and :mod:`~repro_torch.models.zamba`) and
its substrate plan. The dry-run's ``SHAPES`` / ``input_specs`` /
``decode_state_specs`` / ``param_specs`` (ROADMAP.md queue 1 item 12) are
not ported.
``bundle.layout`` maps the parameters' names to ``repro``'s tree, the
layout checkpoints and plan bundles store.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.models import common as cm
from repro_torch.models import convert, encdec, lm, xlstm, zamba
from repro_torch.nn import substrate as psub


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: cm.ModelConfig
    init_params: Callable        # (generator, device=None) -> params
    loss_fn: Callable            # (params, batch) -> scalar
    prefill: Callable            # (params, batch) -> logits
    decode_step: Callable        # (params, state, batch) -> (logits, state)
    init_decode_state: Callable  # (batch, max_len, device=None) -> state
    # the config's SubstratePlan + its default-rule substrate, both resolved
    # once at build time
    substrate: Any = None
    plan: Any = None
    layout: Any = None           # convert.TreeLayout of the params


def _lm_bundle(cfg: cm.ModelConfig) -> ModelBundle:
    """lm and vlm: the vlm's prefill takes ``batch["patch_embeds"]``."""
    return ModelBundle(
        cfg=cfg,
        init_params=lambda gen, device=None: lm.init_params(cfg, gen, device),
        loss_fn=lambda p, b: lm.loss_fn(cfg, p, b),
        prefill=lambda p, b: lm.prefill(cfg, p, b["tokens"],
                                        b.get("patch_embeds")),
        decode_step=lambda p, s, b: lm.decode_step(cfg, p, s, b["token"],
                                                   b["cache_len"]),
        init_decode_state=lambda batch, max_len, device=None:
            lm.init_kv_caches(cfg, batch, max_len, device),
        layout=convert.lm_layout(cfg),
    )


def _encdec_bundle(cfg: cm.ModelConfig) -> ModelBundle:
    def init_state(batch, max_len, device=None):
        """The self-attention caches and ``enc_out`` zeros (B, n_frames, d),
        as ``repro``'s bundle makes them."""
        st = encdec.init_kv_caches(cfg, batch, max_len, device)
        st["enc_out"] = torch.zeros((batch, cfg.n_frames, cfg.d_model),
                                    dtype=cfg.dtype, device=device)
        return st

    return ModelBundle(
        cfg=cfg,
        init_params=lambda gen, device=None: encdec.init_params(cfg, gen, device),
        loss_fn=lambda p, b: encdec.loss_fn(cfg, p, b),
        prefill=lambda p, b: encdec.prefill(cfg, p, b["tokens"], b["frames"]),
        decode_step=lambda p, s, b: encdec.decode_step(cfg, p, s, b["token"],
                                                       b["cache_len"]),
        init_decode_state=init_state,
        layout=convert.encdec_layout(cfg),
    )


def _xlstm_bundle(cfg: cm.ModelConfig) -> ModelBundle:
    """xlstm: the decode state is per-layer recurrent state; ``max_len`` is
    ignored, as in ``repro``."""
    return ModelBundle(
        cfg=cfg,
        init_params=lambda gen, device=None: xlstm.init_params(cfg, gen, device),
        loss_fn=lambda p, b: xlstm.loss_fn(cfg, p, b),
        prefill=lambda p, b: xlstm.prefill(cfg, p, b["tokens"]),
        decode_step=lambda p, s, b: xlstm.decode_step(cfg, p, s, b["token"],
                                                      b["cache_len"]),
        init_decode_state=lambda batch, max_len, device=None:
            xlstm.init_decode_state(cfg, batch, device),
        layout=convert.xlstm_layout(cfg),
    )


def _zamba_bundle(cfg: cm.ModelConfig) -> ModelBundle:
    return ModelBundle(
        cfg=cfg,
        init_params=lambda gen, device=None: zamba.init_params(cfg, gen, device),
        loss_fn=lambda p, b: zamba.loss_fn(cfg, p, b),
        prefill=lambda p, b: zamba.prefill(cfg, p, b["tokens"]),
        decode_step=lambda p, s, b: zamba.decode_step(cfg, p, s, b["token"],
                                                      b["cache_len"]),
        init_decode_state=lambda batch, max_len, device=None:
            zamba.init_decode_state(cfg, batch, max_len, device),
        layout=convert.zamba_layout(cfg),
    )


def _with_substrate(builder: Callable) -> Callable:
    """Wrap a family builder so the config's substrate plan resolves exactly
    once at bundle build (``get_substrate`` is lru-cached, so layers
    re-resolving by spec string hit the same instances). ``bundle.substrate``
    is the plan's *default* substrate — per-site overrides resolve inside
    :func:`repro_torch.models.common.dense` via the plan itself
    (``bundle.plan``)."""

    def build(cfg: cm.ModelConfig) -> ModelBundle:
        bundle = builder(cfg)
        plan = cm.substrate_plan(cfg)
        return dataclasses.replace(
            bundle, substrate=psub.get_substrate(plan.default), plan=plan)

    return build


_BUILDERS = {
    "lm": _with_substrate(_lm_bundle),
    "vlm": _with_substrate(_lm_bundle),
    "encdec": _with_substrate(_encdec_bundle),
    "xlstm": _with_substrate(_xlstm_bundle),
    "zamba": _with_substrate(_zamba_bundle),
}


def build_bundle(cfg: cm.ModelConfig) -> ModelBundle:
    """Build a bundle from an explicit config (registered or reduced)."""
    builder = _BUILDERS.get(cfg.family)
    if builder is None:
        raise KeyError(f"unknown model family {cfg.family!r}; known: "
                       f"{', '.join(sorted(_BUILDERS))}")
    return builder(cfg)


_REGISTRY: Dict[str, cm.ModelConfig] = {}


def register(cfg: cm.ModelConfig) -> cm.ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str, **overrides) -> cm.ModelConfig:
    _ensure_loaded()
    cfg = _REGISTRY[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_bundle(name: str, **overrides) -> ModelBundle:
    return build_bundle(get_config(name, **overrides))


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401  (registers all archs)
