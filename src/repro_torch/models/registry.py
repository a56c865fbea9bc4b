"""Architecture registry: config → init / prefill / decode builders.

Counterpart of ``repro.models.registry`` for the ``lm`` family: every
registered architecture (:mod:`repro_torch.configs`) resolves here by name,
and :func:`build_bundle` binds a config to the model functions and its
substrate plan. Other families (vlm, xlstm, zamba, encdec) raise until their
slices are ported (ROADMAP.md queue 1 item 7); the loss (with training,
item 9) and the dry-run's ``SHAPES`` / ``input_specs`` /
``decode_state_specs`` / ``param_specs`` (item 12) are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.nn import substrate as psub


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: cm.ModelConfig
    init_params: Callable        # (generator, device=None) -> params
    prefill: Callable            # (params, batch) -> logits
    decode_step: Callable        # (params, state, batch) -> (logits, state)
    init_decode_state: Callable  # (batch, max_len, device=None) -> state
    # the config's SubstratePlan + its default-rule substrate, both resolved
    # once at build time
    substrate: Any = None
    plan: Any = None


def _lm_bundle(cfg: cm.ModelConfig) -> ModelBundle:
    return ModelBundle(
        cfg=cfg,
        init_params=lambda gen, device=None: lm.init_params(cfg, gen, device),
        prefill=lambda p, b: lm.prefill(cfg, p, b["tokens"]),
        decode_step=lambda p, s, b: lm.decode_step(cfg, p, s, b["token"],
                                                   b["cache_len"]),
        init_decode_state=lambda batch, max_len, device=None:
            lm.init_kv_caches(cfg, batch, max_len, device),
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
}


def build_bundle(cfg: cm.ModelConfig) -> ModelBundle:
    """Build a bundle from an explicit config (registered or reduced)."""
    builder = _BUILDERS.get(cfg.family)
    if builder is None:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP.md, "
            "queue 1 item 7); ported: lm")
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
