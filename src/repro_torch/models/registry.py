"""Architecture registry: config → init / loss / prefill / decode builders.

Counterpart of ``repro.models.registry``: every registered architecture
(:mod:`repro_torch.configs`) resolves here by name, and :func:`build_bundle`
binds a config to its family's model functions (``lm`` and ``vlm`` through
:mod:`~repro_torch.models.lm`, ``encdec`` through
:mod:`~repro_torch.models.encdec`, ``xlstm`` and ``zamba`` through
:mod:`~repro_torch.models.xlstm` and :mod:`~repro_torch.models.zamba`) and
its substrate plan. ``bundle.layout`` maps the parameters' names to
``repro``'s tree, the layout checkpoints and plan bundles store.

For the dry run (:mod:`repro_torch.launch.dryrun`): the cells' shapes
(:data:`SHAPES`, :data:`SUBQUADRATIC`) and ``meta`` stand-ins for every
input (:func:`input_specs`), the decode state (:func:`decode_state_specs`)
and the parameters (:func:`param_specs`: the model built on ``meta``),
which ``repro`` makes with ``jax.eval_shape`` and ``ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.models import common as cm
from repro_torch.models import convert, encdec, lm, xlstm, zamba
from repro_torch.nn import substrate as psub


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# archs allowed to run long_500k (sub-quadratic)
SUBQUADRATIC = {"xlstm-125m", "zamba2-1.2b"}


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


# ---------------------------------------------------------------------------
# input specs (meta stand-ins, dry-run pattern)
# ---------------------------------------------------------------------------

_META = torch.device("meta")


def input_specs(cfg: cm.ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """``meta`` tensors for every model input of this (arch, shape) cell.
    The decode's ``cache_len`` is a 0-d int32 as ``repro``'s; the port's
    decode takes a host integer in its place."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device=_META)

    if shape.kind == "train":
        batch = {"tokens": sds((b, s), i32), "labels": sds((b, s), i32)}
        if cfg.family == "vlm":
            batch["patch_embeds"] = sds((b, cfg.n_patches, cfg.d_model), cfg.dtype)
        if cfg.family == "encdec":
            batch["frames"] = sds((b, cfg.n_frames, cfg.d_model), cfg.dtype)
        return batch
    if shape.kind == "prefill":
        batch = {"tokens": sds((b, s), i32)}
        if cfg.family == "vlm":
            batch["patch_embeds"] = sds((b, cfg.n_patches, cfg.d_model), cfg.dtype)
        if cfg.family == "encdec":
            batch["frames"] = sds((b, cfg.n_frames, cfg.d_model), cfg.dtype)
        return batch
    # decode: one new token against a cache of length seq_len
    return {"token": sds((b, 1), i32), "cache_len": sds((), i32)}


def decode_state_specs(bundle: ModelBundle, shape: ShapeSpec):
    """The decode state (KV caches / SSM states) on ``meta``: the port's
    per-layer tensors, which ``repro`` stacks where
    :func:`decode_state_stacks` says."""
    return bundle.init_decode_state(shape.global_batch, shape.seq_len,
                                    device=_META)


def decode_state_stacks(cfg: cm.ModelConfig, state):
    """A tree like ``state`` giving, per leaf, the number of layers
    ``repro``'s decode state stacks it with (None: a leaf of its own):
    the lm's caches of whole units are stacked per unit position
    (``lm.unit_period``), the encdec's self-attention caches over all
    layers."""
    def kv(n):
        return (n, n)

    if cfg.family in ("lm", "vlm"):
        period = lm.unit_period(cfg)
        n_units = cfg.n_layers // period
        return [kv(n_units if i < n_units * period else None)
                for i in range(len(state))]
    if cfg.family == "encdec":
        return {k: ([kv(cfg.n_layers)] * len(v) if k == "self_kv" else None)
                for k, v in state.items()}
    def none(x):
        if isinstance(x, dict):
            return {k: none(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(none(v) for v in x)
        return None
    return none(state)


def param_specs(bundle: ModelBundle):
    """The parameters on ``meta``: the model's modules with shapes and
    dtypes, no allocation."""
    return bundle.init_params(torch.Generator(), device=_META)
