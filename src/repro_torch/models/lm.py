"""Decoder-only LM family.

Counterpart of ``repro.models.lm`` for llama4-maverick (MoE top-1 every
second layer, a shared expert), kimi-k2 (MoE top-8 in every layer, a shared
expert), internlm2, qwen1.5 (QKV bias), gemma3 (5:1 local:global
attention), minitron, and the paligemma VLM backbone (a prefix of projected
patch embeddings, site ``patch_proj``). The parameters are an :class:`LM`
module: the embedding, one :class:`Layer` per layer in an
``nn.ModuleList`` (its FFN an :class:`~repro_torch.models.common.FFN` or an
:class:`~repro_torch.models.common.MoE`) and the vlm's ``patch_proj``, run
by a Python layer loop in place of ``repro``'s ``lax.scan`` over stacked
unit params. Layer ``i`` runs under ``site_scope(f"layer.{i}")``, so a
per-site plan resolves per layer, which ``repro`` reaches through
``scan_site_scope`` and ``lax.switch``.

KV caches are a list of per-layer ``(K, V)`` tensors ``(B, S_max, Hkv,
dh)`` on the model's device, written in place by :func:`decode_step`.

:func:`loss_fn` is the training loss. Under ``cfg.remat`` (and only while
autograd records) each layer is a ``torch.utils.checkpoint`` region that
the backward recomputes, as ``repro``'s ``jax.checkpoint`` per layer: the
recompute runs the layer's contractions again, so a training step launches
each dense kernel twice.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as cm
from repro_torch.nn import plan as splan
from repro_torch.nn import substrate as psub

Tensor = torch.Tensor
Caches = List[Tuple[Tensor, Tensor]]


def layer_plan(cfg: cm.ModelConfig) -> List[Dict]:
    """Per-layer block descriptors: {'moe': bool, 'window': int}."""
    plan = []
    for i in range(cfg.n_layers):
        moe = cfg.n_experts > 0 and (i % cfg.moe_interleave
                                     == cfg.moe_interleave - 1)
        window = 0
        if cfg.local_global_ratio > 0:
            # pattern: R local layers then 1 global
            window = cfg.local_window if (i % (cfg.local_global_ratio + 1)
                                          != cfg.local_global_ratio) else 0
        plan.append({"moe": moe, "window": window})
    return plan


def unit_period(cfg: cm.ModelConfig) -> int:
    """Layers per repeating unit in ``repro``'s stacked params: the lcm of
    the MoE interleave and the local:global pattern's period."""
    p = max(1, cfg.moe_interleave) if cfg.n_experts else 1
    if cfg.local_global_ratio:
        p = math.lcm(p, cfg.local_global_ratio + 1)
    return p


class Layer(nn.Module):
    """One decoder layer: attention, then a dense FFN (``ffn``) or an MoE
    (``moe``), the other None; ``window`` > 0 makes the attention local."""

    def __init__(self, attn: cm.Attn, ffn: Optional[cm.FFN] = None,
                 window: int = 0, *, moe: Optional[cm.MoE] = None):
        super().__init__()
        if (ffn is None) == (moe is None):
            raise ValueError("a layer holds exactly one of ffn and moe")
        self.attn = attn
        self.ffn = ffn
        self.moe = moe
        self.window = window


class LM(nn.Module):
    """Embedding (shared with the LM head), the decoder layers and, for the
    vlm, the patch embeddings' projection ``patch_proj``."""

    def __init__(self, embed: cm.Embed, layers: List[Layer],
                 patch_proj: Optional[cm.Dense] = None):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.patch_proj = patch_proj

    @property
    def device(self) -> torch.device:
        return self.embed.emb.device


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: cm.ModelConfig, generator: torch.Generator,
                device=None) -> LM:
    """Random parameters drawn from ``generator`` on ``device`` (the
    generator's own device when None), as ``repro`` draws them: normal
    weights over sqrt(d_in), unit norm scales, zero biases."""
    device = torch.device(device if device is not None else generator.device)
    plan = layer_plan(cfg)
    embed = cm.init_embed(generator, cfg, device)
    layers = []
    for d in plan:
        attn = cm.init_attn(generator, cfg, device)
        if d["moe"]:
            layers.append(Layer(attn, window=d["window"],
                                moe=cm.init_moe(generator, cfg, device)))
        else:
            layers.append(Layer(attn, cm.init_ffn(generator, cfg, device),
                                d["window"]))
    patch_proj = (cm.init_dense(generator, cfg.d_model, cfg.d_model, cfg.dtype,
                                device=device) if cfg.family == "vlm" else None)
    return LM(embed, layers, patch_proj)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _apply_layer(cfg, layer: Layer, x, positions, kv_cache=None,
                 cache_len=None):
    x, cache = cm.attn_block(cfg, layer.attn, x, positions=positions,
                             window=layer.window, kv_cache=kv_cache,
                             cache_len=cache_len)
    if layer.moe is not None:
        return cm.moe_block(cfg, layer.moe, x), cache
    return cm.ffn_block(cfg, layer.ffn, x), cache


def _check(cfg: cm.ModelConfig, params: LM) -> None:
    if len(params.layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: params hold {len(params.layers)} "
                         f"layers, the config {cfg.n_layers}")


def _maybe_remat(cfg: cm.ModelConfig, fn):
    """``fn`` as a checkpointed region under ``cfg.remat`` while autograd
    records, else ``fn`` itself.

    The layer reads thread-local ambients: the site stack, the plan
    override and the contraction override (QAT's STE). On the card,
    autograd runs the backward, and so the recompute, on its own device
    thread, where none of them is set; they are captured here and entered
    again around every run of ``fn``, so the recompute contracts on the
    same substrates as the forward did.
    """
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    sites = splan.current_site_stack()
    plan = splan.current_plan_override()
    override = psub.current_dot_override()

    def replay(*args):
        with splan.site_stack_scope(sites), splan.plan_override_scope(plan), \
                psub.dot_override_scope(override):
            return fn(*args)

    return lambda *args: checkpoint(replay, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def forward(cfg: cm.ModelConfig, params: LM, tokens: Tensor,
            patch_embeds: Optional[Tensor] = None) -> Tensor:
    """Full-sequence forward: tokens (B, S) → final hidden states (B, S, d);
    for the vlm, ``patch_embeds`` (B, P, d) projected at the top-level site
    ``patch_proj`` come first (B, P + S, d)."""
    _check(cfg, params)
    x = cm.embed(cfg, params.embed, tokens)
    if cfg.family == "vlm" and patch_embeds is not None:
        pe = cm.dense(cfg, patch_embeds.to(x.dtype), params.patch_proj.w,
                      site="patch_proj")
        x = torch.cat([pe, x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for i, layer in enumerate(params.layers):
        with splan.site_scope(f"layer.{i}"):
            x = _maybe_remat(cfg, lambda xx, layer=layer: _apply_layer(
                cfg, layer, xx, positions)[0])(x)
    return x


def loss_fn(cfg: cm.ModelConfig, params: LM, batch: Dict[str, Tensor]) -> Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S) against
    ``batch["labels"]`` (B, S): a float32 scalar. The vlm's
    ``batch["patch_embeds"]`` prefix is scored on the text positions only."""
    x = forward(cfg, params, batch["tokens"], batch.get("patch_embeds"))
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = x[:, batch["patch_embeds"].shape[1]:]
    return cm.lm_loss_chunked(cfg, params.embed, x, batch["labels"])


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with KV caches
# ---------------------------------------------------------------------------


def init_kv_caches(cfg: cm.ModelConfig, batch: int, max_len: int,
                   device=None) -> Caches:
    """Zeroed per-layer (K, V) caches, each (batch, max_len, Hkv, dh)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.dh)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=device),
             torch.zeros(shape, dtype=cfg.dtype, device=device))
            for _ in range(cfg.n_layers)]


def decode_step(cfg: cm.ModelConfig, params: LM, caches: Caches,
                token: Tensor, cache_len: int) -> Tuple[Tensor, Caches]:
    """One decode step: token (B, 1) → logits (B, 1, V) float32; the new
    keys and values are written into ``caches`` at ``cache_len`` (in place)
    and the same list is returned."""
    _check(cfg, params)
    x = cm.embed(cfg, params.embed, token)
    b = x.shape[0]
    positions = torch.full((b, 1), int(cache_len), dtype=torch.int64,
                           device=x.device)
    for i, layer in enumerate(params.layers):
        with splan.site_scope(f"layer.{i}"):
            x, _ = _apply_layer(cfg, layer, x, positions, kv_cache=caches[i],
                                cache_len=cache_len)
    return cm.lm_logits(cfg, params.embed, x), caches


def prefill(cfg: cm.ModelConfig, params: LM, tokens: Tensor,
            patch_embeds: Optional[Tensor] = None) -> Tensor:
    """Prefill forward: returns last-position logits (B, 1, V) (the serving
    engine prefills token by token through :func:`decode_step` instead)."""
    x = forward(cfg, params, tokens, patch_embeds)
    return cm.lm_logits(cfg, params.embed, x[:, -1:, :])
