"""Decoder-only LM family (the dense configs).

Counterpart of ``repro.models.lm`` for minitron, internlm2, qwen1.5 (QKV
bias) and gemma3 (5:1 local:global attention). The parameters are an
:class:`LM` module: the embedding and one :class:`Layer` per layer in an
``nn.ModuleList``, run by a Python layer loop in place of ``repro``'s
``lax.scan`` over stacked unit params. Layer ``i`` runs under
``site_scope(f"layer.{i}")``, so a per-site plan resolves per layer, which
``repro`` reaches through ``scan_site_scope`` and ``lax.switch``.

KV caches are a list of per-layer ``(K, V)`` tensors ``(B, S_max, Hkv,
dh)`` on the model's device, written in place by :func:`decode_step`.

MoE layers, the vlm patch projection and the loss are not ported
(ROADMAP.md queue 1 items 7 and 9): a config with ``n_experts > 0`` raises
at construction.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from repro_torch.models import common as cm
from repro_torch.nn import plan as splan

Tensor = torch.Tensor
Caches = List[Tuple[Tensor, Tensor]]


def layer_plan(cfg: cm.ModelConfig) -> List[Dict]:
    """Per-layer block descriptors: {'window': int}."""
    plan = []
    for i in range(cfg.n_layers):
        window = 0
        if cfg.local_global_ratio > 0:
            # pattern: R local layers then 1 global
            window = cfg.local_window if (i % (cfg.local_global_ratio + 1)
                                          != cfg.local_global_ratio) else 0
        plan.append({"window": window})
    return plan


def unit_period(cfg: cm.ModelConfig) -> int:
    """Layers per repeating unit in ``repro``'s stacked params: the
    local:global pattern's period (``repro`` also folds in the MoE
    interleave, which no config of the port has)."""
    return cfg.local_global_ratio + 1 if cfg.local_global_ratio else 1


class Layer(nn.Module):
    """One decoder layer: attention then FFN; ``window`` > 0 makes the
    attention local."""

    def __init__(self, attn: cm.Attn, ffn: cm.FFN, window: int = 0):
        super().__init__()
        self.attn = attn
        self.ffn = ffn
        self.window = window


class LM(nn.Module):
    """Embedding (shared with the LM head) and the decoder layers."""

    def __init__(self, embed: cm.Embed, layers: List[Layer]):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)

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
    layers = [Layer(cm.init_attn(generator, cfg, device),
                    cm.init_ffn(generator, cfg, device), d["window"])
              for d in plan]
    return LM(embed, layers)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _apply_layer(cfg, layer: Layer, x, positions, kv_cache=None,
                 cache_len=None):
    x, cache = cm.attn_block(cfg, layer.attn, x, positions=positions,
                             window=layer.window, kv_cache=kv_cache,
                             cache_len=cache_len)
    return cm.ffn_block(cfg, layer.ffn, x), cache


def _check(cfg: cm.ModelConfig, params: LM) -> None:
    if len(params.layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: params hold {len(params.layers)} "
                         f"layers, the config {cfg.n_layers}")


def forward(cfg: cm.ModelConfig, params: LM, tokens: Tensor) -> Tensor:
    """Full-sequence forward: tokens (B, S) → final hidden states (B, S, d)."""
    _check(cfg, params)
    x = cm.embed(cfg, params.embed, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for i, layer in enumerate(params.layers):
        with splan.site_scope(f"layer.{i}"):
            x, _ = _apply_layer(cfg, layer, x, positions)
    return x


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


def prefill(cfg: cm.ModelConfig, params: LM, tokens: Tensor) -> Tensor:
    """Prefill forward: returns last-position logits (B, 1, V) (the serving
    engine prefills token by token through :func:`decode_step` instead)."""
    x = forward(cfg, params, tokens)
    return cm.lm_logits(cfg, params.embed, x[:, -1:, :])
