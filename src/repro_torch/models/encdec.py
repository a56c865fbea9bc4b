"""Whisper-style encoder-decoder (arXiv:2212.04356).

Counterpart of ``repro.models.encdec``. The conv audio frontend is a stub,
as in ``repro``: the encoder takes precomputed frame embeddings (B,
n_frames, d), the output of the two-conv downsampling stack. The
transformer backbone is real: a non-causal encoder and a causal decoder
with self-attention, cross-attention and FFN per layer.

The parameters are an :class:`EncDec` module: the embedding, the encoder
layers ``enc`` and the decoder layers ``dec`` (``nn.ModuleList``s), run by
Python layer loops in place of ``repro``'s ``lax.scan`` over stacked
layers. Encoder layer ``i`` runs under ``site_scope(f"enc.{i}")``
(``enc.<i>.attn.w*``, ``enc.<i>.ffn.w*``), decoder layer ``i`` under
``site_scope(f"dec.{i}")`` with ``self`` / ``cross`` below it
(``dec.<i>.self.attn.w*``; the cross K/V projections at
``dec.<i>.cross.w{k,v}``, the cross query and output at
``dec.<i>.cross.attn.w{q,o}``; ``dec.<i>.ffn.w*``).

The decode state is ``{"self_kv": per-layer (K, V) list, "enc_out": (B,
n_frames, d)}``; the caches are written in place. Cross K/V are computed
again from ``enc_out`` at every decode step, as ``repro`` does: two
contractions of B · n_frames rows per layer-step.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.nn import plan as splan

Tensor = torch.Tensor


class EncLayer(nn.Module):
    """One encoder layer: non-causal attention then FFN."""

    def __init__(self, attn: cm.Attn, ffn: cm.FFN):
        super().__init__()
        self.attn = attn
        self.ffn = ffn


class DecLayer(nn.Module):
    """One decoder layer: causal self-attention (``self``, ``repro``'s key),
    cross-attention (``cross``) and FFN."""

    def __init__(self, self_attn: cm.Attn, cross: cm.Attn, ffn: cm.FFN):
        super().__init__()
        self.add_module("self", self_attn)
        self.cross = cross
        self.ffn = ffn


class EncDec(nn.Module):
    """Embedding (shared with the LM head), encoder and decoder layers."""

    def __init__(self, embed: cm.Embed, enc: List[EncLayer],
                 dec: List[DecLayer]):
        super().__init__()
        self.embed = embed
        self.enc = nn.ModuleList(enc)
        self.dec = nn.ModuleList(dec)

    @property
    def device(self) -> torch.device:
        return self.embed.emb.device


def init_params(cfg: cm.ModelConfig, generator: torch.Generator,
                device=None) -> EncDec:
    """Random parameters drawn from ``generator`` on ``device`` (the
    generator's own device when None), as ``repro`` draws them."""
    device = torch.device(device if device is not None else generator.device)
    ne = cfg.n_encoder_layers or cfg.n_layers
    enc = [EncLayer(cm.init_attn(generator, cfg, device),
                    cm.init_ffn(generator, cfg, device)) for _ in range(ne)]
    dec = [DecLayer(cm.init_attn(generator, cfg, device),
                    cm.init_attn(generator, cfg, device),
                    cm.init_ffn(generator, cfg, device))
           for _ in range(cfg.n_layers)]
    return EncDec(cm.init_embed(generator, cfg, device), enc, dec)


def _check(cfg: cm.ModelConfig, params: EncDec) -> None:
    if len(params.dec) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: params hold {len(params.dec)} decoder "
                         f"layers, the config {cfg.n_layers}")


def _positions(b: int, s: int, device) -> Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _enc_layer(cfg, layer: EncLayer, x, positions):
    y, _ = cm.attn_block(cfg, layer.attn, x, positions=positions, causal=False)
    return cm.ffn_block(cfg, layer.ffn, y)


def encode(cfg: cm.ModelConfig, params: EncDec, frames: Tensor) -> Tensor:
    """frames: (B, n_frames, d) stub embeddings → encoder states."""
    b, s, _ = frames.shape
    positions = _positions(b, s, frames.device)
    x = frames.to(cfg.dtype)
    for i, layer in enumerate(params.enc):
        with splan.site_scope(f"enc.{i}"):
            x = lm._maybe_remat(cfg, lambda xx, layer=layer: _enc_layer(
                cfg, layer, xx, positions))(x)
    return x


def _dec_layer(cfg, layer: DecLayer, x, positions, enc_out, kv_cache=None,
               cache_len=None):
    """One decoder layer → (output, self-attention cache)."""
    with splan.site_scope("self"):
        y, cache = cm.attn_block(cfg, getattr(layer, "self"), x,
                                 positions=positions, kv_cache=kv_cache,
                                 cache_len=cache_len)
    # cross attention: K/V from the encoder output through this layer's
    # projections
    be, se, _ = enc_out.shape
    hkv, dh = cfg.n_kv_heads, cfg.dh
    with splan.site_scope("cross"):
        ck = cm.dense(cfg, enc_out, layer.cross.wk.w,
                      site="wk").reshape(be, se, hkv, dh)
        cv = cm.dense(cfg, enc_out, layer.cross.wv.w,
                      site="wv").reshape(be, se, hkv, dh)
        y, _ = cm.attn_block(cfg, layer.cross, y, positions=positions,
                             cross_kv=(ck, cv))
    return cm.ffn_block(cfg, layer.ffn, y), cache


def decode_train(cfg: cm.ModelConfig, params: EncDec, tokens: Tensor,
                 enc_out: Tensor) -> Tensor:
    """Teacher-forced decoder over ``tokens`` (B, S) → hidden states."""
    _check(cfg, params)
    x = cm.embed(cfg, params.embed, tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    for i, layer in enumerate(params.dec):
        with splan.site_scope(f"dec.{i}"):
            x = lm._maybe_remat(cfg, lambda xx, ee, layer=layer: _dec_layer(
                cfg, layer, xx, positions, ee)[0])(x, enc_out)
    return x


def loss_fn(cfg: cm.ModelConfig, params: EncDec,
            batch: Dict[str, Tensor]) -> Tensor:
    """Mean next-token cross-entropy of the decoder over ``batch["tokens"]``
    against ``batch["labels"]``, given ``batch["frames"]``."""
    enc_out = encode(cfg, params, batch["frames"])
    x = decode_train(cfg, params, batch["tokens"], enc_out)
    return cm.lm_loss_chunked(cfg, params.embed, x, batch["labels"])


def init_kv_caches(cfg: cm.ModelConfig, batch: int, max_len: int,
                   device=None) -> Dict[str, Any]:
    """``{"self_kv": zeroed per-layer (K, V)}``, each (batch, max_len, Hkv,
    dh); the bundle adds ``enc_out``."""
    return {"self_kv": lm.init_kv_caches(cfg, batch, max_len, device)}


def decode_step(cfg: cm.ModelConfig, params: EncDec, state: Dict[str, Any],
                token: Tensor, cache_len: int) -> Tuple[Tensor, Dict[str, Any]]:
    """One decoder token (B, 1) → logits (B, 1, V) float32, cross-attending
    to ``state["enc_out"]``; the self-attention caches are written in place
    and the same state returned."""
    _check(cfg, params)
    x = cm.embed(cfg, params.embed, token)
    b = x.shape[0]
    positions = torch.full((b, 1), int(cache_len), dtype=torch.int64,
                           device=x.device)
    enc_out, caches = state["enc_out"], state["self_kv"]
    for i, layer in enumerate(params.dec):
        with splan.site_scope(f"dec.{i}"):
            x, _ = _dec_layer(cfg, layer, x, positions, enc_out,
                              kv_cache=caches[i], cache_len=cache_len)
    return cm.lm_logits(cfg, params.embed, x), state


def prefill(cfg: cm.ModelConfig, params: EncDec, tokens: Tensor,
            frames: Tensor) -> Tensor:
    """Encode ``frames``, run the decoder over ``tokens``: last-position
    logits (B, 1, V)."""
    enc_out = encode(cfg, params, frames)
    x = decode_train(cfg, params, tokens, enc_out)
    return cm.lm_logits(cfg, params.embed, x[:, -1:, :])
