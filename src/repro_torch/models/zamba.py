"""Zamba2 hybrid (arXiv:2411.15242): Mamba2 backbone + shared attention block.

Counterpart of ``repro.models.zamba``. Mamba2 runs the SSD chunked
algorithm: the quadratic form inside a chunk and the diagonal state
recurrence across chunks (state (B, H, dh, d_state), carried by a Python
loop over chunks in place of ``lax.scan``). One shared transformer block
(one set of attention and FFN weights) runs after every
``shared_attn_every``-th mamba layer, the same parameters each time.

The parameters are a :class:`Zamba` module: the embedding, one
:class:`Mamba` per layer (``mamba``, an ``nn.ModuleList``) and the
:class:`Shared` block. Mamba layer ``i`` runs under ``site_scope(f"layer.{i}",
"mamba")`` (``layer.<i>.mamba.in_proj``, ``.out_proj``); the shared block
under ``site_scope("shared")`` with no layer index (``shared.attn.w*``,
``shared.ffn.w*``), as in ``repro``, so one plan rule covers every place it
runs. The depthwise conv, the scan and the gates are float work outside the
substrate.

The decode state is ``{"mamba": per-layer (ssm state (B, H, dh, n)
float32, conv state (B, W-1, d_inner) in ``cfg.dtype``), "shared_kv":
(K, V) per place the shared block runs, each (B, S_max, Hkv, dh)}``. Each
place has tensors of its own; :func:`decode_step` writes them in place and
returns the new mamba states in a new dict.

Training differentiates :func:`loss_fn` with autograd. Under ``cfg.remat``
(and only while autograd records) each mamba layer and each run of the
shared block is a checkpointed region (``lm._maybe_remat``, ``repro``'s
``jax.checkpoint`` around both), recomputed in the backward under the
forward's site stack, plan and contraction override. The shared block's
gradient sums over the places it runs, in autograd's order. The training
forward passes no KV cache, so it never reaches the serving path's
in-place cache writes. ``repro``'s ``jax.checkpoint`` around
``mamba_scan``'s chunk body changes no value and has no counterpart here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.models import sharding as sh
from repro_torch.nn import plan as splan

Tensor = torch.Tensor


def _d_inner(cfg: cm.ModelConfig) -> int:
    return 2 * cfg.d_model


def _silu(x: Tensor) -> Tensor:
    """``jax.nn.silu``'s formula, x · sigmoid(x)."""
    return x * torch.sigmoid(x)


def _softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) (``F.softplus`` returns x itself
    past its threshold of 20, which rounds differently)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class Mamba(nn.Module):
    """A Mamba2 layer: ``ln`` (float32), ``in_proj`` (d, 2·d_inner + 2·n +
    H), the depthwise ``conv_w`` (W, d_inner) in ``cfg.dtype``, the float32
    per-head ``a_log`` (A = −exp(a_log)), ``d_skip`` and ``dt_bias``, and
    ``out_proj`` (d_inner, d)."""

    def __init__(self, ln: Tensor, in_proj: cm.Dense, conv_w: Tensor,
                 a_log: Tensor, d_skip: Tensor, dt_bias: Tensor,
                 out_proj: cm.Dense):
        super().__init__()
        self.ln = cm._frozen(ln)
        self.in_proj = in_proj
        self.conv_w = cm._frozen(conv_w)
        self.a_log = cm._frozen(a_log)
        self.d_skip = cm._frozen(d_skip)
        self.dt_bias = cm._frozen(dt_bias)
        self.out_proj = out_proj


class Shared(nn.Module):
    """The shared transformer block: ``attn`` then ``ffn``."""

    def __init__(self, attn: cm.Attn, ffn: cm.FFN):
        super().__init__()
        self.attn = attn
        self.ffn = ffn


class Zamba(nn.Module):
    """Embedding (shared with the LM head), the mamba layers and the shared
    block."""

    def __init__(self, embed: cm.Embed, mamba: List[Mamba], shared: Shared):
        super().__init__()
        self.embed = embed
        self.mamba = nn.ModuleList(mamba)
        self.shared = shared

    @property
    def device(self) -> torch.device:
        return self.embed.emb.device


def init_mamba(gen: torch.Generator, cfg: cm.ModelConfig, device=None) -> Mamba:
    d, di, h, n = cfg.d_model, _d_inner(cfg), cfg.n_heads, cfg.ssm_state
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((cfg.conv_width, di), generator=gen, **f32) \
        / math.sqrt(cfg.conv_width)
    return Mamba(torch.ones((d,), **f32),
                 cm.init_dense(gen, d, 2 * di + 2 * n + h, cfg.dtype, device=device),
                 conv_w.to(cfg.dtype), torch.zeros((h,), **f32),
                 torch.ones((h,), **f32), torch.zeros((h,), **f32),
                 cm.init_dense(gen, di, d, cfg.dtype, device=device))


def init_params(cfg: cm.ModelConfig, generator: torch.Generator,
                device=None) -> Zamba:
    """Random parameters drawn from ``generator`` on ``device`` (the
    generator's own device when None), as ``repro`` draws them."""
    device = torch.device(device if device is not None else generator.device)
    layers = [init_mamba(generator, cfg, device) for _ in range(cfg.n_layers)]
    shared = Shared(cm.init_attn(generator, cfg, device),
                    cm.init_ffn(generator, cfg, device))
    return Zamba(cm.init_embed(generator, cfg, device), layers, shared)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def _causal_conv1d(x: Tensor, w: Tensor,
                   state: Optional[Tensor] = None) -> Tuple[Tensor, Optional[Tensor]]:
    """Depthwise causal conv in ``x.dtype``. x: (B, S, C); w: (W, C); state:
    (B, W-1, C), the previous W-1 inputs. Returns (out, new state)."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1]] * w[i][None, None, :]
    new_state = xp[:, -(width - 1):] if width > 1 else None
    return out, new_state


def _outer(e: Tensor, c: Tensor) -> Tensor:
    """(B, T, H) × (B, T, n) → (B, T, H, n)."""
    return e[..., None] * c[:, :, None, :]


def mamba_scan(xh: Tensor, dt: Tensor, B: Tensor, C: Tensor, a: Tensor,
               state: Tensor, chunk: int, psum=lambda t: t,
               outer=_outer) -> Tuple[Tensor, Tensor]:
    """SSD chunked recurrence, ``repro``'s formulation (float32).

    xh: (B, S, H, dh); dt: (B, S, H) > 0; B, C: (B, S, n); a: (H,)
    negative; state: (B, H, dh, n). y_t = C_t · h_t; the D skip is added
    outside. Inside a chunk ``y_t = Σ_{u≤t} exp(lcum_t − lcum_u) dt_u (C_t ·
    B_u) x_u``, the mask applied after the product.

    The three-operand products contract in the order ``jnp.einsum`` picks
    for them at every served shape (its ``einsum_path``): ``dt · x`` first
    for ``y_intra``, ``exp(lcum) · C`` first for ``y_inter``, and
    ``wtail · B`` first for the state update; each first step is a
    broadcast product, the second a batched contraction.

    ``psum`` and ``outer`` are the scores' sum and those broadcast products
    where B and C arrive split along n (the dry run's mesh,
    :func:`repro_torch.models.sharding.state_split_ops`).
    """
    b, s, h, dh = xh.shape
    chunk = min(chunk, s)
    nc = s // chunk
    assert nc * chunk == s
    f32 = torch.float32
    xh, B, C = xh.to(f32), B.to(f32), C.to(f32)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    st = state
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xx, ddt, bb, cc = xh[:, sl], dt[:, sl], B[:, sl], C[:, sl]
        la = ddt * a[None, None, :]                           # log decay (< 0)
        lcum = torch.cumsum(la, dim=1)                        # (B, C, H)
        scores = psum(torch.einsum("btn,bun->btu", cc, bb))
        # (B, t, u, H): exp(lcum_t - lcum_u) for u <= t, 1 above the diagonal
        # (where the product is masked anyway)
        decay = torch.exp(torch.where(mask[None, :, :, None],
                                      lcum[:, :, None, :] - lcum[:, None, :, :], 0.0))
        w = torch.where(mask[None, :, :, None], scores[..., None] * decay, 0.0)
        y_intra = torch.einsum("btuh,buhd->bthd", w, ddt[..., None] * xx)
        y_inter = torch.einsum("bthn,bhdn->bthd", outer(torch.exp(lcum), cc),
                               st)
        decay_all = torch.exp(lcum[:, -1, :])                 # (B, H)
        wtail = torch.exp(lcum[:, -1:, :] - lcum) * ddt       # (B, C, H)
        st = st * decay_all[:, :, None, None] + torch.einsum(
            "buhd,buhn->bhdn", xx, outer(wtail, bb))
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), st


def mamba_block(cfg: cm.ModelConfig, p: Mamba, x: Tensor,
                state: Optional[Tensor] = None,
                conv_state: Optional[Tensor] = None) -> Tuple[Tensor, Tuple]:
    """One Mamba2 layer → (residual output, (ssm state, conv state))."""
    b, s, d = x.shape
    di, h, n = _d_inner(cfg), cfg.n_heads, cfg.ssm_state
    dh = di // h
    f32 = torch.float32
    xn = cm.rms_norm(x, p.ln)
    proj = cm.dense(cfg, xn, p.in_proj.w, site="in_proj")
    xin, z, Bm, Cm, dt_raw = sh.split(proj, [di, di, n, n, h], dim=-1)
    xin, new_conv = _causal_conv1d(xin, p.conv_w, conv_state)
    xin = _silu(xin)
    dt = _softplus(dt_raw.to(f32) + p.dt_bias)
    a = -torch.exp(p.a_log)
    xh = xin.reshape(b, s, h, dh)
    if state is None:
        state = sh.split_like(torch.zeros((b, h, dh, n), dtype=f32,
                                          device=x.device), xh,
                              (0, 2, None, None))
    # on the dry run's mesh each rank scans its heads with B and C split
    # along n over the same axis, as GSPMD partitions repro's scan
    heads, nsplit = ("batch", None, "heads", None), ("batch", None, "heads")
    ops = sh.state_split_ops("heads", xh)
    y, new_state = sh.on_shards(
        lambda *t: mamba_scan(*t, chunk=min(cfg.attn_chunk, s), **ops),
        (heads, ("batch", None, "heads"), nsplit, nsplit, ("heads",),
         ("batch", "heads", None, None)),
        [heads, ("batch", "heads", None, None)], xh, dt, Bm, Cm, a, state)
    y = y + xh.to(f32) * p.d_skip[None, None, :, None]
    y = (y.reshape(b, s, di) * _silu(z.to(f32))).to(x.dtype)
    return (x + cm.dense(cfg, y, p.out_proj.w, site="out_proj").to(x.dtype),
            (new_state, new_conv))


# ---------------------------------------------------------------------------
# model assembly
# ---------------------------------------------------------------------------


def _shared_positions(cfg: cm.ModelConfig) -> List[int]:
    """The mamba layers after which the shared block runs."""
    k = cfg.shared_attn_every
    return [i for i in range(cfg.n_layers) if k and i % k == k - 1]


def _check(cfg: cm.ModelConfig, params: Zamba) -> None:
    if len(params.mamba) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: params hold {len(params.mamba)} mamba "
                         f"layers, the config {cfg.n_layers}")


def _shared_block(cfg, p: Shared, x, positions, kv_cache=None, cache_len=None):
    with splan.site_scope("shared"):
        y, cache = cm.attn_block(cfg, p.attn, x, positions=positions,
                                 kv_cache=kv_cache, cache_len=cache_len)
        return cm.ffn_block(cfg, p.ffn, y), cache


def forward(cfg: cm.ModelConfig, params: Zamba, tokens: Tensor) -> Tensor:
    """tokens (B, S) → final hidden states (B, S, d); S a multiple of the
    chunk ``min(attn_chunk, S)``."""
    _check(cfg, params)
    x = cm.embed(cfg, params.embed, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    shared_at = set(_shared_positions(cfg))
    for i, p in enumerate(params.mamba):
        with splan.site_scope(f"layer.{i}", "mamba"):
            x = lm._maybe_remat(cfg, lambda xx, p=p: mamba_block(cfg, p, xx)[0])(x)
        if i in shared_at:
            x = lm._maybe_remat(cfg, lambda xx: _shared_block(
                cfg, params.shared, xx, positions)[0])(x)
    return x


def loss_fn(cfg: cm.ModelConfig, params: Zamba,
            batch: Dict[str, Tensor]) -> Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]``."""
    x = forward(cfg, params, batch["tokens"])
    return cm.lm_loss_chunked(cfg, params.embed, x, batch["labels"])


def init_decode_state(cfg: cm.ModelConfig, batch: int, max_len: int,
                      device=None) -> Dict[str, Any]:
    """Zeroed mamba states (float32 SSM, ``cfg.dtype`` conv) per layer and a
    zeroed (K, V) per place the shared block runs, each its own tensors."""
    di, h, n = _d_inner(cfg), cfg.n_heads, cfg.ssm_state
    dh = di // h
    kv = (batch, max_len, cfg.n_kv_heads, cfg.dh)
    return {
        "mamba": [
            (torch.zeros((batch, h, dh, n), dtype=torch.float32, device=device),
             torch.zeros((batch, cfg.conv_width - 1, di), dtype=cfg.dtype,
                         device=device))
            for _ in range(cfg.n_layers)],
        "shared_kv": [
            (torch.zeros(kv, dtype=cfg.dtype, device=device),
             torch.zeros(kv, dtype=cfg.dtype, device=device))
            for _ in _shared_positions(cfg)],
    }


def decode_step(cfg: cm.ModelConfig, params: Zamba, states: Dict[str, Any],
                token: Tensor, cache_len: int) -> Tuple[Tensor, Dict[str, Any]]:
    """One token (B, 1) → (logits (B, 1, V) float32, the new state): new
    mamba states, the shared block's caches written in place at
    ``cache_len``."""
    _check(cfg, params)
    x = cm.embed(cfg, params.embed, token)
    b = x.shape[0]
    positions = torch.full((b, 1), int(cache_len), dtype=torch.int64,
                           device=x.device)
    shared_at = _shared_positions(cfg)
    new_mamba, new_kv = [], []
    for i, p in enumerate(params.mamba):
        st, conv_st = states["mamba"][i]
        with splan.site_scope(f"layer.{i}", "mamba"):
            x, (nst, ncv) = mamba_block(cfg, p, x, state=st, conv_state=conv_st)
        new_mamba.append((nst, ncv))
        if i in shared_at:
            x, cache = _shared_block(cfg, params.shared, x, positions,
                                     kv_cache=states["shared_kv"][len(new_kv)],
                                     cache_len=cache_len)
            new_kv.append(cache)
    return cm.lm_logits(cfg, params.embed, x), {"mamba": new_mamba,
                                                "shared_kv": new_kv}


def prefill(cfg: cm.ModelConfig, params: Zamba, tokens: Tensor) -> Tensor:
    """Last-position logits (B, 1, V) of a full-sequence forward."""
    x = forward(cfg, params, tokens)
    return cm.lm_logits(cfg, params.embed, x[:, -1:, :])
