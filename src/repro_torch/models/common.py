"""Shared model config + transformer building blocks.

Counterpart of ``repro.models.common`` for the dense decoder stack. The
parameters are ``nn.Module``s (:class:`Dense`, :class:`Attn`, :class:`FFN`,
:class:`Embed`) holding frozen tensors; the blocks are functions of
``(cfg, module, x)``, as in ``repro``:

* every matmul routes through :func:`dense`, which resolves the contraction
  site under the enclosing :func:`repro_torch.nn.plan.site_scope` stack and
  calls that site's substrate's ``dot_general`` — under ``approx_cuda`` the
  hand-written CUDA contraction kernels;
* attention is the online softmax over KV chunks of ``repro`` in plain
  torch ops, float32 throughout (no (Sq, Skv) score tensor beyond one
  chunk);
* the LM head is a float32 matmul against the embedding, outside the
  substrate, as ``repro``'s einsum is; :func:`lm_loss_chunked` is the
  training loss, one vocabulary chunk of logits at a time.

The parameters are built with ``requires_grad=False``, so serving records
no autograd graph. Training turns them on with the module's own switch,
``module.requires_grad_(True)``, around the loss, and off again after the
step (``repro_torch.train.loop``): the parameters stay the same
``nn.Parameter`` objects of the same module, and the optimizer updates them in
place.

Not ported: MoE (``init_moe``, ``moe_block``, its local and expert-parallel
dispatch; ROADMAP.md queue 1 item 7) and ``sharding.constrain``, which has
no meaning without a mesh (item 11).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import weakref
from typing import Any, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.nn import plan as splan
from repro_torch.nn import substrate as psub
from repro_torch.obs.trace import trace_span

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The dense decoder's fields of ``repro.models.common.ModelConfig``.

    MoE, SSM, encoder and frontend fields wait for their families' slices
    (ROADMAP.md queue 1 item 7); a config with ``n_experts > 0`` raises.
    """
    name: str
    family: str                    # only "lm" builds (registry.build_bundle)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    n_experts: int = 0             # > 0 raises: MoE is not ported
    # attention
    qkv_bias: bool = False
    local_window: int = 0          # sliding-window size for local layers
    local_global_ratio: int = 0    # e.g. 5 -> 5 local : 1 global
    rope_theta: float = 1e4
    # execution
    dtype: torch.dtype = torch.bfloat16
    dot_plan: Any = "exact"        # site-addressed substrate assignment: a
                                   # repro_torch.nn.plan.SubstratePlan, a spec
                                   # string or a plan dict (substrate_plan())
    remat: bool = True             # recompute each layer in the backward
                                   # (torch.utils.checkpoint; training only)
    attn_chunk: int = 512
    loss_chunk: int = 512          # sequence positions per logits chunk of
                                   # lm_loss_chunked

    def __post_init__(self):
        if self.n_experts:
            raise NotImplementedError(
                f"{self.name}: MoE layers are not ported yet (ROADMAP.md, "
                "queue 1 item 7)")

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Total parameter count (used for 6·N·D model FLOPs)."""
        d = self.d_model
        attn = d * self.n_heads * self.dh + 2 * d * self.n_kv_heads * self.dh \
            + self.n_heads * self.dh * d
        return self.n_layers * (attn + 3 * d * self.d_ff) + self.vocab * d

    def active_param_count(self) -> int:
        """Activated params per token: all of them in a dense model."""
        return self.param_count()


# ---------------------------------------------------------------------------
# Parameters: tensors in nn.Modules, frozen until a training step unfreezes
# them (module.requires_grad_)
# ---------------------------------------------------------------------------


def _frozen(t: Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """A (d_in, d_out) weight ``w`` and an optional (d_out,) bias ``b``."""

    def __init__(self, w: Tensor, b: Optional[Tensor] = None):
        super().__init__()
        self.w = _frozen(w)
        self.register_parameter("b", None if b is None else _frozen(b))


class Attn(nn.Module):
    """GQA attention weights and its pre-norm scale ``ln`` (float32)."""

    def __init__(self, wq: Dense, wk: Dense, wv: Dense, wo: Dense, ln: Tensor):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.ln = _frozen(ln)


class FFN(nn.Module):
    """SwiGLU FFN weights and its pre-norm scale ``ln`` (float32)."""

    def __init__(self, wi: Dense, wg: Dense, wo: Dense, ln: Tensor):
        super().__init__()
        self.wi, self.wg, self.wo = wi, wg, wo
        self.ln = _frozen(ln)


class Embed(nn.Module):
    """The (vocab, d_model) embedding, shared with the LM head, and the
    final norm's scale ``ln_f``.

    :attr:`emb_f32` is the embedding in float32 for ``lm_logits``: ``repro``
    casts it on every call, which gives the same numbers (4.2 GB written per
    decode step at minitron-8b), so the cast is kept and taken again only
    when ``emb`` has changed since: another tensor (a weak reference to the
    source tells), a new storage (its address), or an in-place update (its
    version counter). The cast is taken on first use, so a model that only
    trains never holds it, and under a lock, so serving workers that start
    together cast once. The training loss casts ``emb`` itself, inside the
    autograd graph.
    """

    def __init__(self, emb: Tensor, ln_f: Tensor):
        super().__init__()
        self.emb = _frozen(emb)
        self.ln_f = _frozen(ln_f)
        self._f32 = (None, None)  # (key of the emb it was cast from, cast)

    def _stale(self, key) -> bool:
        return (key is None or key[0]() is not self.emb
                or key[1:] != (self.emb.data_ptr(), self.emb._version))

    @property
    def emb_f32(self) -> Tensor:
        key, cast = self._f32
        if self._stale(key):
            with _EMB_CAST_LOCK:
                key, cast = self._f32
                if self._stale(key):
                    cast = self.emb.detach().to(torch.float32)
                    # one assignment: readers on other threads see the old
                    # pair or the new one, never a mix
                    self._f32 = ((weakref.ref(self.emb), self.emb.data_ptr(),
                                  self.emb._version), cast)
        return cast


#: one recast of an embedding at a time (see Embed.emb_f32)
_EMB_CAST_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------


#: dense()'s quantization boundary: the historical `dot` policy (per-tensor
#: dynamic activation scale, per-output-channel weight scales).
_DENSE_QUANT = psub.QuantPolicy()


def substrate_plan(cfg: ModelConfig) -> "splan.SubstratePlan":
    """The plan governing this call: an active
    :func:`repro_torch.nn.plan.plan_override_scope` wins outright, else
    ``cfg.dot_plan`` normalized through :func:`repro_torch.nn.plan.as_plan`."""
    override = splan.current_plan_override()
    if override is not None:
        return override
    return splan.as_plan(cfg.dot_plan)


def dense(cfg: ModelConfig, x: Tensor, w: Tensor, b: Optional[Tensor] = None,
          *, site: Optional[str] = None) -> Tensor:
    """Matmul under the configured product substrate (the paper's technique).

    The substrate is chosen by the config's :func:`substrate_plan` at the
    ambient contraction site (``site`` is the leaf segment under the
    enclosing :func:`repro_torch.nn.plan.site_scope` stack — e.g. ``"wq"``
    under ``layer.3.attn`` resolves at ``layer.3.attn.wq``). The model's
    layer loop opens ``site_scope(f"layer.{i}")`` per layer, which gives each
    layer its own assignment where ``repro`` dispatches through
    ``scan_site_scope`` and ``lax.switch``. The contraction runs through
    ``dot_general`` with the default quantization policy, or through the
    ambient :func:`repro_torch.nn.substrate.dot_override_scope` hook where
    one is installed (QAT's straight-through contraction).
    """
    plan = substrate_plan(cfg)
    _, (name,) = splan.current_sites(site)
    spec_str = plan.resolve(name)
    cspec = psub.ContractionSpec.matmul(quant=_DENSE_QUANT, site=name or None)
    override = psub.current_dot_override()
    if override is not None:
        out = override(spec_str, x, w, cspec)
    else:
        out = psub.get_substrate(spec_str).dot_general(x, w, cspec)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
               bias: bool = False, device=None) -> Dense:
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device) / math.sqrt(d_in)
    b = torch.zeros((d_out,), dtype=dtype, device=device) if bias else None
    return Dense(w.to(dtype), b)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, dh); positions: (B, S) integer."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if dh % 2:
        rot = torch.cat([rot, x[..., -1:]], dim=-1)
    return rot.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, online softmax over KV chunks, causal/local windows)
# ---------------------------------------------------------------------------


def attention_chunked(q: Tensor, k: Tensor, v: Tensor, *, q_offset,
                      causal: bool = True, window: int = 0,
                      chunk: int = 512) -> Tensor:
    """Online-softmax attention.

    q: (B, Sq, H, dh); k, v: (B, Skv, Hkv, dh); q_offset: the absolute
    position of q[0] (0 for a full sequence; decode passes Sq=1,
    offset=cache_len). window > 0 = sliding-window (local) attention. Masked
    scores are -1e30, and the running max starts there, as in ``repro``;
    the chunks are a Python loop in place of ``lax.scan``, the remainder
    chunk last.
    """
    b, sq, h, dh = q.shape
    _, skv, hkv, _ = k.shape
    group = h // hkv
    qg = q.reshape(b, sq, hkv, group, dh).to(torch.float32)
    scale = 1.0 / math.sqrt(dh)
    chunk = min(chunk, skv)
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)

    m = torch.full((b, sq, hkv, group), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, hkv, group), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, hkv, group, dh), dtype=torch.float32, device=dev)
    for start in range(0, skv, chunk):
        k_blk = k[:, start:start + chunk].to(torch.float32)
        v_blk = v[:, start:start + chunk].to(torch.float32)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k_blk) * scale
        kv_pos = start + torch.arange(k_blk.shape[1], device=dev)
        mask = torch.ones((sq, k_blk.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if window > 0:
            mask &= (q_pos[:, None] - kv_pos[None, :]) < window
        s = torch.where(mask[None, :, None, None, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        l = l * torch.exp(m - m_new) + p.sum(dim=-1)
        acc = acc * torch.exp(m - m_new)[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p, v_blk)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(b, sq, h, dh).to(q.dtype)


def init_attn(gen: torch.Generator, cfg: ModelConfig, device=None) -> Attn:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    return Attn(
        wq=init_dense(gen, d, h * dh, cfg.dtype, cfg.qkv_bias, device),
        wk=init_dense(gen, d, hkv * dh, cfg.dtype, cfg.qkv_bias, device),
        wv=init_dense(gen, d, hkv * dh, cfg.dtype, cfg.qkv_bias, device),
        wo=init_dense(gen, h * dh, d, cfg.dtype, device=device),
        ln=torch.ones((d,), dtype=torch.float32, device=device))


def _write_cache(cache: Tensor, new: Tensor, cache_len: int) -> None:
    """Write ``new`` (B, S, Hkv, dh) into ``cache`` at ``cache_len``, in
    place; raises where ``repro``'s ``dynamic_update_slice`` would clamp."""
    s = new.shape[1]
    if not 0 <= cache_len <= cache.shape[1] - s:
        raise ValueError(f"cache_len {cache_len} + {s} new positions exceed "
                         f"the cache's {cache.shape[1]}")
    cache[:, cache_len:cache_len + s] = new.to(cache.dtype)


def attn_block(cfg: ModelConfig, p: Attn, x: Tensor, *, positions: Tensor,
               window: int = 0,
               kv_cache: Optional[Tuple[Tensor, Tensor]] = None,
               cache_len: Optional[int] = None,
               ) -> Tuple[Tensor, Optional[Tuple[Tensor, Tensor]]]:
    """Pre-norm GQA attention block. Returns (residual output, kv cache).

    kv_cache: (K, V) of shape (B, S_max, Hkv, dh) for decode, updated in
    place (``repro`` returns new arrays); cache_len is the current length
    (the new tokens are written from that index).
    """
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    xn = rms_norm(x, p.ln)
    with splan.site_scope("attn"):
        q = dense(cfg, xn, p.wq.w, p.wq.b, site="wq").reshape(b, s, h, dh)
        k = dense(cfg, xn, p.wk.w, p.wk.b, site="wk").reshape(b, s, hkv, dh)
        v = dense(cfg, xn, p.wv.w, p.wv.b, site="wv").reshape(b, s, hkv, dh)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q_offset = 0
    if kv_cache is not None:
        ck, cv = kv_cache
        _write_cache(ck, k, int(cache_len))
        _write_cache(cv, v, int(cache_len))
        k, v = ck, cv
        q_offset = int(cache_len)
    with trace_span("lm.attention", "model"):
        out = attention_chunked(q, k, v, q_offset=q_offset, window=window,
                                chunk=cfg.attn_chunk)
    with splan.site_scope("attn"):
        out = dense(cfg, out.reshape(b, s, h * dh), p.wo.w, site="wo")
    return x + out.to(x.dtype), kv_cache


# ---------------------------------------------------------------------------
# Dense (SwiGLU) FFN
# ---------------------------------------------------------------------------


def init_ffn(gen: torch.Generator, cfg: ModelConfig, device=None) -> FFN:
    d, f = cfg.d_model, cfg.d_ff
    return FFN(wi=init_dense(gen, d, f, cfg.dtype, device=device),
               wg=init_dense(gen, d, f, cfg.dtype, device=device),
               wo=init_dense(gen, f, d, cfg.dtype, device=device),
               ln=torch.ones((d,), dtype=torch.float32, device=device))


def ffn_block(cfg: ModelConfig, p: FFN, x: Tensor) -> Tensor:
    xn = rms_norm(x, p.ln)
    with splan.site_scope("ffn"):
        gate = dense(cfg, xn, p.wg.w, site="wg")
        hidden = gate * torch.sigmoid(gate) * dense(cfg, xn, p.wi.w, site="wi")
        return x + dense(cfg, hidden, p.wo.w, site="wo").to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head / chunked loss
# ---------------------------------------------------------------------------


def init_embed(gen: torch.Generator, cfg: ModelConfig, device=None) -> Embed:
    emb = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                      dtype=torch.float32, device=device)
    return Embed((emb / math.sqrt(cfg.d_model)).to(cfg.dtype),
                 torch.ones((cfg.d_model,), dtype=torch.float32, device=device))


def embed(cfg: ModelConfig, p: Embed, tokens: Tensor) -> Tensor:
    return p.emb[tokens]


def lm_logits(cfg: ModelConfig, p: Embed, x: Tensor) -> Tensor:
    """(B, S, d) hidden states → (B, S, vocab) float32 logits."""
    x = rms_norm(x, p.ln_f)
    with trace_span("lm.logits", "model"):
        return torch.matmul(x.to(torch.float32), p.emb_f32.t())


def _xent_sum(xs: Tensor, labels: Tensor, emb_t: Tensor) -> Tensor:
    """Σ (logsumexp − gold logit) over one chunk of positions, float32."""
    logits = torch.matmul(xs.to(torch.float32), emb_t)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (logz - gold).sum()


def lm_loss_chunked(cfg: ModelConfig, p: Embed, x: Tensor,
                    labels: Tensor) -> Tensor:
    """Mean softmax cross-entropy of hidden states ``x`` (B, S, d) against
    ``labels`` (B, S), never holding more than one chunk of ``loss_chunk``
    positions' (B, chunk, V) logits: each chunk is recomputed in the
    backward (``repro``'s ``jax.checkpoint`` of its scan body), the
    remainder chunk last. The embedding is cast to float32 on every call,
    inside the graph, so its gradient flows."""
    b, s, _ = x.shape
    x = rms_norm(x, p.ln_f)
    chunk = min(cfg.loss_chunk, s)
    n = s // chunk
    emb_t = p.emb.to(torch.float32).t()  # (d, V)
    labels = labels.to(torch.int64)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        if torch.is_grad_enabled():
            part = checkpoint(_xent_sum, x[:, sl], labels[:, sl], emb_t,
                              use_reentrant=False)
        else:
            part = _xent_sum(x[:, sl], labels[:, sl], emb_t)
        total = total + part
    if s - n * chunk:
        total = total + _xent_sum(x[:, n * chunk:], labels[:, n * chunk:], emb_t)
    return total / (b * s)
