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

The MoE layer (:class:`MoE`, :func:`init_moe`, :func:`moe_block`) routes
each token to its top-k experts with ``repro``'s capacity dispatch
(``_dispatch_local``: sort-based ranks, token dropping on overflow) and
runs the experts as three batched products outside the substrate, as
``repro`` does; the shared expert is a :func:`ffn_block` under the substrate
at ``layer.<i>.moe.shared.ffn.w*``. :func:`attn_block` takes precomputed
cross-attention K/V (``cross_kv``) for the encoder-decoder family.

Under a mesh with a "model" axis (:func:`repro_torch.models.sharding.mesh_scope`)
the MoE runs expert-parallel (:func:`_moe_block_ep`, ``repro``'s
``shard_map`` body with its collectives called eagerly), and :func:`dense`
shards its contraction under an ambient
:func:`repro_torch.nn.substrate.partitioning_scope`.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import weakref
from types import SimpleNamespace
from typing import Any, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import sharding as sh
from repro_torch.nn import collectives as coll
from repro_torch.nn import plan as splan
from repro_torch.nn import substrate as psub
from repro_torch.obs.trace import trace_span

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """``repro.models.common.ModelConfig`` for every family: the attention
    families (lm with its MoE layers, vlm, encdec) and the recurrent ones
    (xlstm, zamba; the SSM fields ``ssm_state``, ``conv_width``,
    ``shared_attn_every``).
    """
    name: str
    family: str                    # lm | encdec | vlm | xlstm | zamba
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 1
    moe_interleave: int = 1        # MoE every k-th layer
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # attention
    qkv_bias: bool = False
    local_window: int = 0          # sliding-window size for local layers
    local_global_ratio: int = 0    # e.g. 5 -> 5 local : 1 global
    rope_theta: float = 1e4
    # SSM / recurrent
    ssm_state: int = 0
    conv_width: int = 4
    shared_attn_every: int = 0     # zamba: shared attention block period
    # modality frontend stubs
    n_frames: int = 0              # whisper encoder frames (post-conv stub)
    n_patches: int = 0             # paligemma image patches
    # encoder (enc-dec only)
    n_encoder_layers: int = 0
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

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_ff_expert(self) -> int:
        return self.d_ff

    def param_count(self) -> int:
        """Total parameter count (used for 6·N·D model FLOPs); as ``repro``
        counts it, which leaves out the vlm's ``patch_proj``."""
        d, v = self.d_model, self.vocab
        attn = d * self.n_heads * self.dh + 2 * d * self.n_kv_heads * self.dh \
            + self.n_heads * self.dh * d
        dense_ffn = 3 * d * self.d_ff
        emb = v * d
        if self.family == "xlstm":
            per_layer = 8 * d * d // 2  # m/sLSTM projections (approx.)
            return self.n_layers * per_layer + 2 * emb
        if self.family == "zamba":
            d_in = 2 * d
            mamba = d * (2 * d_in + 2 * self.ssm_state + 32) + d_in * d
            return self.n_layers * mamba + (attn + dense_ffn) + emb
        n_moe = self.n_layers // self.moe_interleave if self.n_experts else 0
        n_dense = self.n_layers - n_moe
        moe_ffn = n_moe * (self.n_experts * 3 * d * self.d_ff_expert
                           + d * self.n_experts
                           + (3 * d * self.d_ff_expert if self.shared_expert else 0))
        total = self.n_layers * attn + n_dense * dense_ffn + moe_ffn + emb
        if self.family == "encdec":
            total += self.n_encoder_layers * (attn + dense_ffn + attn)  # + cross-attn
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared instead of all)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        n_moe = self.n_layers // self.moe_interleave
        all_experts = n_moe * self.n_experts * 3 * d * self.d_ff_expert
        active = n_moe * (self.top_k + (1 if self.shared_expert else 0)) \
            * 3 * d * self.d_ff_expert
        return self.param_count() - all_experts + active


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


class MoE(nn.Module):
    """A top-k MoE layer: the float32 (d, E) ``router``, the expert tensors
    ``wi``, ``wg`` (E, d, f) and ``wo`` (E, f, d) as bare tensors (no
    :class:`Dense`: ``repro`` stores them bare, and they never pass the
    substrate), the pre-norm scale ``ln`` (float32) and, where the config
    has one, the ``shared`` expert's :class:`FFN`."""

    def __init__(self, router: Tensor, wi: Tensor, wg: Tensor, wo: Tensor,
                 ln: Tensor, shared: Optional[FFN] = None):
        super().__init__()
        self.router = _frozen(router)
        self.wi, self.wg, self.wo = _frozen(wi), _frozen(wg), _frozen(wo)
        self.ln = _frozen(ln)
        self.shared = shared


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
    one is installed (QAT's straight-through contraction). Under an ambient
    :func:`repro_torch.nn.substrate.partitioning_scope` the contraction is
    sharded over its mesh. On the dry run's mesh a row-parallel result is
    reduced (:func:`repro_torch.models.sharding.reduce_pending`), onto the
    residual stream's placements inside
    :func:`repro_torch.models.sharding.reduce_onto`.
    """
    plan = substrate_plan(cfg)
    _, (name,) = splan.current_sites(site)
    spec_str = plan.resolve(name)
    cspec = psub.ContractionSpec.matmul(
        quant=_DENSE_QUANT, partitioning=psub.current_partitioning(),
        site=name or None)
    override = psub.current_dot_override()
    # on the dry run's mesh: x's cotangent is reduced at this product, as
    # GSPMD reduces each transposed dot's partial sums
    x = sh.reduce_pending(x)
    with sh.gathered(w, x) as w:
        if override is not None:
            out = override(spec_str, x, w, cspec)
        else:
            out = psub.get_substrate(spec_str).dot_general(x, w, cspec)
    out = sh.reduce_pending(out)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    if sh.is_split(x, -1):
        # the dry run's stream split along its features (vlm's): the mean
        # is summed over the split, the scale's gradient over the batch
        # first, as GSPMD does
        var, scale = sh.reduce_pending(var), sh.reduce_grad(scale)
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
    # on the dry run's mesh, paligemma's one KV head split along head_dim:
    # the halves and the rotation stay split (sharding.halves / cat)
    x1, x2 = sh.halves(x, half)
    rot = sh.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
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
    chunk last. On the dry run's mesh each rank attends with its own rows
    and heads, as GSPMD splits the attention, where both head counts
    split (``DTensor``'s own placements for these products differ between
    torch releases). Where the KV heads are too few to split (paligemma's
    one), K and V stay split along head_dim, as GSPMD keeps ``wk`` /
    ``wv``'s columns, and each block is gathered whole where it is read.
    """
    heads, kv = ("batch", None, "heads", None), ("batch", None, "kv_heads", None)
    gather = None
    if sh.is_split(k, -1) and not sh.is_split(k, 2):
        kv = ("batch", None, None, "heads")
        gather = sh.gather_local("heads", 3)
    return sh.on_shards(
        lambda q_, k_, v_: _attend(q_, k_, v_, q_offset=q_offset,
                                   causal=causal, window=window, chunk=chunk,
                                   gather=gather),
        (heads, kv, kv), heads, q, k, v)


def _attend(q: Tensor, k: Tensor, v: Tensor, *, q_offset, causal: bool,
            window: int, chunk: int, gather=None) -> Tensor:
    b, sq, h, dh = q.shape
    _, skv, hkv, _ = k.shape
    group = h // hkv
    q = sh.regroup(q, hkv, dim=2, alt=1)
    qg = q.reshape(b, sq, hkv, group, dh).to(torch.float32)
    scale = 1.0 / math.sqrt(dh)
    chunk = min(chunk, skv)
    gather = gather or (lambda t: t)
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)

    # shaped like qg, and so split like it on the dry run's mesh
    m = torch.full_like(qg[..., 0], -1e30)
    l = torch.zeros_like(qg[..., 0])
    acc = torch.zeros_like(qg)
    for start in range(0, skv, chunk):
        # a cache split along its positions on the dry run's mesh: each
        # block is brought to every rank, as GSPMD brings each block of
        # repro's scan
        n = min(chunk, skv - start)
        k_blk = gather(sh.block(k, 1, start, n).to(torch.float32))
        v_blk = gather(sh.block(v, 1, start, n).to(torch.float32))
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
    if sh.is_split(cache, 1):       # the dry run's long-sequence cache
        sh.write_at(cache, new, cache_len, dim=1)
    else:
        cache[:, cache_len:cache_len + s] = new.to(cache.dtype)


def attn_block(cfg: ModelConfig, p: Attn, x: Tensor, *, positions: Tensor,
               window: int = 0,
               kv_cache: Optional[Tuple[Tensor, Tensor]] = None,
               cache_len: Optional[int] = None,
               cross_kv: Optional[Tuple[Tensor, Tensor]] = None,
               causal: bool = True,
               ) -> Tuple[Tensor, Optional[Tuple[Tensor, Tensor]]]:
    """Pre-norm GQA attention block. Returns (residual output, kv cache).

    kv_cache: (K, V) of shape (B, S_max, Hkv, dh) for decode, updated in
    place (``repro`` returns new arrays); cache_len is the current length
    (the new tokens are written from that index).
    cross_kv: precomputed (K, V) for encoder-decoder cross attention: only
    ``wq`` and ``wo`` run here, q is not rotated, and without a cache the
    block attends to every key (as does ``causal=False``, the encoder's).
    """
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    # on the dry run's mesh, a stream split along its features (vlm's) is
    # gathered once for the products that read it
    xn = sh.gather_last(rms_norm(x, p.ln))
    with splan.site_scope("attn"):
        q = dense(cfg, xn, p.wq.w, p.wq.b, site="wq").reshape(b, s, h, dh)
        if cross_kv is None:
            k = dense(cfg, xn, p.wk.w, p.wk.b, site="wk").reshape(b, s, hkv, dh)
            v = dense(cfg, xn, p.wv.w, p.wv.b, site="wv").reshape(b, s, hkv, dh)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        else:
            k, v = cross_kv
    q = sh.constrain(q, "batch", "seq", "heads", "head_dim")
    q_offset = 0
    if kv_cache is not None:
        ck, cv = kv_cache
        _write_cache(ck, k, int(cache_len))
        _write_cache(cv, v, int(cache_len))
        k, v = ck, cv
        q_offset = int(cache_len)
    else:
        causal = causal and cross_kv is None
    with trace_span("lm.attention", "model"):
        out = attention_chunked(q, k, v, q_offset=q_offset, causal=causal,
                                window=window, chunk=cfg.attn_chunk)
    out = sh.constrain(out, "batch", "seq", "heads", "head_dim")   # as q
    with splan.site_scope("attn"), sh.reduce_onto(x):
        out = dense(cfg, out.reshape(b, s, h * dh), p.wo.w, site="wo")
    return x + out.to(x.dtype), kv_cache


# ---------------------------------------------------------------------------
# Dense (SwiGLU) FFN
# ---------------------------------------------------------------------------


def init_ffn(gen: torch.Generator, cfg: ModelConfig, device=None,
             d_ff: Optional[int] = None) -> FFN:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return FFN(wi=init_dense(gen, d, f, cfg.dtype, device=device),
               wg=init_dense(gen, d, f, cfg.dtype, device=device),
               wo=init_dense(gen, f, d, cfg.dtype, device=device),
               ln=torch.ones((d,), dtype=torch.float32, device=device))


def ffn_block(cfg: ModelConfig, p: FFN, x: Tensor) -> Tensor:
    xn = sh.gather_last(rms_norm(x, p.ln))
    with splan.site_scope("ffn"):
        gate = dense(cfg, xn, p.wg.w, site="wg")
        hidden = gate * torch.sigmoid(gate) * dense(cfg, xn, p.wi.w, site="wi")
        hidden = sh.constrain(hidden, "batch", "seq", "mlp")
        with sh.reduce_onto(x):
            return x + dense(cfg, hidden, p.wo.w, site="wo").to(x.dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts (capacity dispatch, the local path)
# ---------------------------------------------------------------------------


def _expert_weights(gen: torch.Generator, shape, scale: float, dtype,
                    device) -> Tensor:
    """Normal (E, d_in, d_out) weights times ``scale``, drawn one expert at a
    time in float32 and cast into ``dtype``: the float32 draw of a whole
    expert tensor would be 21.5 GB at llama4-maverick's widths. On
    ``meta`` (the dry run's parameters) there is nothing to draw."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    for e in range(shape[0]):
        out[e] = torch.randn(shape[1:], generator=gen, dtype=torch.float32,
                             device=device) * scale
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig, device=None) -> MoE:
    """``repro``'s MoE init (not its random stream: parameters cross over
    through :mod:`repro_torch.models.convert`)."""
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    std = 1.0 / math.sqrt(d)
    router = torch.randn((d, e), generator=gen, dtype=torch.float32,
                         device=device) * std
    wi = _expert_weights(gen, (e, d, f), std, cfg.dtype, device)
    wg = _expert_weights(gen, (e, d, f), std, cfg.dtype, device)
    wo = _expert_weights(gen, (e, f, d), 1.0 / math.sqrt(f), cfg.dtype, device)
    shared = (init_ffn(gen, cfg, device, cfg.d_ff_expert)
              if cfg.shared_expert else None)
    return MoE(router, wi, wg, wo,
               torch.ones((d,), dtype=torch.float32, device=device), shared)


def moe_block(cfg: ModelConfig, p: MoE, x: Tensor) -> Tensor:
    """Top-k capacity-based MoE (token-dropping on overflow).

    Under a mesh with a "model" axis (``sharding.mesh_scope``), on
    ``repro``'s conditions — the global token count divides into the data
    × model shards, the experts into the model shards — dispatch runs
    expert-parallel (:func:`_moe_block_ep`). There ``x`` is this rank's
    data shard of the batch (the data-parallel split is the caller's, as
    the launcher's) and ``p`` holds this rank's E / M experts
    (``convert.shard_experts``). Otherwise every expert is on this device
    and the local path runs.
    """
    mesh = sh.current_mesh()
    if mesh is not None and "model" in coll.axis_names(mesh):
        dp = tuple(a for a in ("pod", "data") if a in coll.axis_names(mesh))
        m_size = coll.axis_size(mesh, "model")
        dp_size = math.prod(coll.axis_size(mesh, a) for a in dp)
        t = sh.global_size(x, 0, dp) * x.shape[1]   # the global token count
        if t % (dp_size * m_size) == 0 and cfg.n_experts % m_size == 0:
            return _moe_block_ep(cfg, p, x, mesh)
    if p.wi.shape[0] != cfg.n_experts:
        raise ValueError(
            f"the MoE holds {p.wi.shape[0]} of {cfg.n_experts} experts, and "
            "the expert-parallel conditions do not hold here (a mesh with a "
            "'model' axis, tokens and experts divisible by its shards)")
    return _moe_block_local(cfg, p, x)


def _top_k(gates: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, the lower index
    first among equal values (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_local(cfg: ModelConfig, xn: Tensor, router: Tensor):
    """Route tokens ``xn`` (t, d): returns (buf (E, C, d), combine info
    ``(slot, topw, keep, cap)``).

    The router product and softmax are float32. Each (token, choice) ranks
    within its expert in token order (a stable sort of the flat expert ids,
    then its distance from the expert's first entry); ranks at or past the
    capacity ``C = max(1, ceil(t · k · capacity_factor / E))`` are dropped
    and scattered to the discarded row ``E · C``, which several may write
    and nothing reads.

    Under autograd, as ``jax.grad`` of ``repro``'s: the gradient reaches
    the router through the softmax, the sort's selection and the
    renormalised ``topw``, and ``xn`` through the scatter into ``buf``,
    whose backward gathers each choice's row of the gradient (a dropped
    choice reads the discarded row, which nothing downstream reads: zero).
    The ranks and slots are integers and carry none.
    """
    t, d = xn.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = xn.device
    gates = torch.softmax(torch.matmul(xn.to(torch.float32), router), dim=-1)
    topw, topi = _top_k(gates, k)                               # (t, k)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    cap = int(max(1, math.ceil(t * k * cfg.capacity_factor / e)))
    flat_e = topi.reshape(-1)                                   # (t*k,)
    order = torch.argsort(flat_e, stable=True)                  # token-order ties
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    rank_sorted = torch.arange(t * k, device=dev) - start[sorted_e]
    my_rank = torch.empty_like(rank_sorted)
    my_rank[order] = rank_sorted
    keep = my_rank < cap
    slot = torch.where(keep, flat_e * cap + my_rank,
                       torch.full_like(my_rank, e * cap))
    buf = torch.zeros((e * cap + 1, d), dtype=xn.dtype, device=dev)
    # xn[repeat(arange(t), k)] as a broadcast: its gradient is a reduction
    # over each token's k choices, not a scatter-add into xn
    buf[slot] = xn[:, None, :].expand(t, k, d).reshape(t * k, d)
    return buf[:e * cap].reshape(e, cap, d), (slot, topw, keep, cap)


def _combine_local(out: Tensor, info, t: int) -> Tensor:
    """Inverse of :func:`_dispatch_local`: weighted gather back to token
    order; dropped choices read a zero row."""
    slot, topw, keep, cap = info
    e, d = out.shape[0], out.shape[-1]
    out_flat = torch.cat([out.reshape(e * cap, d),
                          torch.zeros((1, d), dtype=out.dtype, device=out.device)])
    gathered = out_flat[slot]                                   # (t*k, d)
    w = (topw.reshape(-1) * keep).to(gathered.dtype)
    k = topw.shape[1]
    return (gathered * w[:, None]).reshape(t, k, d).sum(dim=1)


def _expert_ffn(p: MoE, buf: Tensor) -> Tensor:
    """Every expert's SwiGLU on its (C, d) slots: three batched products in
    ``buf``'s dtype, outside the substrate (as ``repro``'s einsums)."""
    gate = torch.bmm(buf, p.wg.to(buf.dtype))
    hid = gate * torch.sigmoid(gate) * torch.bmm(buf, p.wi.to(buf.dtype))
    return torch.bmm(hid, p.wo.to(hid.dtype))


def _moe_block_local(cfg: ModelConfig, p: MoE, x: Tensor) -> Tensor:
    b, s, d = x.shape
    t = b * s
    xn = rms_norm(x, p.ln).reshape(t, d)
    # the dry run's DTensors route whole on every rank: the sort and search
    # have no sharding rule (a decode step's few tokens)
    y = sh.on_whole(lambda *a: _routed(cfg, *a), xn, p.router, p.wi, p.wg,
                    p.wo)
    if cfg.shared_expert:
        # ffn_block adds its input back; repro subtracts it again
        with splan.site_scope("moe", "shared"):
            y = y + (ffn_block(cfg, p.shared, xn.reshape(b, s, d))
                     - xn.reshape(b, s, d)).reshape(t, d)
    return x + y.reshape(b, s, d).to(x.dtype)


def _routed(cfg: ModelConfig, xn: Tensor, router: Tensor, wi: Tensor,
            wg: Tensor, wo: Tensor) -> Tensor:
    """Every token of ``xn`` (t, d) through its experts: dispatch, the
    experts' SwiGLU, combine."""
    buf, info = _dispatch_local(cfg, xn, router)
    out = _expert_ffn(SimpleNamespace(wi=wi, wg=wg, wo=wo), buf)
    return _combine_local(out, info, xn.shape[0])


def _moe_block_ep(cfg: ModelConfig, p: MoE, x: Tensor, mesh) -> Tensor:
    """Expert-parallel MoE: local dispatch → all-to-all → FFN → all-to-all.

    ``repro``'s ``shard_map`` body (:func:`_ep_body`), run on every rank
    with its collectives over the "model" group: ``x`` is the rank's data
    shard, replicated over "model", and ``p`` holds the rank's E / M
    experts. The dry run's ``DTensor``s cross ``repro``'s boundary
    (:func:`repro_torch.models.sharding.shard_map`): tokens over the data
    axes, the router whole, the experts over "model". The shared expert
    stays replicated, outside the body, as in ``repro``.
    """
    b, s, d = x.shape
    t = b * s
    xn = rms_norm(x, p.ln).reshape(t, d)
    dp = tuple(a for a in ("pod", "data") if a in coll.axis_names(mesh))
    experts = ("model", None, None)
    y = sh.shard_map(lambda *a: _ep_body(cfg, *a, mesh=mesh), mesh,
                     ((dp, None), (), experts, experts, experts), (dp, None),
                     xn, p.router, p.wi, p.wg, p.wo, partial_over=dp)
    if cfg.shared_expert:
        with splan.site_scope("moe", "shared"):
            y = y + (ffn_block(cfg, p.shared, xn.reshape(b, s, d))
                     - xn.reshape(b, s, d)).reshape(t, d)
    return x + y.reshape(b, s, d).to(x.dtype)


def _ep_body(cfg: ModelConfig, xn: Tensor, router: Tensor, wi: Tensor,
             wg: Tensor, wo: Tensor, *, mesh) -> Tensor:
    """``repro``'s ``shard_map`` body on one rank's local tensors.

    Each model rank routes a distinct 1/M slice of its data shard's tokens
    ``xn`` (``repro`` keeps the boundary data-sharded and slices inside the
    body for the same reason), so every dispatch is done once. The buffer's
    expert dim goes to the experts' owners and its capacity dim is
    gathered, the rank's E / M experts run, the reverse all-to-all brings
    the results home and the slices are gathered over "model".

    Gradients as ``jax.grad`` of ``repro``'s: ``shard_map``'s transpose
    sums the cotangent of an input the body sees replicated over "model"
    (``xn``, the router) over "model", and divides the cotangent of an
    output replicated over "model" by M (``coll.replicated_in`` /
    ``replicated_out``). The experts, sharded over "model", keep this
    rank's; a leaf replicated over "data" is the caller's to reduce.
    """
    m_size = coll.axis_size(mesh, "model")
    if wi.shape[0] * m_size != cfg.n_experts:
        raise ValueError(
            f"expert parallelism over {m_size} model shards needs "
            f"{cfg.n_experts // m_size} experts a rank, got {wi.shape[0]} "
            "(convert.shard_experts takes a rank's shard)")
    xn_l = coll.replicated_in(xn, mesh, "model")
    router = coll.replicated_in(router, mesh, "model")
    t_mm = xn.shape[0] // m_size
    m_idx = coll.axis_index(mesh, "model")
    xn_mine = xn_l[m_idx * t_mm:(m_idx + 1) * t_mm]
    buf, info = _dispatch_local(cfg, xn_mine, router)           # (E, C_l, d)
    buf = coll.all_to_all(buf, mesh, "model", split_axis=0,
                          concat_axis=1)                        # (E_l, C_l·M, d)
    out = _expert_ffn(SimpleNamespace(wi=wi, wg=wg, wo=wo), buf)
    out = coll.all_to_all(out, mesh, "model", split_axis=1,
                          concat_axis=0)                        # (E, C_l, d)
    y_mine = _combine_local(out, info, t_mm)                    # (t_mm, d)
    return coll.replicated_out(coll.all_gather(y_mine, mesh, "model", dim=0),
                               mesh, "model")


# ---------------------------------------------------------------------------
# Embedding / LM head / chunked loss
# ---------------------------------------------------------------------------


def init_embed(gen: torch.Generator, cfg: ModelConfig, device=None) -> Embed:
    emb = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                      dtype=torch.float32, device=device)
    return Embed((emb / math.sqrt(cfg.d_model)).to(cfg.dtype),
                 torch.ones((cfg.d_model,), dtype=torch.float32, device=device))


def embed(cfg: ModelConfig, p: Embed, tokens: Tensor,
          like: Optional[Tensor] = None) -> Tensor:
    """The tokens' rows of the embedding. On the dry run's mesh the
    lookup's pending sum lands on ``like``'s placements (vlm's patch
    projections, which the rows are concatenated with), else on the
    rules'."""
    e = sh.constrain(p.emb, "vocab", "embed")
    x = sh.lookup(e, tokens)
    if like is None:
        return sh.constrain(x, "batch", "seq", "embed")
    with sh.reduce_onto(like):
        return sh.reduce_pending(x)


def lm_logits(cfg: ModelConfig, p: Embed, x: Tensor) -> Tensor:
    """(B, S, d) hidden states → (B, S, vocab) float32 logits."""
    x = rms_norm(x, p.ln_f)
    with trace_span("lm.logits", "model"), \
            sh.gathered(p.emb_f32, x) as e:
        logits = torch.matmul(x.to(torch.float32), e.t())
    return sh.constrain(logits, "batch", "seq", "vocab")


def _xent_sum(xs: Tensor, labels: Tensor, emb_t: Tensor) -> Tensor:
    """Σ (logsumexp − gold logit) over one chunk of positions, float32; on
    the dry run's mesh the embedding is gathered here, at its use, as
    ``repro``'s loss gathers it inside its scan body."""
    with sh.gathered(emb_t, xs) as e:
        logits = torch.matmul(sh.reduce_pending(xs.to(torch.float32)), e)
    return sh.xent_sum(sh.constrain(logits, "batch", "seq", "vocab"), labels)


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
    emb_t = p.emb.to(torch.float32).t()     # (d, V)
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
