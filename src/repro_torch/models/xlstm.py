"""xLSTM family (arXiv:2405.04517): alternating mLSTM / sLSTM blocks.

Counterpart of ``repro.models.xlstm``. mLSTM: a matrix memory C ∈
R^{dh×dh} per head with exponential-style gating, run as a chunked
recurrence (the state carried across chunks, the quadratic form inside a
chunk: the linear-attention identity). sLSTM: a per-head vector memory with
sigmoid gates, the recurrence ``c_t = f_t c_{t-1} + i_t z_t`` evaluated by
:func:`associative_scan`, the recursion of ``jax.lax.associative_scan``.

The parameters are an :class:`XLSTM` module: the embedding and one
:class:`MLSTM` (even layers) or :class:`SLSTM` (odd layers) per layer in an
``nn.ModuleList``, run by a Python layer loop. Layer ``i`` runs under
``site_scope(f"layer.{i}", kind)``, ``kind`` ``"mlstm"`` or ``"slstm"``,
so its contractions resolve at ``layer.<i>.mlstm.wq`` ... as in ``repro``.
The recurrences, gates and norms are float work outside the substrate; every
projection is a :func:`~repro_torch.models.common.dense`.

The decode state is a list of per-layer float32 tensors: (B, H, dh, dh)
for an mLSTM layer, (B, d) for an sLSTM layer. :func:`decode_step` returns
a new list, as ``repro`` does; it ignores ``cache_len``.

Training differentiates :func:`loss_fn` with autograd, through both
scans: the sLSTM's :func:`associative_scan` writes its outputs into slices
of a fresh tensor, which autograd records as copies into those slices.
Under ``cfg.remat`` (and only while autograd records) each layer is a
checkpointed region (``lm._maybe_remat``, ``repro``'s ``jax.checkpoint``
per layer), recomputed in the backward under the forward's site stack,
plan and contraction override, so a training step runs each dense twice.
``repro``'s ``jax.checkpoint`` around ``mlstm_scan``'s chunk body inside a
layer changes no value and saves memory only within the layer's
recompute; it has no counterpart here.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.nn import plan as splan

Tensor = torch.Tensor
States = List[Tensor]


def _split_heads(x: Tensor, h: int) -> Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """An mLSTM block: the pre-norm scale ``ln`` (float32), the q/k/v
    projections, the per-head input and forget gates ``wi``, ``wf`` (d, H),
    the output gate ``wo_gate`` and the output projection ``wo``."""

    def __init__(self, ln: Tensor, wq: cm.Dense, wk: cm.Dense, wv: cm.Dense,
                 wi: cm.Dense, wf: cm.Dense, wo_gate: cm.Dense, wo: cm.Dense):
        super().__init__()
        self.ln = cm._frozen(ln)
        self.wq, self.wk, self.wv = wq, wk, wv
        self.wi, self.wf, self.wo_gate, self.wo = wi, wf, wo_gate, wo


class SLSTM(nn.Module):
    """An sLSTM block: ``ln`` (float32), the cell input ``wz``, the gates
    ``wi``, ``wf``, ``wo_gate`` and the output projection ``wo``, all (d, d)."""

    def __init__(self, ln: Tensor, wz: cm.Dense, wi: cm.Dense, wf: cm.Dense,
                 wo_gate: cm.Dense, wo: cm.Dense):
        super().__init__()
        self.ln = cm._frozen(ln)
        self.wz, self.wi, self.wf, self.wo_gate, self.wo = wz, wi, wf, wo_gate, wo


class XLSTM(nn.Module):
    """Embedding (shared with the LM head) and the blocks, mLSTM first."""

    def __init__(self, embed: cm.Embed, layers: Sequence[nn.Module]):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)

    @property
    def device(self) -> torch.device:
        return self.embed.emb.device


#: leaf names of each block kind, in the order of their constructor
MLSTM_LEAVES = ("wq", "wk", "wv", "wi", "wf", "wo_gate", "wo")
SLSTM_LEAVES = ("wz", "wi", "wf", "wo_gate", "wo")


def _ones(d: int, device) -> Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def init_mlstm(gen: torch.Generator, cfg: cm.ModelConfig, device=None) -> MLSTM:
    d = cfg.d_model
    widths = {"wi": cfg.n_heads, "wf": cfg.n_heads}
    return MLSTM(_ones(d, device), *(
        cm.init_dense(gen, d, widths.get(n, d), cfg.dtype, device=device)
        for n in MLSTM_LEAVES))


def init_slstm(gen: torch.Generator, cfg: cm.ModelConfig, device=None) -> SLSTM:
    d = cfg.d_model
    return SLSTM(_ones(d, device), *(
        cm.init_dense(gen, d, d, cfg.dtype, device=device) for _ in SLSTM_LEAVES))


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def mlstm_scan(q: Tensor, k: Tensor, v: Tensor, i_gate: Tensor, f_gate: Tensor,
               state: Tensor, chunk: int) -> Tuple[Tensor, Tensor]:
    """Chunked linear-attention recurrence, ``repro``'s formulation.

    q, k, v: (B, S, H, dh); i_gate / f_gate: (B, S, H) in (0, 1); state:
    (B, H, dh, dh) carried matrix memory. Returns (y float32, new_state).
    Inside a chunk, ``M[t, u] = exp(lcum_t - lcum_u) i_u (q_t · k_u)`` for
    u ≤ t, the mask applied after the product; across chunks, the state.
    """
    b, s, h, dh = q.shape
    chunk = min(chunk, s)
    n = s // chunk
    assert n * chunk == s, "sequence must be divisible by chunk"
    f32 = torch.float32
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    st = state
    ys = []
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        qq, kk, vv = q[:, sl].to(f32), k[:, sl].to(f32), v[:, sl].to(f32)
        ii, ff = i_gate[:, sl].to(f32), f_gate[:, sl].to(f32)
        logf = torch.log(torch.clamp_min(ff, 1e-6))
        lcum = torch.cumsum(logf, dim=1)                        # (B, C, H)
        qt = qq * torch.exp(lcum)[..., None]
        ku = kk * (ii * torch.exp(-lcum))[..., None]
        scores = torch.einsum("bthd,buhd->bhtu", qt, ku)
        scores = torch.where(mask[None, None], scores, 0.0)
        y_intra = torch.einsum("bhtu,buhd->bthd", scores, vv)
        y_inter = torch.einsum("bthd,bhde->bthe", qt, st)
        decay_all = torch.exp(lcum[:, -1:, :])                  # (B, 1, H)
        ku_tail = kk * (ii * torch.exp(lcum[:, -1:, :] - lcum))[..., None]
        st = st * decay_all[:, 0, :, None, None] + torch.einsum(
            "buhd,buhe->bhde", ku_tail, vv)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), st


def mlstm_block(cfg: cm.ModelConfig, p: MLSTM, x: Tensor,
                state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    b, s, d = x.shape
    h = cfg.n_heads
    f32 = torch.float32
    xn = cm.rms_norm(x, p.ln)
    q = _split_heads(cm.dense(cfg, xn, p.wq.w, site="wq"), h) / math.sqrt(d // h)
    k = _split_heads(cm.dense(cfg, xn, p.wk.w, site="wk"), h)
    v = _split_heads(cm.dense(cfg, xn, p.wv.w, site="wv"), h)
    i_gate = torch.sigmoid(cm.dense(cfg, xn, p.wi.w, site="wi").to(f32))
    f_gate = torch.sigmoid(cm.dense(cfg, xn, p.wf.w, site="wf").to(f32) + 3.0)
    if state is None:
        state = torch.zeros((b, h, d // h, d // h), dtype=f32, device=x.device)
    y, new_state = mlstm_scan(q, k, v, i_gate, f_gate, state,
                              chunk=min(cfg.attn_chunk, s))
    y = y.reshape(b, s, d).to(x.dtype)
    gate = torch.sigmoid(cm.dense(cfg, xn, p.wo_gate.w, site="wo_gate").to(f32))
    y = (y.to(f32) * gate).to(x.dtype)
    return x + cm.dense(cfg, y, p.wo.w, site="wo").to(x.dtype), new_state


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------


def associative_scan(fn: Callable, elems: Tuple[Tensor, ...]) -> List[Tensor]:
    """Inclusive scan of ``fn`` over axis 0 of every tensor of ``elems``,
    by the recursion of ``jax.lax.associative_scan`` (combine adjacent
    pairs, scan the halves, fill in the even positions, interleave), so that
    each output is the same tree of ``fn`` applications as there and rounds
    the same. ``fn(a, b)`` takes the earlier element first."""
    n = elems[0].shape[0]
    if n < 2:
        return list(elems)
    reduced = fn(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(tuple(odd), tuple(e[2::2] for e in elems))
    even = [torch.cat([e[:1], r]) for e, r in zip(elems, even)]
    out = []
    for ev, od in zip(even, odd):
        full = torch.empty((n,) + tuple(ev.shape[1:]), dtype=ev.dtype,
                           device=ev.device)
        full[0::2], full[1::2] = ev, od
        out.append(full)
    return out


def _compose(e1, e2):
    """(a1, b1) then (a2, b2): the map c ↦ a c + b composed, (a1 a2, a2 b1 + b2)."""
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def slstm_block(cfg: cm.ModelConfig, p: SLSTM, x: Tensor,
                state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    b, s, d = x.shape
    f32 = torch.float32
    xn = cm.rms_norm(x, p.ln)
    z = torch.tanh(cm.dense(cfg, xn, p.wz.w, site="wz").to(f32))
    i = torch.sigmoid(cm.dense(cfg, xn, p.wi.w, site="wi").to(f32))
    f = torch.sigmoid(cm.dense(cfg, xn, p.wf.w, site="wf").to(f32) + 2.0)
    if state is None:
        state = torch.zeros((b, d), dtype=f32, device=x.device)
    a_seq = f.transpose(0, 1)                          # (S, B, d)
    b_seq = (i * z).transpose(0, 1).clone()
    b_seq[0] += a_seq[0] * state                       # fold in the carried state
    _, c_seq = associative_scan(_compose, (a_seq, b_seq))
    c = c_seq.transpose(0, 1)                          # (B, S, d)
    new_state = c_seq[-1]
    o = torch.sigmoid(cm.dense(cfg, xn, p.wo_gate.w, site="wo_gate").to(f32))
    y = (o * torch.tanh(c)).to(x.dtype)
    return x + cm.dense(cfg, y, p.wo.w, site="wo").to(x.dtype), new_state


# ---------------------------------------------------------------------------
# model assembly
# ---------------------------------------------------------------------------


def _kind(i: int) -> str:
    return "m" if i % 2 == 0 else "s"


def _block(i: int):
    """(block function, site segment) of layer ``i``."""
    return (mlstm_block, "mlstm") if _kind(i) == "m" else (slstm_block, "slstm")


def init_params(cfg: cm.ModelConfig, generator: torch.Generator,
                device=None) -> XLSTM:
    """Random parameters drawn from ``generator`` on ``device`` (the
    generator's own device when None), as ``repro`` draws them."""
    device = torch.device(device if device is not None else generator.device)
    layers = [(init_mlstm if _kind(i) == "m" else init_slstm)(generator, cfg, device)
              for i in range(cfg.n_layers)]
    return XLSTM(cm.init_embed(generator, cfg, device), layers)


def _check(cfg: cm.ModelConfig, params: XLSTM) -> None:
    if len(params.layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: params hold {len(params.layers)} "
                         f"layers, the config {cfg.n_layers}")


def forward(cfg: cm.ModelConfig, params: XLSTM, tokens: Tensor) -> Tensor:
    """tokens (B, S) → final hidden states (B, S, d); S a multiple of the
    chunk ``min(attn_chunk, S)``."""
    _check(cfg, params)
    x = cm.embed(cfg, params.embed, tokens)
    for i, layer in enumerate(params.layers):
        block, kind = _block(i)
        with splan.site_scope(f"layer.{i}", kind):
            x = lm._maybe_remat(cfg, lambda xx, layer=layer, block=block:
                                block(cfg, layer, xx)[0])(x)
    return x


def loss_fn(cfg: cm.ModelConfig, params: XLSTM,
            batch: Dict[str, Tensor]) -> Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]``."""
    x = forward(cfg, params, batch["tokens"])
    return cm.lm_loss_chunked(cfg, params.embed, x, batch["labels"])


def init_decode_state(cfg: cm.ModelConfig, batch: int, device=None) -> States:
    """Zeroed per-layer float32 states: (B, H, dh, dh) for mLSTM layers,
    (B, d) for sLSTM layers."""
    d, h = cfg.d_model, cfg.n_heads
    return [torch.zeros((batch, h, d // h, d // h) if _kind(i) == "m"
                        else (batch, d), dtype=torch.float32, device=device)
            for i in range(cfg.n_layers)]


def decode_step(cfg: cm.ModelConfig, params: XLSTM, states: States,
                token: Tensor, cache_len=None) -> Tuple[Tensor, States]:
    """One token (B, 1) through every recurrent block → (logits (B, 1, V)
    float32, the new per-layer states)."""
    _check(cfg, params)
    x = cm.embed(cfg, params.embed, token)
    new_states = []
    for i, (layer, st) in enumerate(zip(params.layers, states)):
        block, kind = _block(i)
        with splan.site_scope(f"layer.{i}", kind):
            x, ns = block(cfg, layer, x, state=st)
        new_states.append(ns)
    return cm.lm_logits(cfg, params.embed, x), new_states


def prefill(cfg: cm.ModelConfig, params: XLSTM, tokens: Tensor) -> Tensor:
    """Last-position logits (B, 1, V) of a full-sequence forward."""
    x = forward(cfg, params, tokens)
    return cm.lm_logits(cfg, params.embed, x[:, -1:, :])
