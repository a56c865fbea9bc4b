"""Whole-model parity block by block, at the draws that a whole-model case
cannot hold (ROADMAP.md, fault F1), on the CPU.

Under a quantizing substrate (``int8``, the approximate products) an
activation within a float32 ulp of an int8 rounding boundary can take
neighbouring codes in ``repro`` and in the port, whose float ops round a
few ulps apart; one code moves and the logits differ by up to 0.1. So the
whole-model cases take fixed draws (``tests/test_torch_models.py``,
``test_torch_encdec.py``, ``test_torch_xlstm.py``, ``test_torch_zamba.py``,
each saying which). The cases here hold the draws those skip, block by
block, with the same inputs as the whole-model case of that draw:

* each block (a decoder layer with its KV cache, whisper's encoder and
  decoder layers, a mamba layer with its SSM and conv state, zamba's shared
  block with its KV cache, the patch projection, the LM head, the loss) is
  fed ``repro``'s own float input and state, and its outputs are held to
  ``LOGIT_ATOL`` against ``repro``'s (the block under ``jax.jit``, compiled
  once per block and shape in this module; the port's approximate blocks
  on ``PORT_SPEC``);
* where they differ, the block runs again on both sides, ``repro``'s
  eagerly (as its float ops round outside ``jit``), with the float
  activation of every ``dense`` recorded. The port's ``dense`` (under the
  spec itself) on each of ``repro``'s recorded inputs must give
  ``repro``'s output bit for bit.
  Then either every int8 code is equal and the outputs are within
  ``LOGIT_ATOL`` of ``repro``'s eager ones, or, at the first ``dense`` whose
  codes differ, every differing code lies within one float32 ulp (at the top
  of the code range, ``ULP``) of a rounding boundary on both sides (the
  codes one apart); what follows that ``dense`` in the block follows from
  the moved code and is not held.

Here: whisper's draws 31–44 and zamba's 0–5 but its own; the lm families'
draws 20–31 in ``tests/test_torch_blockwise_lm.py``. xlstm's whole-model
case holds at its draw under every substrate and skips none.

Each case asserts nothing looser than the file it covers: the same
``LOGIT_ATOL``, and no tolerance at all on a quantizing ``dense``.
"""
import contextlib
import dataclasses
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro.models import encdec as jed
from repro.models import zamba as jz
from repro.nn import plan as jplan
from repro.nn import substrate as jsub
from repro_torch.models import common as cm
from repro_torch.models import convert
from repro_torch.models import encdec, zamba
from repro_torch.nn import plan as tplan
from repro_torch.nn import quant
from repro_torch.nn import substrate as tsub
from tests.test_models_smoke import reduced
from tests.test_torch_models import LOGIT_ATOL, MODEL_SPECS, port_cfg
from tests.test_torch_xlstm import one_torch_thread  # noqa: F401 (the module's fixture)
from tests.test_torch_xlstm import PORT_SPEC, once
from tests.test_torch_xlstm import pair as rec_pair

#: how far from a rounding boundary (k + 1/2, in code units) the values of
#: a code that differs may lie, on either side, in float32 ulps at the top
#: of the int8 code range (``ULP``: 2^-17, the spacing at 127; the values
#: of one activation share a scale, so their rounding errors are absolute
#: at its range). Measured: 0.19 to 1.0 at every moved code of these cases.
BOUNDARY_ULPS = 1
ULP = float(np.spacing(np.float32(127)))
EPS = tsub.QuantPolicy().eps
_JITTED: dict = {}


def _np(tree):
    """A block's outputs (tensors, jax arrays, ints; nested in tuples,
    lists, dicts) as float32 numpy copies."""
    if isinstance(tree, (list, tuple)):
        return [_np(t) for t in tree]
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in sorted(tree.items())}
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.detach().float().numpy().copy()
    return np.array(tree, np.float32)


def _close(got, want) -> bool:
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    return len(g) == len(w) and all(
        a.shape == b.shape and np.allclose(a, b, atol=LOGIT_ATOL, rtol=0)
        for a, b in zip(g, w))


@contextlib.contextmanager
def _repro_recording():
    """Record the (site, x, w, b, output) of every ``dense`` ``repro``
    calls, run eagerly (as float32 numpy). The table substrate's integer
    contraction runs compiled: its int32 sums are the same either way, and
    eagerly its slab loop dominates the block."""
    rec = []
    jdense, dot_int = jcm.dense, jsub.LutSubstrate.dot_int

    def jrec(cfg, x, w, b=None, *, site=None):
        out = jdense(cfg, x, w, b, site=site)
        rec.append((site, *(None if a is None else np.array(a, np.float32)
                            for a in (x, w, b, out))))
        return out

    def compiled_dot_int(self, a, b):
        key = ("dot_int", self.meta.spec)
        if key not in _JITTED:
            _JITTED[key] = jax.jit(lambda a_, b_: dot_int(self, a_, b_))
        return _JITTED[key](a, b)

    with mock.patch.object(jcm, "dense", jrec), \
            mock.patch.object(jsub.LutSubstrate, "dot_int", compiled_dot_int):
        yield rec


@contextlib.contextmanager
def _port_recording():
    """Record the (site, x) of every ``dense`` the port calls."""
    rec = []
    tdense = cm.dense

    def trec(cfg, x, w, b=None, *, site=None):
        rec.append((site, x.detach().float().numpy().copy()))
        return tdense(cfg, x, w, b, site=site)

    with mock.patch.object(cm, "dense", trec):
        yield rec


def _codes(x: np.ndarray):
    """The int8 codes of a ``dense`` activation (per-tensor scale, as
    ``dot_general`` quantizes it) and the values they round, in code units."""
    t = torch.from_numpy(x).reshape(1, -1, x.shape[-1])
    q = quant.quantize(t, axes=None, bits=8, eps=EPS)
    return (q.values.numpy().astype(np.int64).ravel(),
            (t / q.scale).numpy().astype(np.float64).ravel())


class Walk:
    """One draw of one model, block by block (see the module docstring)."""

    def __init__(self, key, jcfg, cfg, spec):
        """``jcfg`` / ``cfg``: the configs without a plan; ``spec`` a key of
        ``MODEL_SPECS``. The walk's blocks read ``self.jcfg`` / ``self.cfg``."""
        self.key, self.spec = key, spec
        self.jcfg = dataclasses.replace(jcfg, dot_plan=MODEL_SPECS[spec])
        self.cfg = dataclasses.replace(cfg, dot_plan=PORT_SPEC.get(spec, spec))
        self.flips = []  # (block, site, codes moved, most ULPs from the boundary)

    def block(self, name, jfn, jp, tfn, *args):
        """Feed ``repro``'s float inputs ``args`` (numpy arrays, or ints
        for a cache length) to ``jfn(jp, *args)`` (jitted; ``repro``'s
        params ``jp`` an argument, never a constant XLA would fold) and
        ``tfn(*args)``; returns ``repro``'s outputs as numpy."""
        jargs = [jnp.asarray(a, jnp.int32) if isinstance(a, int) else jnp.asarray(a)
                 for a in args]
        # fresh tensors for each run: the port writes KV caches in place
        targs = lambda: [a if isinstance(a, int) else torch.from_numpy(np.array(a))
                         for a in args]
        key = self.key + (name,)
        if key not in _JITTED:
            _JITTED[key] = jax.jit(jfn)
        want = _np(_JITTED[key](jp, *jargs))
        got = _np(tfn(*targs()))
        if _close(got, want):
            return want
        with _repro_recording() as rec_j:
            want_eager = _np(jfn(jp, *jargs))
        with _port_recording() as rec_t:
            got = _np(tfn(*targs()))
        self._check_dense(name, rec_j, rec_t)
        if not self._first_moved(name, rec_j, rec_t):
            assert _close(got, want_eager), f"{name}: outputs differ, codes equal"
        return want

    def _check_dense(self, name, rec_j, rec_t):
        """The same sites in the same order; the port's ``dense`` (under the
        spec itself) on each of ``repro``'s inputs gives ``repro``'s output
        bit for bit (float32 matmuls under ``exact``: to 1e-5)."""
        assert [r[0] for r in rec_j] == [r[0] for r in rec_t], name
        cfg = dataclasses.replace(self.cfg, dot_plan=self.spec)
        for site, x, w, b, out in rec_j:
            got = cm.dense(cfg, torch.from_numpy(x), torch.from_numpy(w),
                           None if b is None else torch.from_numpy(b), site=site)
            np.testing.assert_allclose(got.numpy(), out, err_msg=f"{name} {site}",
                                       atol=1e-5 if self.spec == "exact" else 0,
                                       rtol=0)

    def _first_moved(self, name, rec_j, rec_t) -> int:
        """Codes moved at the first ``dense`` whose codes differ, each
        asserted to sit at a rounding boundary; 0 if none differ."""
        for (site, xj, *_), (_, xt) in zip(rec_j, rec_t):
            cj, vj = _codes(xj)
            ct, vt = _codes(xt)
            d = cj != ct
            if not d.any():
                continue
            b = (cj[d] + ct[d]) / 2
            assert (np.abs(cj[d] - ct[d]) == 1).all(), f"{name} {site}"
            far = np.maximum(np.abs(vj[d] - b), np.abs(vt[d] - b)) / ULP
            self.flips.append((name, site, int(d.sum()), float(far.max())))
            assert (far <= BOUNDARY_ULPS).all(), \
                f"{name} {site}: codes moved {far.max():.2f} ulps from a boundary"
            return int(d.sum())
        return 0


# ---------------------------------------------------------------------------
# helpers of the walks
# ---------------------------------------------------------------------------


def _positions(s):
    return (jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (2, s)),
            torch.arange(s).expand(2, s))


def _head_and_loss(w, jcfg, jemb, cfg, temb, x, labels):
    w.block("logits", lambda e, xx: jcm.lm_logits(jcfg, e, xx[:, -1:]), jemb,
            lambda xx: cm.lm_logits(cfg, temb, xx[:, -1:]), x)
    w.block("loss", lambda e, xx, ll: jcm.lm_loss_chunked(jcfg, e, xx, ll), jemb,
            lambda xx, ll: cm.lm_loss_chunked(cfg, temb, xx, ll), x, labels)


def _step_positions():
    return (lambda nn_: jnp.broadcast_to(nn_, (2, 1)).astype(jnp.int32),
            lambda nn_: torch.full((2, 1), nn_, dtype=torch.int64))


# ---------------------------------------------------------------------------
# the encoder-decoder: tests/test_torch_encdec.py's prefill / decode / loss
# ---------------------------------------------------------------------------


def _whisper():
    jcfg = reduced("whisper-large-v3", dtype=jnp.float32)
    jparams = jed.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    return jcfg, jparams, cfg, convert.encdec_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams))


def _jdec_layer(jcfg, p, x, positions, enc, kv_cache=None, cache_len=None):
    """The body of ``repro``'s decoder scans (``decode_train``,
    ``decode_step``), one layer."""
    with jplan.site_scope("self"):
        y, nkv = jcm.attn_block(jcfg, p["self"], x, positions=positions,
                                kv_cache=kv_cache, cache_len=cache_len)
    be, se, _ = enc.shape
    with jplan.site_scope("cross"):
        ck = jcm.dense(jcfg, enc, p["cross"]["wk"]["w"], site="wk").reshape(
            be, se, jcfg.n_kv_heads, jcfg.dh)
        cv = jcm.dense(jcfg, enc, p["cross"]["wv"]["w"], site="wv").reshape(
            be, se, jcfg.n_kv_heads, jcfg.dh)
        y, _ = jcm.attn_block(jcfg, p["cross"], y, positions=positions,
                              cross_kv=(ck, cv))
    return jcm.ffn_block(jcfg, p["ffn"], y), nkv


def encdec_walk(spec, draw):
    """The draw's ``_inputs(cfg, draw)``: encoder, decoder (12 tokens), loss,
    and two decode steps against the encoded frames, block by block."""
    jcfg, jparams, cfg, params = once(("whisper",), _whisper)
    w = Walk(("encdec", spec), jcfg, cfg, spec)
    jcfg, cfg = w.jcfg, w.cfg
    rng = np.random.default_rng(draw)
    toks = rng.integers(0, cfg.vocab, (2, 12))
    labels = rng.integers(0, cfg.vocab, (2, 12))
    frames = rng.normal(size=(2, cfg.n_frames, cfg.d_model)).astype(np.float32)
    layer_of = lambda part, i: jax.tree.map(lambda a: a[i], jparams[part])
    jpos, tpos = _positions(cfg.n_frames)
    enc = frames
    for i in range(cfg.n_encoder_layers):
        p_i, layer = layer_of("enc", i), params.enc[i]

        def jf(p_, xx, i=i):
            with jplan.site_scope(f"enc.{i}"):
                y, _ = jcm.attn_block(jcfg, p_["attn"], xx, positions=jpos,
                                      causal=False)
                return jcm.ffn_block(jcfg, p_["ffn"], y)

        def tf(xx, layer=layer, i=i):
            with tplan.site_scope(f"enc.{i}"):
                return encdec._enc_layer(cfg, layer, xx, tpos)
        enc = w.block(f"enc.{i}", jf, p_i, tf, enc)
    jemb = jparams["embed"]
    x = np.asarray(jcm.embed(jcfg, jemb, jnp.asarray(toks, jnp.int32)))
    jpos, tpos = _positions(x.shape[1])
    for i in range(cfg.n_layers):
        p_i, layer = layer_of("dec", i), params.dec[i]

        def jf(p_, xx, ee, i=i):
            with jplan.site_scope(f"dec.{i}"):
                return _jdec_layer(jcfg, p_, xx, jpos, ee)[0]

        def tf(xx, ee, layer=layer, i=i):
            with tplan.site_scope(f"dec.{i}"):
                return encdec._dec_layer(cfg, layer, xx, tpos, ee)[0]
        x = w.block(f"dec.{i}", jf, p_i, tf, x, enc)
    _head_and_loss(w, jcfg, jemb, cfg, params.embed, x, labels)
    jn, tn = _step_positions()
    kv = [(np.zeros((2, 8, cfg.n_kv_heads, cfg.dh), np.float32),) * 2
          for _ in range(cfg.n_layers)]
    for step in range(2):
        x = np.asarray(jcm.embed(jcfg, jemb, jnp.asarray(toks[:, step:step + 1],
                                                          jnp.int32)))
        for i in range(cfg.n_layers):
            p_i, layer = layer_of("dec", i), params.dec[i]

            def jf(p_, xx, k, v, ee, n, i=i):
                with jplan.site_scope(f"dec.{i}"):
                    return _jdec_layer(jcfg, p_, xx, jn(n), ee, kv_cache=(k, v),
                                       cache_len=n)

            def tf(xx, k, v, ee, n, layer=layer, i=i):
                with tplan.site_scope(f"dec.{i}"):
                    return encdec._dec_layer(cfg, layer, xx, tn(n), ee,
                                             kv_cache=(k, v), cache_len=n)
            x, kv[i] = w.block(f"step.dec.{i}", jf, p_i, tf, x, *kv[i], enc, step)
        w.block("logits", lambda e, xx: jcm.lm_logits(jcfg, e, xx), jemb,
                lambda xx: cm.lm_logits(cfg, params.embed, xx), x)
    return w


@pytest.mark.parametrize("draw", range(31, 45))
@pytest.mark.parametrize("spec", sorted(MODEL_SPECS))
def test_encdec_draws_block_by_block(spec, draw):
    """Draws 31–44 of ``tests/test_torch_encdec.py``'s prefill / decode /
    loss case (which takes draw 32)."""
    encdec_walk(spec, draw)


# ---------------------------------------------------------------------------
# zamba: tests/test_torch_zamba.py's prefill / decode / loss
# ---------------------------------------------------------------------------


def zamba_walk(spec, draw):
    """The draw's prefill (2 × 16 tokens), loss and three decode steps from
    zero states, as ``run_once("zamba2-1.2b", spec, draw)``, block by block:
    each mamba layer with its SSM and conv state, the shared block with its
    place's KV cache."""
    jcfg, jparams, cfg, params = rec_pair("zamba2-1.2b")
    w = Walk(("zamba", spec), jcfg, cfg, spec)
    jcfg, cfg = w.jcfg, w.cfg
    rng = np.random.default_rng(draw)
    toks = rng.integers(0, cfg.vocab, (2, 16))
    labels = rng.integers(0, cfg.vocab, (2, 16))
    jemb, shared_at = jparams["embed"], zamba._shared_positions(cfg)
    jn, tn = _step_positions()

    def jmamba(p_, xx, *st, i=0):
        with jplan.site_scope(f"layer.{i}", "mamba"):
            return jz.mamba_block(jcfg, p_, xx, *st)

    def jshared(p_, xx, *kv_n):
        kv, n = (kv_n[:2], kv_n[2]) if kv_n else (None, None)
        positions = jn(n) if kv_n else _positions(xx.shape[1])[0]
        with jplan.site_scope("shared"):
            y, nkv = jcm.attn_block(jcfg, p_["attn"], xx, positions=positions,
                                    kv_cache=kv, cache_len=n)
            return jcm.ffn_block(jcfg, p_["ffn"], y), nkv

    def tmamba(xx, *st, i=0):
        with tplan.site_scope(f"layer.{i}", "mamba"):
            return zamba.mamba_block(cfg, params.mamba[i], xx, *st)

    def tshared(xx, *kv_n):
        if kv_n:
            return zamba._shared_block(cfg, params.shared, xx, tn(kv_n[2]),
                                       kv_cache=kv_n[:2], cache_len=kv_n[2])
        return zamba._shared_block(cfg, params.shared, xx,
                                   _positions(xx.shape[1])[1])

    def run(x, mamba_st=None, kv=None, step=None):
        """All blocks over ``x``; with states, a decode step updating them."""
        tag = "fwd" if step is None else "step"
        for i in range(cfg.n_layers):
            st = [] if mamba_st is None else list(mamba_st[i])
            x, new = w.block(f"{tag}.layer.{i}", partial(jmamba, i=i),
                             jparams["mamba"][i], partial(tmamba, i=i), x, *st)
            if mamba_st is not None:
                mamba_st[i] = new
            if i in shared_at:
                j = shared_at.index(i)
                extra = [] if kv is None else [*kv[j], step]
                x, new = w.block(f"{tag}.shared.{i}", jshared, jparams["shared"],
                                 tshared, x, *extra)
                if kv is not None:
                    kv[j] = new
        return x

    x = run(np.asarray(jcm.embed(jcfg, jemb, jnp.asarray(toks, jnp.int32))))
    _head_and_loss(w, jcfg, jemb, cfg, params.embed, x, labels)
    h, di = cfg.n_heads, 2 * cfg.d_model
    mamba_st = [(np.zeros((2, h, di // h, cfg.ssm_state), np.float32),
                 np.zeros((2, cfg.conv_width - 1, di), np.float32))
                for _ in range(cfg.n_layers)]
    kv = [(np.zeros((2, 8, cfg.n_kv_heads, cfg.dh), np.float32),) * 2
          for _ in shared_at]
    for step in range(3):
        tok = jnp.asarray(toks[:, step:step + 1], jnp.int32)
        x = run(np.asarray(jcm.embed(jcfg, jemb, tok)), mamba_st, kv, step)
        w.block("logits", lambda e, xx: jcm.lm_logits(jcfg, e, xx), jemb,
                lambda xx: cm.lm_logits(cfg, params.embed, xx), x)
    return w


@pytest.mark.parametrize("draw", [0, 1, 3, 4, 5])
@pytest.mark.parametrize("spec", sorted(MODEL_SPECS))
def test_zamba_draws_block_by_block(spec, draw):
    """Draws 0–5 of ``tests/test_torch_zamba.py``'s
    ``test_prefill_decode_and_loss_match_repro`` but its own (2)."""
    once(("zamba_walk", spec, draw), lambda: zamba_walk(spec, draw))


def test_a_moved_code_is_found_at_its_boundary():
    """The fallback finds what it claims: zamba at draw 1 under the
    approximate substrate (whole-model logits 0.12 apart) moves one code in
    the shared block's ``wg`` at the prefill and one in layer 4's
    ``in_proj`` at a decode step, each off its rounding boundary by more
    than nothing and at most ``BOUNDARY_ULPS``."""
    spec = "approx_cuda:proposed@8"
    w = once(("zamba_walk", spec, 1), lambda: zamba_walk(spec, 1))
    assert [(b, s_, n) for b, s_, n, _ in w.flips] == [("fwd.shared.2", "wg", 1),
                                                       ("step.layer.4", "in_proj", 1)]
    assert all(0 < far <= BOUNDARY_ULPS for *_, far in w.flips)
