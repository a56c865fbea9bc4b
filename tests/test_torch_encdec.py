"""The port's encoder-decoder (whisper) against ``repro``'s, on the CPU.

whisper-large-v3 at ``tests/test_models_smoke.py``'s reduced sizes (2
encoder and 2 decoder layers, d_model 64, 16 frames) at float32; ``repro``
draws the parameters from ``PRNGKey(0)`` and
``models.convert.encdec_params_from_jax`` carries them across. ``encode``,
``decode_train``, ``prefill``, two ``decode_step``s (cross-attending to the
encoded frames) and ``loss_fn`` are held to ``LOGIT_ATOL`` under ``exact``,
``int8`` and the approximate substrate (``approx_cuda`` runs its kernels'
plain versions here, the integers of ``repro``'s ``approx_lut``). The
caveat of ``tests/test_torch_models.py``'s header holds here too, and more
often: of the draws ``default_rng(31..44)`` for the prefill / decode /
loss case, five (31, 34, 37, 42, 43) put a decoder activation under
``int8`` within a float32 ulp of a rounding boundary, so that XLA and torch,
a few ulps apart, pick another int8 code and the logits differ by up to
0.09; ``exact`` and ``approx_cuda`` agreed at every draw. Traced at draw
31: fed the same float input, each decoder layer agrees to 1.1e-6. The
case takes draw 32; ``tests/test_torch_blockwise.py`` holds draws 31–44
block by block. The per-site plan reaches the encoder, the decoder's
self and cross attention and its cross K/V projections at ``repro``'s site
names.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jed
from repro.models import registry as jreg
from repro.nn import plan as jplan
from repro_torch.models import convert
from repro_torch.models import encdec
from repro_torch.models import registry as reg
from repro_torch.nn import plan as tplan
from repro_torch.nn import substrate as tsub
from tests.test_models_smoke import reduced
from tests.test_torch_models import LOGIT_ATOL, MODEL_SPECS, port_cfg

ARCH = "whisper-large-v3"


@pytest.fixture(scope="module")
def whisper():
    """(repro config, repro params, port config, port params), float32."""
    jcfg = reduced(ARCH, dtype=jnp.float32)
    jparams = jed.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    return jcfg, jparams, cfg, convert.encdec_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams))


def _inputs(cfg, seed, s=12):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (2, s)), rng.integers(0, cfg.vocab, (2, s)),
            rng.normal(size=(2, cfg.n_frames, cfg.d_model)).astype(np.float32))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)


def test_encode_and_decode_train_match_repro(whisper):
    jcfg, jparams, cfg, params = whisper
    toks, _, frames = _inputs(cfg, 30)
    jenc = jed.encode(jcfg, jparams, jnp.asarray(frames))
    enc = encdec.encode(cfg, params, torch.from_numpy(frames))
    assert enc.shape == (2, cfg.n_frames, cfg.d_model)
    _close(enc.numpy(), jenc)
    _close(encdec.decode_train(cfg, params, torch.from_numpy(toks), enc).numpy(),
           jed.decode_train(jcfg, jparams, jnp.asarray(toks, jnp.int32), jenc))


@pytest.mark.parametrize("spec", sorted(MODEL_SPECS))
def test_prefill_decode_and_loss_match_repro(whisper, spec):
    jcfg, jparams, cfg, params = whisper
    jb = jreg.build_bundle(dataclasses.replace(jcfg, dot_plan=MODEL_SPECS[spec]))
    tb = reg.build_bundle(dataclasses.replace(cfg, dot_plan=spec))
    toks, labels, frames = _inputs(cfg, 32)
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
              "labels": jnp.asarray(labels, jnp.int32), "frames": jnp.asarray(frames)}
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
             "frames": torch.from_numpy(frames)}
    got = tb.prefill(params, batch)
    assert got.shape == (2, 1, cfg.vocab) and bool(torch.isfinite(got).all())
    _close(got.numpy(), jb.prefill(jparams, jbatch))
    _close(float(tb.loss_fn(params, batch)), float(jb.loss_fn(jparams, jbatch)))
    # decode against the encoded frames (the engine's state holds zeros)
    jstate, state = jb.init_decode_state(2, 8), tb.init_decode_state(2, 8)
    assert state["enc_out"].shape == (2, cfg.n_frames, cfg.d_model)
    assert not state["enc_out"].any() and len(state["self_kv"]) == cfg.n_layers
    jstate["enc_out"] = jed.encode(jb.cfg, jparams, jnp.asarray(frames))
    state["enc_out"] = encdec.encode(tb.cfg, params, torch.from_numpy(frames))
    step = jax.jit(jb.decode_step)
    for i in range(2):
        want, jstate = step(jparams, jstate, {
            "token": jnp.asarray(toks[:, i:i + 1], jnp.int32),
            "cache_len": jnp.asarray(i, jnp.int32)})
        got, out = tb.decode_step(params, state, {
            "token": torch.from_numpy(toks[:, i:i + 1]), "cache_len": i})
        assert out is state and got.shape == (2, 1, cfg.vocab)
        _close(got.numpy(), want)
    k0, _ = state["self_kv"][0]
    assert k0[:, :2].abs().sum() > 0 and k0[:, 2:].abs().sum() == 0


def test_sites_match_repro(whisper, monkeypatch):
    """Every contraction of a prefill at its site: ``enc.<i>.{attn,ffn}.w*``,
    ``dec.<i>.self.attn.w*``, ``dec.<i>.cross.w{k,v}``,
    ``dec.<i>.cross.attn.w{q,o}``, ``dec.<i>.ffn.w*``; and a mixed plan over
    them gives ``repro``'s logits."""
    jcfg, jparams, cfg, params = whisper
    seen = []
    orig = tsub.ExactSubstrate.dot_general

    def spy(self, x, w, spec=None):
        seen.append(spec.site)
        return orig(self, x, w, spec)

    monkeypatch.setattr(tsub.ExactSubstrate, "dot_general", spy)
    toks, _, frames = _inputs(cfg, 32, s=4)
    encdec.prefill(cfg, params, torch.from_numpy(toks), torch.from_numpy(frames))
    want = [f"enc.{i}.{b}.{w}" for i in range(2) for b, ws in
            (("attn", "qkvo"), ("ffn", "gio")) for w in (f"w{c}" for c in ws)]
    want += [f"dec.{i}.{s}" for i in range(2) for s in (
        [f"self.attn.w{c}" for c in "qkvo"] + ["cross.wk", "cross.wv"]
        + [f"cross.attn.w{c}" for c in "qo"] + [f"ffn.w{c}" for c in "gio"])]
    assert sorted(seen) == sorted(want)
    monkeypatch.undo()
    rules = (("enc.0.*", "int8"), ("dec.1.cross.*", "approx_bitexact:proposed@8"),
             ("dec.0.self.attn.wq", "int8"))
    jb = jreg.build_bundle(dataclasses.replace(
        jcfg, dot_plan=jplan.SubstratePlan("exact", rules)))
    tb = reg.build_bundle(dataclasses.replace(
        cfg, dot_plan=tplan.SubstratePlan("exact", rules)))
    batch = {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)}
    got = tb.prefill(params, batch)
    _close(got.numpy(), jb.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32),
                                             "frames": jnp.asarray(frames)}))
    exact = reg.build_bundle(cfg).prefill(params, batch)
    assert float((got - exact).abs().max()) > 1e-4  # the rules reached their sites


def test_init_params_shapes_and_param_count(whisper):
    _, _, cfg, _ = whisper
    params = encdec.init_params(cfg, torch.Generator().manual_seed(1))
    assert len(params.enc) == cfg.n_encoder_layers and len(params.dec) == cfg.n_layers
    names = dict(params.named_parameters())
    assert {"dec.0.self.wq.w", "dec.0.cross.wk.w", "enc.1.ffn.wo.w"} <= set(names)
    n = sum(t.numel() for name, t in names.items() if not name.endswith(("ln", "ln_f")))
    # repro counts the decoder's cross attention against the encoder layers
    assert n == cfg.param_count()
    with pytest.raises(ValueError, match="decoder layers"):
        encdec.decode_train(dataclasses.replace(cfg, n_layers=3), params,
                            torch.zeros((1, 2), dtype=torch.int64),
                            torch.zeros((1, 4, cfg.d_model)))
