"""Training the recurrent families in the port against ``repro``'s, on the
CPU.

xlstm-125m (2 layers: mLSTM, sLSTM) and zamba2-1.2b (6 layers, the shared
block after layers 2 and 5: its gradient sums over two places) at
``tests/test_models_smoke.py``'s reduced sizes, float32, ``repro``'s
parameters carried across (``tests/test_torch_xlstm.py::pair``). The cases:

* the sLSTM's :func:`~repro_torch.models.xlstm.associative_scan`: its
  gradient against ``jax.grad`` through ``jax.lax.associative_scan`` (the
  port writes its outputs into slices of a fresh tensor);
* ``loss_fn``'s gradient at every leaf against ``jax.grad`` of ``repro``'s,
  under ``exact`` and under ``approx_lut:proposed@8`` with QAT's
  straight-through backward;
* two ``TrainLoop`` steps with AdamW (``repro``'s launcher's optimizer for
  both families) against ``repro``'s ``TrainLoop``.

Tolerances: the scan's gradient within rtol 1e-6 (the same tree of float32
products and sums, rounded by XLA and torch). ``loss_fn``'s gradients
within 1e-4 of the leaf's largest (the scans' exponentials and cumulative
sums carry the forward's ulps into the backward; measured at draws 0–2:
xlstm within 1.3e-6, zamba within 5.1e-5, at ``a_log`` and ``dt_bias``).
zamba under the quantizing substrate takes ``tests/test_torch_zamba.py``'s
``DRAW`` for its batch: at draws 0 and 1 an activation's int8 code moves
across a rounding boundary between the packages (loss 1.4e-5 relative
apart, gradients up to 12%), the caveat of
``tests/test_torch_models.py``'s header. Training steps: losses within 1e-5
relative, gradient norms within 2e-5 (zamba's second step: 1.05e-5);
parameters within 1e-5 absolute, 1% of the lr of 1e-3, except that AdamW's
first step is ``g / (|g| + 1e-8)`` per element, the sign of a gradient
within the backward's rounding of zero: at most 1e-3 of the elements
(measured: xlstm 1 of 74,176, zamba 30 of 232,584) may differ by more,
each by at most 2 lr a step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro.train import QATPolicy as JPolicy
from repro.train import TrainLoop as JLoop
from repro.train import TrainLoopConfig as JConfig
from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.models import convert, xlstm
from repro_torch.models import registry as reg
from repro_torch.optim import adamw
from repro_torch.train import QATPolicy, TrainLoop, TrainLoopConfig, qat_scope
from tests.test_torch_xlstm import FAMILIES, one_torch_thread, pair  # noqa: F401
from tests.test_torch_zamba import DRAW

ARCHS = ("xlstm-125m", "zamba2-1.2b")


def _batch(vocab, seed=0, b=2, s=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)),
            "labels": rng.integers(0, vocab, (b, s))}


def test_associative_scan_gradient_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.2, 1.0, (11, 3, 5)).astype(np.float32)
    b = rng.normal(size=(11, 3, 5)).astype(np.float32)
    w = rng.normal(size=(11, 3, 5)).astype(np.float32)

    def jloss(a_, b_):
        _, c = jax.lax.associative_scan(
            lambda e1, e2: (e1[0] * e2[0], e2[0] * e1[1] + e2[1]), (a_, b_))
        return jnp.sum(c * w)

    ja, jb_ = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    _, c = xlstm.associative_scan(xlstm._compose, (ta, tb))
    ga, gb = torch.autograd.grad((c * torch.from_numpy(w)).sum(), (ta, tb))
    np.testing.assert_allclose(ga.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jb_), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("spec,qat", [("exact", None),
                                      ("approx_lut:proposed@8", "bitexact")])
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_gradients_match_jax_grad(arch, spec, qat):
    jcfg, jparams, cfg, params = pair(arch)
    jb = jreg.build_bundle(dataclasses.replace(jcfg, dot_plan=spec))
    b = reg.build_bundle(dataclasses.replace(cfg, dot_plan=spec))
    batch = _batch(cfg.vocab, seed=DRAW if (arch, spec) == (
        "zamba2-1.2b", "approx_lut:proposed@8") else 0)
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    if qat is None:
        jloss, jgrads = jax.jit(jax.value_and_grad(jb.loss_fn))(jparams, jbatch)
    else:
        from repro.train import qat as jqat

        def jvg(p, bt):
            with jqat.qat_scope(JPolicy(forward=qat)):
                return jax.value_and_grad(jb.loss_fn)(p, bt)
        jloss, jgrads = jax.jit(jvg)(jparams, jbatch)
    leaves = convert.named_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        with qat_scope(None if qat is None else QATPolicy(forward=qat)):
            loss = b.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()})
            grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    got = b.layout.to_tree(dict(zip(leaves, grads)))
    wl = list(tree_leaves(jax.tree.map(np.asarray, jgrads)))
    gl = list(tree_leaves(got))
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, want), (_, g) in zip(wl, gl):
        assert float(np.abs(want).max()) > 0, path
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_train_steps_match_repro(tmp_path, arch):
    jcfg, jparams, cfg, params = pair(arch)
    params = FAMILIES[jcfg.family][1](cfg, jax.tree.map(np.asarray, jparams))
    jb, b = jreg.build_bundle(jcfg), reg.build_bundle(cfg)
    jloop = JLoop(jb.loss_fn, jadamw(), JConfig(total_steps=2,
                                                ckpt_dir=str(tmp_path / "j")))
    loop = TrainLoop(b.loss_fn, adamw(), TrainLoopConfig(
        total_steps=2, ckpt_dir=str(tmp_path / "t")), layout=b.layout)
    jp, jstate = jparams, jloop.optimizer.init(jparams)
    state = loop.optimizer.init(convert.named_leaves(params))
    for seed in range(2):
        batch = _batch(cfg.vocab, seed=seed)
        jloss, jnorm, jp, jstate = jloop._step_fn(
            jp, jstate, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()},
            jnp.float32(1e-3))
        loss, norm = loop.step(params, state,
                               {k: torch.from_numpy(v) for k, v in batch.items()}, 1e-3)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5), seed
        assert float(norm) == pytest.approx(float(jnorm), rel=2e-5), seed
    got = FAMILIES[jcfg.family][2](cfg, params)
    apart = total = 0
    for (path, want), (_, g) in zip(tree_leaves(jax.tree.map(np.asarray, jp)),
                                    tree_leaves(got)):
        diff = np.abs(np.asarray(g, np.float32) - want)
        assert float(diff.max()) <= 2 * 2 * 1e-3, path
        apart += int((diff > 1e-5).sum())
        total += diff.size
    assert apart <= total // 1000, (apart, total)


def test_mamba_scan_gradient_stays_finite_where_the_masked_decay_overflows():
    """Long, fast-decaying chunks: above the diagonal ``lcum_t - lcum_u``
    passes 88.7, where float32's ``exp`` overflows. ``repro`` exponentiates
    before it masks, so its forward is finite but its gradient takes 0 · inf
    = NaN there (at zamba2-1.2b's published widths this happens at the
    first step: the exponent reached 93.7 on the H100). The port masks
    before it exponentiates: the same forward, a finite gradient, and where
    the decay stays finite the same gradient as ``repro``'s."""
    from repro.models import zamba as jz
    from repro_torch.models import zamba

    rng = np.random.default_rng(4)
    b, s, h, dh, n = 2, 32, 3, 4, 5
    xh = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    bm, cm_ = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    a = -np.exp(rng.normal(size=(h,)) / 4).astype(np.float32)
    state = rng.normal(size=(b, h, dh, n)).astype(np.float32)
    wy = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    for scale, overflows in ((0.5, False), (8.0, True)):
        dt = (scale * rng.uniform(0.5, 1.5, (b, s, h))).astype(np.float32)

        def jloss(dt_, xh_):
            y, st = jz.mamba_scan(xh_, dt_, jnp.asarray(bm), jnp.asarray(cm_),
                                  jnp.asarray(a), jnp.asarray(state), chunk=s)
            return jnp.sum(y * wy) + jnp.sum(st)

        jy, _ = jz.mamba_scan(jnp.asarray(xh), jnp.asarray(dt), jnp.asarray(bm),
                              jnp.asarray(cm_), jnp.asarray(a), jnp.asarray(state), s)
        jg = [np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1))(
            jnp.asarray(dt), jnp.asarray(xh))]
        tdt, txh = (torch.from_numpy(v).requires_grad_() for v in (dt, xh))
        ty, tst = zamba.mamba_scan(txh, tdt, torch.from_numpy(bm), torch.from_numpy(cm_),
                                   torch.from_numpy(a), torch.from_numpy(state), s)
        tg = torch.autograd.grad((ty * torch.from_numpy(wy)).sum() + tst.sum(),
                                 (tdt, txh))
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        assert all(bool(torch.isfinite(g).all()) for g in tg)
        assert any(np.isnan(g).any() for g in jg) == overflows
        if not overflows:
            for g, want in zip(tg, jg):
                np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                           atol=1e-4 * float(np.abs(want).max()))
