"""The port's approximation-aware training (QAT) against ``repro``'s, on the
CPU.

The cases mirror ``tests/test_qat.py``'s and hold the port to ``repro`` on
the same numpy inputs:

* the STE forward is bit-identical to ``repro``'s under ``int8``,
  ``approx_bitexact``, ``approx_lut`` and ``approx_stat`` (the same
  quantization codes, integer sums and float32 rescale), and to the port's
  own substrate; under ``exact`` it is a float32 matmul, bit-identical where
  every sum is exact (integer-valued operands) and within 1e-6 otherwise;
* the STE backward is the float32 VJP of ``x @ w``: bit-identical to the
  port's own float gradient, within 1e-5 of ``repro``'s (XLA and torch sum
  the same products in another order), the moment correction included;
* the edge model's maps are bit-identical at init, and ``finetune_edge``'s
  losses and PSNRs follow ``repro``'s within 1e-4 relative.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro.models import registry as jreg
from repro.nn import plan as jplan
from repro.nn import substrate as jsub
from repro.train import QATPolicy as JPolicy
from repro.train import qat as jqat
from repro_torch.data import image_batch
from repro_torch.models import common as cm
from repro_torch.models import registry as reg
from repro_torch.nn import conv
from repro_torch.nn import plan as splan
from repro_torch.nn import substrate as psub
from repro_torch.train import QATPolicy, qat

RNG = np.random.default_rng(0)


def _ops(m=4, k=8, n=5, integer=False):
    if integer:
        return (RNG.integers(-6, 7, (m, k)).astype(np.float32),
                RNG.integers(-6, 7, (k, n)).astype(np.float32))
    return (RNG.normal(size=(m, k)).astype(np.float32),
            RNG.normal(size=(k, n)).astype(np.float32))


def _cspecs():
    return (jsub.ContractionSpec.matmul(quant=jsub.QuantPolicy()),
            psub.ContractionSpec.matmul(quant=psub.QuantPolicy()))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# STE: forward bitwise, backward == the float VJP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["int8", "approx_bitexact:proposed@8",
                                  "approx_bitexact:design_du2022@6",
                                  "approx_lut:proposed@7", "approx_stat:proposed@8",
                                  "approx_cuda:csp_axc1@6"])
def test_forward_bitwise_equals_repro_and_substrate(spec):
    x, w = _ops()
    jcs, tcs = _cspecs()
    jspec = spec.replace("approx_cuda", "approx_bitexact")  # repro's twin
    want = np.asarray(jqat.qat_dot_general(jnp.asarray(x), jnp.asarray(w), jspec, jcs))
    got = qat.qat_dot_general(_t(x, True), _t(w, True), spec, tcs)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(
        got.detach().numpy(),
        psub.get_substrate(spec).dot_general(_t(x), _t(w), tcs).numpy())


def test_exact_forward_passes_through_natively():
    jcs, tcs = _cspecs()
    x, w = _ops(integer=True)  # exact float sums: the same bits in any order
    got = qat.qat_dot_general(_t(x, True), _t(w), "exact", tcs)
    want = jqat.qat_dot_general(jnp.asarray(x), jnp.asarray(w), "exact", jcs)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    x, w = _ops()
    got = qat.qat_dot_general(_t(x, True), _t(w), "exact", tcs)
    want = jqat.qat_dot_general(jnp.asarray(x), jnp.asarray(w), "exact", jcs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert "StraightThrough" not in type(got.grad_fn).__name__
    xt = _t(x, True)
    (g,) = torch.autograd.grad((qat.qat_dot_general(xt, _t(w), "exact", tcs) ** 2).sum(),
                               (xt,))
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


@pytest.mark.parametrize("moment", [False, True])
@pytest.mark.parametrize("spec", ["approx_bitexact:proposed@8",
                                  "approx_bitexact:proposed@6", "int8",
                                  "approx_lut:csp_axc1@6"])
def test_backward_equals_float_vjp_and_repro(spec, moment):
    x, w = _ops()
    g = RNG.normal(size=(4, 5)).astype(np.float32)
    jcs, tcs = _cspecs()
    jpol, tpol = JPolicy(moment_correction=moment), QATPolicy(moment_correction=moment)
    jd = jax.grad(lambda a, b: (jqat.qat_dot_general(a, b, spec, jcs, jpol) * g).sum(),
                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x, True), _t(w, True)
    td = torch.autograd.grad(qat.qat_dot_general(xt, wt, spec, tcs, tpol), (xt, wt),
                             _t(g))
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    if not moment:  # the port's own float product's gradient, bit for bit
        xf, wf = _t(x, True), _t(w, True)
        fd = torch.autograd.grad(psub.get_substrate("exact").dot_general(xf, wf, tcs),
                                 (xf, wf), _t(g))
        for a, b in zip(td, fd):
            assert torch.equal(a, b)


def test_backward_under_general_dimension_numbers():
    """A batched, transposed contraction: dims ((1,), (2,)), ((0,), (0,))."""
    x = RNG.normal(size=(3, 6, 4)).astype(np.float32)   # (B, K, M)
    w = RNG.normal(size=(3, 5, 6)).astype(np.float32)   # (B, N, K)
    dims = (((1,), (2,)), ((0,), (0,)))
    jcs = jsub.ContractionSpec(dims, quant=jsub.QuantPolicy())
    tcs = psub.ContractionSpec(dims, quant=psub.QuantPolicy())
    spec = "approx_bitexact:proposed@6"
    pol, jpol = QATPolicy(moment_correction=True), JPolicy(moment_correction=True)
    g = RNG.normal(size=(3, 4, 5)).astype(np.float32)
    jout = jqat.qat_dot_general(jnp.asarray(x), jnp.asarray(w), spec, jcs, jpol)
    jd = jax.grad(lambda a, b: (jqat.qat_dot_general(a, b, spec, jcs, jpol) * g).sum(),
                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x, True), _t(w, True)
    out = qat.qat_dot_general(xt, wt, spec, tcs, pol)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    td = torch.autograd.grad(out, (xt, wt), _t(g))
    for a, b in zip(td, jd):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_backward_keeps_the_operand_dtype():
    x, w = _ops()
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    wt = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    out = qat.qat_dot_general(xt, wt, "approx_bitexact:proposed@8", _cspecs()[1],
                              QATPolicy(moment_correction=True))
    dx, dw = torch.autograd.grad(out.float().sum(), (xt, wt))
    assert out.dtype == dx.dtype == dw.dtype == torch.bfloat16


def test_finite_difference_sanity_dense_layer():
    """STE gradient ≈ FD of the float surrogate; a step lowers the QAT loss."""
    x, w = _ops(3, 6, 4)
    cs = _cspecs()[1]
    target = _t(RNG.normal(size=(3, 4)).astype(np.float32))
    spec = "approx_bitexact:proposed@8"

    def qat_loss(wf):
        return torch.mean((qat.qat_dot_general(_t(x), wf, spec, cs) - target) ** 2)

    def float_loss(wf):
        return float(torch.mean((_t(x) @ wf - target) ** 2))

    wt = _t(w, True)
    (g,) = torch.autograd.grad(qat_loss(wt), (wt,))
    eps = 1e-2
    for idx in [(0, 0), (2, 1), (5, 3)]:
        d = torch.zeros(w.shape)
        d[idx] = eps
        fd = (float_loss(_t(w) + d) - float_loss(_t(w) - d)) / (2 * eps)
        assert abs(float(g[idx]) - fd) <= 0.35 * max(abs(fd), 0.05), (idx, g[idx], fd)
    with torch.no_grad():
        assert float(qat_loss(_t(w) - 0.05 * g)) < float(qat_loss(_t(w)))


def test_quantless_contraction_rejected():
    x, w = _ops()
    with pytest.raises(ValueError, match="QuantPolicy"):
        qat.qat_dot_general(_t(x), _t(w), "approx_bitexact:proposed@8",
                            psub.ContractionSpec.matmul())


def test_policy_validation_and_stat_rewrite():
    with pytest.raises(ValueError, match="forward"):
        QATPolicy(forward="nope")
    pol = QATPolicy(forward="stat")
    assert pol.forward_spec("approx_bitexact:proposed@6") == "approx_stat:proposed@6"
    assert pol.forward_spec("approx_cuda:proposed@6") == "approx_stat:proposed@6"
    assert pol.forward_spec("exact") == "exact"
    assert QATPolicy.from_dict(pol.describe()) == pol
    assert pol.describe() == JPolicy(forward="stat").describe()
    assert JPolicy.from_dict(QATPolicy(moment_correction=True).describe()) == \
        JPolicy(moment_correction=True)


def test_moment_correction_changes_approx_grads():
    x, w = _ops()
    cs = _cspecs()[1]

    def grads(pol):
        xt, wt = _t(x, True), _t(w, True)
        out = qat.qat_dot_general(xt, wt, "approx_bitexact:proposed@6", cs, pol)
        return torch.autograd.grad((out ** 2).sum(), (xt, wt))

    plain, corrected = grads(QATPolicy()), grads(QATPolicy(moment_correction=True))
    assert all(torch.isfinite(c).all() for c in corrected)
    assert any(float((p - c).abs().max()) > 0 for p, c in zip(plain, corrected))


# ---------------------------------------------------------------------------
# the scopes: plan override and qat_scope through dense
# ---------------------------------------------------------------------------


def _tiny_cfg(**kw):
    return reg.get_config("minitron-8b", n_layers=2, d_model=32, d_ff=64,
                          vocab=64, n_heads=2, n_kv_heads=2, dtype=torch.float32, **kw)


def test_plan_override_scope_governs_dense_numerics():
    cfg = _tiny_cfg()  # exact numerics
    plan = splan.SubstratePlan.uniform("approx_bitexact:proposed@6")
    x = _t(RNG.normal(size=(2, 8, 32)).astype(np.float32))
    w = _t(RNG.normal(size=(32, 32)).astype(np.float32))
    exact = cm.dense(cfg, x, w, site="proj")
    with splan.plan_override_scope(plan):
        overridden = cm.dense(cfg, x, w, site="proj")
    assert splan.current_plan_override() is None
    assert torch.equal(overridden, cm.dense(_tiny_cfg(dot_plan=plan), x, w, site="proj"))
    assert float((overridden - exact).abs().max()) > 0


def test_qat_scope_forward_values_match_unscoped_dense_and_repro():
    """The scope changes gradients, never values; and repro's scoped dense
    gives the same bits."""
    mixed = {"version": 1, "default": "approx_bitexact:proposed@8",
             "rules": [{"site": "layer.1.*", "spec": "approx_bitexact:design_du2022@6"}]}
    cfg = _tiny_cfg(dot_plan=splan.as_plan(mixed))
    x = RNG.normal(size=(2, 8, 32)).astype(np.float32)
    w = RNG.normal(size=(32, 32)).astype(np.float32)
    with splan.site_scope("layer.1"):
        ref = cm.dense(cfg, _t(x), _t(w), site="proj")
        with qat.qat_scope(QATPolicy()):
            wt = _t(w, True)
            out = cm.dense(cfg, _t(x), wt, site="proj")
    assert psub.current_dot_override() is None
    assert torch.equal(out.detach(), ref) and out.grad_fn is not None
    jcfg = jreg.get_config("minitron-8b", n_layers=2, d_model=32, d_ff=64, vocab=64,
                           n_heads=2, n_kv_heads=2, dtype=jnp.float32,
                           dot_plan=jplan.as_plan(mixed))
    with jplan.site_scope("layer.1"), jqat.qat_scope(JPolicy()):
        want = jcm.dense(jcfg, jnp.asarray(x), jnp.asarray(w), site="proj")
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))


def test_scopes_are_thread_local():
    seen = {}
    with qat.qat_scope(QATPolicy()), splan.site_scope("layer.0"):
        t = threading.Thread(target=lambda: seen.update(
            override=psub.current_dot_override(), sites=splan.current_site_stack()))
        t.start()
        t.join()
        assert psub.current_dot_override() is not None
    assert seen == {"override": None, "sites": ()}


# ---------------------------------------------------------------------------
# the edge model: init parity, width contract, recovery against repro
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [6, 8])
def test_edge_model_init_bitwise_matches_planned_pipeline(width):
    imgs = RNG.integers(0, 256, size=(3, 16, 16)).astype(np.uint8)
    spec = f"approx_bitexact:proposed@{width}"
    maps = qat.edge_maps(qat.init_edge_params(), torch.from_numpy(imgs), spec)
    assert maps.dtype == torch.uint8
    np.testing.assert_array_equal(
        maps.numpy(), conv.edge_detect_planned(torch.from_numpy(imgs), spec).numpy())
    np.testing.assert_array_equal(maps.numpy(), np.asarray(jqat.edge_maps(
        jqat.init_edge_params(), jnp.asarray(imgs), jplan.as_plan(spec))))


def test_edge_model_rejects_sub_clip_widths():
    imgs = torch.from_numpy(RNG.integers(0, 256, size=(1, 8, 8)).astype(np.uint8))
    with pytest.raises(ValueError, match="widths"):
        qat.edge_response(qat.init_edge_params(), imgs, "approx_bitexact:proposed@4")


def test_edge_response_and_grads_match_repro():
    imgs = RNG.integers(0, 256, size=(2, 12, 12)).astype(np.uint8)
    plan = {"version": 1, "default": "approx_bitexact:proposed@8",
            "rules": [{"site": "conv.edge.center", "spec": "approx_lut:exact"},
                      {"site": "conv.edge.ring", "spec": "approx_bitexact:csp_axc1@6"}]}
    jp = {"kernel": jnp.asarray(conv.LAPLACIAN, jnp.float32) * 1.1,
          "gain": jnp.float32(0.9), "bias": jnp.float32(3.0)}
    tp = {k: _t(np.asarray(v), True) for k, v in jp.items()}
    jtarget = jqat.edge_reference_response(jnp.asarray(imgs))
    ttarget = qat.edge_reference_response(torch.from_numpy(imgs))
    np.testing.assert_array_equal(ttarget.numpy(), np.asarray(jtarget))

    def jloss(p):
        return jnp.mean((jqat.edge_response(p, jnp.asarray(imgs), jplan.as_plan(plan))
                         - jtarget) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jp)
    resp = qat.edge_response(tp, torch.from_numpy(imgs), plan)
    np.testing.assert_array_equal(resp.detach().numpy(), np.asarray(
        jqat.edge_response(jp, jnp.asarray(imgs), jplan.as_plan(plan))))
    tl = torch.mean((resp - ttarget) ** 2)
    tg = torch.autograd.grad(tl, list(tp.values()))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-6)
    for k, g in zip(tp, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("calibrate,rtol,param_atol", [(False, 1e-6, 1e-6),
                                                      (True, 1e-3, 0.05)])
def test_finetune_edge_matches_repro(calibrate, rtol, param_atol):
    """Without calibration the runs agree to float32 rounding. After the
    closed-form calibration the gain and bias sit at a least-squares
    optimum, where their gradients are zero up to rounding; Adam's first
    step moves each parameter by ±lr whatever its gradient's size, so the
    two frameworks' rounding picks the direction: the parameters end within
    one step (lr = 0.05) of repro's (bias 40.63 against 40.58 here), and
    the losses within 1e-3."""
    imgs = image_batch(2, 24, 24, seed=3)
    spec = "approx_bitexact:proposed@6"
    want = jqat.finetune_edge(jnp.asarray(imgs), jplan.as_plan(spec), steps=30,
                              lr=0.05, calibrate=calibrate)
    got = qat.finetune_edge(torch.from_numpy(imgs), spec, steps=30, lr=0.05,
                            calibrate=calibrate)
    assert min(got["losses"]) < got["losses"][0]
    assert got["psnr_post"] >= got["psnr_pre"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol)
    assert got["psnr_pre"] == pytest.approx(want["psnr_pre"], rel=1e-6)
    assert got["psnr_post"] == pytest.approx(want["psnr_post"], rel=rtol)
    for k, v in got["params"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want["params"][k]),
                                   rtol=0, atol=param_atol)
