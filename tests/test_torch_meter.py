"""The port's substrate meter (``repro_torch.obs.meter``) against ``repro``'s,
on the CPU.

The cases mirror the meter cases of ``tests/test_obs.py`` and of
``tests/test_qat.py`` on the same numpy inputs. Counts, MACs and energies
are compared exactly, through the registries' JSON exports (the same
family names, help strings, labels and values). The probe's moments are
compared on single calls, where both packages draw the same rows from the
same seed (``repro`` draws them when a function is traced, the port at
every call).

Two differences are by design:

* LM sites: the port runs a Python layer loop and meters
  ``layer.<i>.attn.wq``; ``repro``'s scan dispatch folds the index to
  ``layer.*.attn.wq``. Site summaries are compared after folding, with
  exact integer sums.
* Under autograd the port meters every contraction that runs: the forward
  and, with ``cfg.remat``, the recompute of each checkpointed layer in the
  backward. ``repro`` meters the same at one layer; past one layer its
  scan under ``jax.grad`` fires the forward's callback once for the whole
  scan (a callback with no traced operands is hoisted out of the loop),
  so the count comparison runs at one layer and the port's per-layer count
  is checked on its own.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jreg
from repro.nn import conv as jconv
from repro.nn import plan as jplan
from repro.nn import substrate as jsub
from repro.obs import meter as jmeter
from repro.train import qat as jqat
from repro_torch.data import image_batch
from repro_torch.models import registry as reg
from repro_torch.nn import conv
from repro_torch.nn import plan as splan
from repro_torch.nn import substrate as psub
from repro_torch.obs import meter as pmeter
from repro_torch.obs.meter import ContractionMeter, current_meter, telemetry_scope
from repro_torch.serving import EdgeDetectService
from repro_torch.train import qat

RNG = np.random.default_rng(21)
SPEC = "approx_lut:proposed"


def _jrun(fn, **meter_kw):
    """Run ``fn`` under a fresh ``repro`` meter → (result, meter)."""
    m = jmeter.ContractionMeter(**meter_kw)
    with jmeter.telemetry_scope(m):
        out = fn()
        jax.effects_barrier()
    return out, m


def _prun(fn, **meter_kw):
    m = ContractionMeter(**meter_kw)
    with telemetry_scope(m):
        out = fn()
    return out, m


def _json(meter, rename=()):
    out = meter.registry.to_json()
    for fam in out.values():
        for s in fam["samples"]:
            for old, new in rename:
                s["labels"] = {k: v.replace(old, new)
                               for k, v in s["labels"].items()}
    return out


def _fold(sites: dict) -> dict:
    """Port LM site labels folded as ``repro``'s scan folds them."""
    out: dict = {}
    for site, e in sites.items():
        parts = site.split(".")
        key = ".".join(["layer", "*"] + parts[2:]) if parts[0] == "layer" else site
        acc = out.setdefault(key, {"contractions": 0, "macs": 0,
                                   "energy_pdp_fj": 0.0, "specs": set()})
        acc["contractions"] += e["contractions"]
        acc["macs"] += e["macs"]
        acc["energy_pdp_fj"] += e["energy_pdp_fj"]
        acc["specs"] |= set(e["specs"])
    return out


def _same_sites(got: dict, want: dict):
    assert set(got) == set(want)
    for site in want:
        assert got[site]["contractions"] == want[site]["contractions"], site
        assert got[site]["macs"] == want[site]["macs"], site
        assert got[site]["energy_pdp_fj"] == pytest.approx(
            want[site]["energy_pdp_fj"], rel=1e-12), site
        assert set(got[site]["specs"]) == set(want[site]["specs"]), site


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["proposed", "proposed@4", "proposed@8",
                                 "csp_axc1", "design_du2022@6", "exact",
                                 "trunc_exact_csp@12"])
def test_pdp_per_mac_equals_repro(key):
    assert pmeter.pdp_per_mac_fj(key) == jmeter.pdp_per_mac_fj(key)


def test_pricing_orders_as_repro():
    assert pmeter.pdp_per_mac_fj("csp_axc1") == \
        pmeter.pdp_per_mac_fj("design_esposito2018")
    assert 0 < pmeter.pdp_per_mac_fj("proposed") < pmeter.pdp_per_mac_fj("exact")
    assert pmeter.pdp_per_mac_fj("proposed@4") < pmeter.pdp_per_mac_fj("proposed@8")


# ---------------------------------------------------------------------------
# the substrate hooks, against repro
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [SPEC, "approx_bitexact:design_du2022@6",
                                  "approx_stat:proposed", "int8", "exact"])
def test_integer_path_records_equal_repro(spec):
    a = RNG.integers(-32, 32, (24, 40)).astype(np.int32)
    b = RNG.integers(-32, 32, (40, 6)).astype(np.int32)
    js, ps = jsub.get_substrate(spec), psub.get_substrate(spec)
    kw = dict(error_probe=True, probe_rows=5, probe_cols=4, seed=3)
    want, jm = _jrun(lambda: np.asarray(js.dot_general(a, b)), **kw)
    got, pm = _prun(lambda: ps.dot_general(torch.from_numpy(a),
                                           torch.from_numpy(b)).numpy(), **kw)
    np.testing.assert_array_equal(got, want)
    assert _json(pm) == _json(jm)
    assert pm.probe_moments() == jm.probe_moments()
    assert pm.summary() == jm.summary()


@pytest.mark.parametrize("spec", [SPEC, "approx_cuda:csp_axc1@6", "int8"])
def test_quantized_path_records_equal_repro(spec):
    x = RNG.normal(size=(4, 6, 48)).astype(np.float32)
    w = RNG.normal(size=(48, 24)).astype(np.float32)
    jspec = spec.replace("approx_cuda", "approx_pallas")
    js, ps = jsub.get_substrate(jspec), psub.get_substrate(spec)
    jc = jsub.ContractionSpec.matmul(quant=jsub.QuantPolicy(), site="blk.w")
    pc = psub.ContractionSpec.matmul(quant=psub.QuantPolicy(), site="blk.w")
    kw = dict(error_probe=True, seed=11)
    want, jm = _jrun(lambda: np.asarray(js.dot_general(x, w, jc)), **kw)
    got, pm = _prun(lambda: ps.dot_general(torch.from_numpy(x),
                                           torch.from_numpy(w), pc).numpy(), **kw)
    np.testing.assert_array_equal(got, want)
    assert _json(pm) == _json(jm, [("approx_pallas", "approx_cuda")])
    assert pm.site_summary()["blk.w"]["macs"] == 24 * 48 * 24


def test_exact_float_path_metered_without_probe():
    x = np.linspace(-1, 1, 32, dtype=np.float32).reshape(4, 8)
    w = np.linspace(-1, 1, 16, dtype=np.float32).reshape(8, 2)
    jc = jsub.ContractionSpec.matmul(quant=jsub.QuantPolicy())
    pc = psub.ContractionSpec.matmul(quant=psub.QuantPolicy())
    _, jm = _jrun(lambda: jsub.get_substrate("exact").dot_general(x, w, jc),
                  error_probe=True)
    _, pm = _prun(lambda: psub.get_substrate("exact").dot_general(
        torch.from_numpy(x), torch.from_numpy(w), pc), error_probe=True)
    assert pm.summary()["exact:exact"]["contractions"] == 1
    assert pm.probe_moments() == {} == jm.probe_moments()
    assert _json(pm) == _json(jm)


def test_fused_conv_path_records_equal_repro():
    """The fused conv (``approx_pallas`` in repro, interpret mode; the plain
    version of ``approx_cuda`` here) meters the im2col contraction's MACs,
    and its probe samples the same slab."""
    imgs = RNG.integers(0, 256, (2, 16, 16), dtype=np.uint8)
    kw = dict(error_probe=True, seed=5)
    want, jm = _jrun(lambda: np.asarray(
        jconv.edge_detect_batched(imgs, "approx_pallas:proposed")), **kw)
    got, pm = _prun(lambda: conv.edge_detect_batched(
        torch.from_numpy(imgs), "approx_cuda:proposed").numpy(), **kw)
    np.testing.assert_array_equal(got, want)
    assert _json(pm) == _json(jm, [("approx_pallas", "approx_cuda")])
    row = pm.summary()["approx_cuda:proposed"]
    assert row["macs"] == 2 * 16 * 16 * 9 and pm.probe_moments()["approx_cuda:proposed"]["n"] > 0
    # the im2col path reports the same MACs and energy
    _, lm = _prun(lambda: conv.conv2d_batched(
        conv.to_signed_pixels(torch.from_numpy(imgs)), conv.LAPLACIAN,
        "approx_cuda:proposed", fused=False, site="conv.edge"))
    assert lm.site_summary() == pm.site_summary()


def test_planned_edge_records_equal_repro():
    imgs = image_batch(3, 24, 24, seed=2)
    plan = {"version": 1, "default": "approx_lut:proposed",
            "rules": [{"site": "conv.edge.center",
                       "spec": "approx_bitexact:proposed@6"},
                      {"site": "conv.edge.ring", "spec": "approx_stat:csp_axc1@7"}]}
    kw = dict(error_probe=True, probe_rows=16, seed=9)
    want, jm = _jrun(lambda: np.asarray(jconv.edge_detect_planned(
        imgs, jplan.as_plan(plan))), **kw)
    got, pm = _prun(lambda: conv.edge_detect_planned(
        torch.from_numpy(imgs), splan.as_plan(plan)).numpy(), **kw)
    np.testing.assert_array_equal(got, want)
    assert _json(pm) == _json(jm)
    assert pm.site_summary()["conv.edge.ring"]["macs"] == 3 * 24 * 24 * 8


# ---------------------------------------------------------------------------
# the port's own contract
# ---------------------------------------------------------------------------


def test_outputs_bit_identical_with_and_without_scope():
    imgs = torch.from_numpy(image_batch(2, 20, 20, seed=4))
    a = torch.from_numpy(RNG.integers(-128, 128, (9, 21)).astype(np.int32))
    b = torch.from_numpy(RNG.integers(-128, 128, (21, 5)).astype(np.int32))
    x = torch.from_numpy(RNG.normal(size=(3, 17)).astype(np.float32))
    w = torch.from_numpy(RNG.normal(size=(17, 4)).astype(np.float32))
    qc = psub.ContractionSpec.matmul(quant=psub.QuantPolicy())

    def run():
        return [psub.get_substrate(SPEC).dot_general(a, b),
                psub.get_substrate("approx_cuda").dot_general(x, w, qc),
                conv.edge_detect_batched(imgs, "approx_cuda:csp_axc1@6"),
                conv.edge_detect_planned(imgs, "approx_stat:proposed")]

    bare = run()
    metered, m = _prun(run, error_probe=True)
    after = run()
    for u, v, z in zip(bare, metered, after):
        assert torch.equal(u, v) and torch.equal(u, z)
    assert sum(e["contractions"] for e in m.summary().values()) == 5


def test_no_scope_records_nothing():
    m = ContractionMeter(error_probe=True)
    assert current_meter() is None
    psub.get_substrate(SPEC).dot_general(
        torch.ones((4, 8), dtype=torch.int32), torch.ones((8, 4), dtype=torch.int32))
    for fam in m.registry.to_json().values():
        assert fam["samples"] == []


def test_none_scope_and_nesting_restore():
    outer, inner = ContractionMeter(), ContractionMeter()
    a = torch.ones((2, 3), dtype=torch.int32)
    b = torch.ones((3, 2), dtype=torch.int32)
    s = psub.get_substrate("int8")
    with telemetry_scope(outer):
        s.dot_general(a, b)
        with telemetry_scope(inner):
            assert current_meter() is inner
            s.dot_general(a, b)
            with telemetry_scope(None):
                assert current_meter() is None
                s.dot_general(a, b)
            s.dot_general(a, b)
        assert current_meter() is outer
        s.dot_general(a, b)
    assert current_meter() is None
    assert outer.summary()["int8:exact"]["contractions"] == 2
    assert inner.summary()["int8:exact"]["contractions"] == 2


def test_worker_threads_record_into_the_installers_scope():
    """Process-wide: contractions on other threads (serving workers,
    autograd's device thread) land in the scope installed here."""
    m = ContractionMeter()
    a = torch.ones((2, 3), dtype=torch.int32)
    b = torch.ones((3, 5), dtype=torch.int32)

    def work():
        for _ in range(3):
            psub.get_substrate(SPEC).dot_general(
                a, b, psub.ContractionSpec(site="worker"))

    with telemetry_scope(m):
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert m.site_summary()["worker"]["contractions"] == 12
    assert m.site_summary()["worker"]["macs"] == 12 * 2 * 3 * 5


def test_edge_service_meters_each_tap_group():
    imgs = list(image_batch(4, 32, 32, seed=6))
    plan = {"version": 1, "default": "approx_cuda:proposed@8",
            "rules": [{"site": "conv.edge.center", "spec": "approx_cuda:exact"},
                      {"site": "conv.edge.ring", "spec": "approx_cuda:csp_axc1@6"}]}
    with EdgeDetectService(plan, max_batch_size=2, n_workers=2,
                           device="cpu") as svc:
        bare = svc.detect(imgs)
        metered, m = _prun(lambda: svc.detect(imgs), error_probe=True)
    assert all(np.array_equal(u, v) for u, v in zip(bare, metered))
    sites = m.site_summary()
    assert sites["conv.edge.center"]["macs"] == 4 * 32 * 32
    assert sites["conv.edge.ring"]["macs"] == 4 * 32 * 32 * 8
    assert sites["conv.edge.ring"]["energy_pdp_fj"] == pytest.approx(
        4 * 32 * 32 * 8 * pmeter.pdp_per_mac_fj("csp_axc1@6"), rel=1e-12)
    assert m.probe_moments("approx_cuda:csp_axc1@6")["n"] > 0


def test_unprobed_hook_reads_shapes_only():
    """Without the probe the hook never touches tensor data: it runs on
    meta tensors, which hold none (so on the card it adds no sync)."""
    s = psub.get_substrate("approx_cuda")
    a3 = torch.empty((2, 7, 9), dtype=torch.int8, device="meta")
    b3 = torch.empty((2, 9, 3), dtype=torch.int8, device="meta")
    plan = psub._plan_contraction((2, 7, 9), (2, 9, 3),
                                  (((2,), (1,)), ((0,), (0,))))
    _, m = _prun(lambda: s._meter_hook(plan, a3, b3, site="meta"))
    assert m.site_summary()["meta"]["macs"] == 2 * 7 * 9 * 3


def test_probe_moments_track_the_offline_oracle():
    from repro_torch.core import lut

    key = "proposed"
    s = psub.get_substrate(f"approx_lut:{key}")
    rows = cols = kk = 64
    m = ContractionMeter(error_probe=True, probe_rows=rows, probe_cols=cols,
                         probe_k=kk, seed=7)
    with telemetry_scope(m):
        for _ in range(4):
            s.dot_general(torch.from_numpy(RNG.integers(-128, 128, (rows, kk)).astype(np.int32)),
                          torch.from_numpy(RNG.integers(-128, 128, (kk, cols)).astype(np.int32)))
    mom = m.probe_moments(f"approx_lut:{key}")
    oracle = lut.error_moments(key)
    assert mom["n"] == rows * kk * cols * 4
    assert mom["mean"] == pytest.approx(
        oracle["mean"], abs=6 * oracle["std"] / np.sqrt(rows * kk * 4))
    assert 0 < mom["max_ed"] <= oracle["max_abs"]


# ---------------------------------------------------------------------------
# QAT: the straight-through forward meters like any other contraction
# ---------------------------------------------------------------------------


def test_edge_qat_step_meters_as_repro():
    imgs = RNG.integers(0, 256, size=(2, 12, 12)).astype(np.uint8)
    spec = "approx_bitexact:proposed@6"

    def jstep():
        params = jqat.init_edge_params()
        target = jqat.edge_reference_response(jnp.asarray(imgs))
        plan = jplan.SubstratePlan.uniform(spec)
        loss = lambda p: jnp.mean((jqat.edge_response(p, jnp.asarray(imgs), plan)
                                   - target) ** 2)
        return jax.value_and_grad(loss)(params)

    def pstep():
        params = {k: v.requires_grad_(True) for k, v in qat.init_edge_params().items()}
        t = torch.from_numpy(imgs)
        target = qat.edge_reference_response(t)
        loss = torch.mean((qat.edge_response(params, t, spec) - target) ** 2)
        return torch.autograd.grad(loss, list(params.values()))

    _, jm = _jrun(jstep)
    _, pm = _prun(pstep)
    assert _json(pm) == _json(jm)
    assert set(pm.site_summary()) == set(conv.edge_tap_sites())


LM_SIZE = dict(d_model=32, d_ff=64, vocab=64, n_heads=2, n_kv_heads=1)


def _port_loss_and_grad(n_layers, remat, spec="approx_bitexact:proposed@8"):
    bundle = reg.get_bundle("minitron-8b", n_layers=n_layers, remat=remat,
                            dtype=torch.float32, dot_plan=spec, **LM_SIZE)
    params = bundle.init_params(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(1, 64, (2, 8))),
             "labels": torch.from_numpy(rng.integers(1, 64, (2, 8)))}
    leaves = list(params.parameters())
    for p in leaves:
        p.requires_grad_(True)
    with qat.qat_scope():
        loss = bundle.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss, grads


@pytest.mark.parametrize("remat", [False, True])
def test_lm_qat_loss_and_backward_count_as_repro(remat):
    """One layer: 7 denses in the forward, 7 more in remat's recompute."""
    def jstep():
        cfg = jreg.get_config("minitron-8b", n_layers=1, remat=remat,
                              dtype=jnp.float32,
                              dot_plan="approx_bitexact:proposed@8", **LM_SIZE)
        b = jreg.build_bundle(cfg)
        params = b.init_params(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        batch = {"tokens": jnp.asarray(rng.integers(1, 64, (2, 8))),
                 "labels": jnp.asarray(rng.integers(1, 64, (2, 8)))}
        with jqat.qat_scope():
            return jax.block_until_ready(jax.value_and_grad(b.loss_fn)(params, batch))

    _, jm = _jrun(jstep)
    _, pm = _prun(lambda: _port_loss_and_grad(1, remat))
    _same_sites(_fold(pm.site_summary()), _fold(jm.site_summary()))
    assert pm.summary()["approx_bitexact:proposed"]["contractions"] == \
        (14 if remat else 7)


def test_lm_qat_counts_every_layer_and_recompute():
    """The port's count grows with depth: each layer's 7 denses, and as many
    again in the recompute under remat."""
    counts = {}
    for layers in (1, 2):
        for remat in (False, True):
            _, m = _prun(lambda: _port_loss_and_grad(layers, remat))
            counts[(layers, remat)] = m.summary()[
                "approx_bitexact:proposed"]["contractions"]
    assert counts == {(1, False): 7, (1, True): 14, (2, False): 14,
                      (2, True): 28}
