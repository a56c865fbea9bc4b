"""The port's plan autotuner (``repro_torch.launch.autotune``) against
``repro``'s, on the CPU.

* The search's pieces (``with_rule``, ``plan_pdp_fj``, ``greedy_minimize``,
  ``_validate_with_rollback``) on synthetic scores: identical histories.
* ``autotune_edge`` at 2 × 64×64: the plan, history and ``site_macs``
  exactly, PSNRs within 1e-3 dB (both packages compute them in float32; the
  stat model's float32 correction sums run in another order). The search of
  ``BENCH_autotune.json`` (6 × 64×64, both wirings) is reproduced by the
  port alone, against the numbers in the file.
* ``autotune_lm`` on a 2-layer minitron-8b cut, the parameters carried
  across from ``repro``'s init (``models.convert.lm_params_from_jax``) at
  float32, where the two packages' logits agree within ``LOGIT_ATOL``
  (at bfloat16 they round apart by far more than the divergence budget's
  resolution): the plan exactly, divergences within 1e-4, energies within
  1e-12 relative (the meters sum per-site energies in another order), and
  ``site_macs`` exactly after folding ``layer.<i>.`` to ``repro``'s
  ``layer.*.``. The budget 2.0 sits between the two single-layer moves'
  scored divergences (1.17 and 3.14), so exactly one move is accepted, with
  no near tie in the greedy choice.
* The CLI writes bundles that load in ``repro``, and the reverse.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_plan_bundle as jload_plan_bundle
from repro.checkpoint import save_plan_bundle as jsave_plan_bundle
from repro.data import image_batch as jimage_batch
from repro.launch import autotune as jat
from repro.nn import conv as jconv
from repro.nn import plan as jplan
from repro.train import qat as jqat
from repro_torch.checkpoint import (load_plan_bundle, save_plan_bundle,
                                    unflatten_into)
from repro_torch.data import image_batch
from repro_torch.launch import autotune as at
from repro_torch.launch import serve as launch_serve
from repro_torch.models import convert
from repro_torch.models import lm as plm
from repro_torch.models import registry as reg
from repro_torch.nn import conv
from repro_torch.nn import plan as splan
from repro_torch.serving import EdgeDetectService

ROOT = Path(__file__).resolve().parents[1]
LM_SIZE = dict(n_layers=2, d_model=32, d_ff=64, n_heads=2, n_kv_heads=1,
               vocab=64)
LM_BUDGET = 2.0


def _plans(d):
    return splan.SubstratePlan.from_dict(d), jplan.SubstratePlan.from_dict(d)


# ---------------------------------------------------------------------------
# the search's pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["approx_bitexact:proposed@6",
                                  "approx_lut:design_du2022", "approx_pallas",
                                  "approx_cuda:csp_axc1@5", "exact", "int8",
                                  "approx_stat:proposed@7"])
def test_stat_spec_equals_repro(spec):
    want = jat.stat_spec(spec.replace("approx_cuda", "approx_pallas"))
    assert at.stat_spec(spec) == want


def test_with_rule_equals_repro():
    d = {"version": 1, "default": "exact",
         "rules": [{"site": "a.*", "spec": "int8"}, {"site": "b.*", "spec": "exact"}]}
    p, j = _plans(d)
    for pattern, spec in (("a.*", "approx_bitexact:proposed@6"), ("c.*", "int8"),
                          ("b.*", "approx_lut:proposed@4")):
        p, j = at.with_rule(p, pattern, spec), jat.with_rule(j, pattern, spec)
        assert p.to_dict() == j.to_dict()
        assert p.resolve("a.x") == j.resolve("a.x")


def test_plan_pdp_fj_equals_repro():
    site_macs = {"conv.edge.center": 24576, "conv.edge.ring": 196608,
                 "layer.0.attn.wq": 12345}
    for d in ({"version": 1, "default": "approx_bitexact:proposed@8", "rules": []},
              {"version": 1, "default": "approx_cuda:proposed@8",
               "rules": [{"site": "conv.edge.center", "spec": "approx_cuda:exact"},
                         {"site": "layer.*", "spec": "int8"}]},
              {"version": 1, "default": "approx_stat:design_du2022@6",
               "rules": [{"site": "conv.edge.ring", "spec": "approx_lut:proposed@4"}]}):
        jd = json.loads(json.dumps(d).replace("approx_cuda", "approx_pallas"))
        assert at.plan_pdp_fj(site_macs, splan.SubstratePlan.from_dict(d)) == \
            jat.plan_pdp_fj(site_macs, jplan.SubstratePlan.from_dict(jd))


def _synthetic(pkg):
    """A deterministic (pdp, score) of a plan: the pricing of a fixed
    workload, and a score that falls with every narrowed width."""
    site_macs = {"s.a": 1000, "s.b": 8000, "s.c": 300}

    def evaluate(plan):
        score = 20.0
        for site in site_macs:
            spec = plan.resolve(site)
            width = int(spec.rsplit("@", 1)[1]) if "@" in spec else 8
            score -= (8 - width) * (1.5 if site == "s.b" else 0.7)
        return pkg.plan_pdp_fj(site_macs, plan), score

    return evaluate


@pytest.mark.parametrize("budget", [19.0, 17.0, 14.0, -1.0])
def test_greedy_minimize_history_equals_repro(budget):
    d = {"version": 1, "default": "approx_bitexact:proposed@8", "rules": []}
    p, j = _plans(d)
    cands = [f"approx_bitexact:proposed@{n}" for n in (5, 6, 7)] + \
        ["approx_bitexact:design_du2022@6"]
    pats = ["s.a", "s.b", "s.c"]
    got = at.greedy_minimize(p, pats, cands, _synthetic(at), budget)
    want = jat.greedy_minimize(j, pats, cands, _synthetic(jat), budget)
    assert got[0].to_dict() == want[0].to_dict()
    assert got[1] == want[1] and got[2] == want[2]
    # the walk back: validation refuses every plan whose score is below 16
    val = lambda pkg: lambda plan: (_synthetic(pkg)(plan)[1] >= 16.0,
                                    *_synthetic(pkg)(plan)[::-1])
    gp, gq, gpdp, gn = at._validate_with_rollback(got[2], val(at))
    jp, jq, jpdp, jn = jat._validate_with_rollback(want[2], val(jat))
    assert (gp.to_dict(), gq, gpdp, gn) == (jp.to_dict(), jq, jpdp, jn)


# ---------------------------------------------------------------------------
# edge workload
# ---------------------------------------------------------------------------


def _same_history(got, want, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["pattern"], g["spec"], g["plan"]) == \
            (w["pattern"], w["spec"], w["plan"])
        assert g["pdp_fj"] == pytest.approx(w["pdp_fj"], rel=1e-12)
        assert g["score"] == pytest.approx(w["score"], abs=atol)


@pytest.fixture(scope="module")
def edge_pair():
    kw = dict(n_images=2, size=(64, 64), wirings=("proposed",), widths=(6, 7, 8))
    return at.autotune_edge(device="cpu", **kw), jat.autotune_edge(**kw)


def test_edge_autotune_equals_repro(edge_pair):
    got, want = edge_pair
    assert got["site_macs"] == want["site_macs"]
    assert got["plan"].to_dict() == want["plan"].to_dict()
    assert got["candidates"] == want["candidates"]
    assert got["rolled_back"] == want["rolled_back"]
    _same_history(got["history"], want["history"], 1e-3)
    for k in ("baseline", "tuned"):
        assert got[k]["plan"] == want[k]["plan"]
        assert got[k]["pdp_fj"] == pytest.approx(want[k]["pdp_fj"], rel=1e-12)
        assert got[k]["psnr_db"] == pytest.approx(want[k]["psnr_db"], abs=1e-3)
    assert got["budget_scored_db"] == pytest.approx(
        want["budget_scored_db"], abs=1e-3)
    assert got["plan"].rules and got["tuned"]["pdp_fj"] < got["baseline"]["pdp_fj"]


def test_edge_bundle_serves_bit_identical(edge_pair, tmp_path):
    res = edge_pair[0]
    out = str(tmp_path / "bundle")
    save_plan_bundle(out, res["plan"],
                     extra={"autotune": at._result_summary(res)})
    loaded, params, extra = load_plan_bundle(out)
    assert loaded == res["plan"] and params is None
    assert extra["autotune"]["tuned"]["pdp_fj"] == res["tuned"]["pdp_fj"]
    imgs = image_batch(3, 32, 32, seed=7)
    direct = conv.edge_detect_planned(torch.from_numpy(imgs), res["plan"]).numpy()
    with EdgeDetectService(loaded, max_batch_size=2, max_wait_s=1e-3,
                           device="cpu") as svc:
        served = np.stack(svc.detect(list(imgs)))
    np.testing.assert_array_equal(served, direct)


def test_bench_autotune_json_reproduced():
    """``BENCH_autotune.json``: the search on 6 × 64×64, both wirings."""
    with open(ROOT / "BENCH_autotune.json") as f:
        bench = json.load(f)
    res = at.autotune_edge(device="cpu")
    assert res["site_macs"] == bench["uniform"]["site_macs"] == {
        "conv.edge.center": 24576, "conv.edge.ring": 196608}
    assert res["plan"].to_dict() == bench["plan"]["plan"]
    assert len(res["history"]) - 1 == bench["search"]["accepted_moves"] == 1
    assert res["rolled_back"] == bench["search"]["rolled_back"]
    assert res["budget_scored_db"] == pytest.approx(
        bench["search"]["budget_scored_db"], abs=1e-3)
    assert res["baseline"]["psnr_db"] == pytest.approx(
        bench["uniform"]["psnr_db"], abs=1e-3)
    assert res["tuned"]["psnr_db"] == pytest.approx(
        bench["plan"]["psnr_db"], abs=1e-3)
    for k, b in (("baseline", "uniform"), ("tuned", "plan")):
        assert res[k]["pdp_fj"] == pytest.approx(bench[b]["pdp_fj"], rel=1e-9)
    assert 1 - res["tuned"]["pdp_fj"] / res["baseline"]["pdp_fj"] == \
        pytest.approx(bench["energy_saved_frac"], rel=1e-9)


def test_edge_autotune_qat_scoring():
    """``qat_steps`` scores every plan after a short QAT recovery; the tuned
    plan's recovery equals ``repro``'s ``finetune_edge`` on it."""
    imgs = jimage_batch(1, 16, 16, seed=0)
    res = at.autotune_edge(imgs, wirings=("proposed",), widths=(6, 8),
                           qat_steps=2, device="cpu")
    assert res["qat"]["steps"] == 2 and set(res["params"]) == {
        "kernel", "gain", "bias"}
    assert res["tuned"]["psnr_db"] == res["qat"]["psnr_post"]
    assert res["tuned"]["pdp_fj"] <= res["baseline"]["pdp_fj"]
    want = jqat.finetune_edge(jnp.asarray(imgs), jplan.SubstratePlan.from_dict(
        res["tuned"]["plan"]), steps=2, lr=0.05)
    assert res["qat"]["psnr_pre"] == pytest.approx(want["psnr_pre"], abs=1e-3)
    assert res["qat"]["psnr_post"] == pytest.approx(want["psnr_post"], abs=1e-3)
    for k, v in res["params"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want["params"][k]),
                                   rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="widths >= 5"):
        at.autotune_edge(imgs, widths=(4, 8), qat_steps=1, device="cpu")


# ---------------------------------------------------------------------------
# lm workload
# ---------------------------------------------------------------------------


_MINITRON_DENSES = (("attn", "wq", 4096, 4096), ("attn", "wk", 4096, 1024),
                    ("attn", "wv", 4096, 1024), ("attn", "wo", 4096, 4096),
                    ("ffn", "wg", 4096, 16384), ("ffn", "wi", 4096, 16384),
                    ("ffn", "wo", 16384, 4096))


def _priced_prefill(plan: splan.SubstratePlan, layers: int = 4,
                    rows: int = 32) -> tuple:
    """(port, repro): one prefill of minitron-8b's published widths under
    ``plan``, priced by each package's meter. The port records
    ``layer.<i>.<scope>.<leaf>`` per layer; ``repro`` records the labels its
    scan dispatch gives (``jplan.dispatch`` inside the scan frame), in layer
    order, as its callbacks fire."""
    from repro.nn import substrate as jsub
    from repro.obs import meter as jmeter
    from repro_torch.nn import substrate as psub
    from repro_torch.obs.meter import ContractionMeter

    jp = jplan.SubstratePlan.from_dict(json.loads(json.dumps(
        plan.to_dict()).replace("approx_cuda", "approx_pallas")))
    port, ref = ContractionMeter(), jmeter.ContractionMeter()
    names = [f"layer.{i}" for i in range(layers)]
    for i in range(layers):
        for scope, leaf, k, n in _MINITRON_DENSES:
            port.record_contraction(
                psub.get_substrate(plan.resolve(f"layer.{i}.{scope}.{leaf}")).meta,
                1, rows, k, n, site=f"layer.{i}.{scope}.{leaf}")
            with jplan.scan_site_scope(0, names), jplan.site_scope(scope):
                d = jplan.dispatch(jp, leaf)
            spec, label = d.groups[0 if d.index is None else d.branch_of[i]]
            meta = jsub.get_substrate(spec).meta
            ref._record_contraction(meta.spec, label, rows * k * n,
                                    jmeter.pdp_per_mac_fj(meta.mult_key))
    return (at._scan_order_energy_fj(port),
            sum(e["energy_pdp_fj"] for e in ref.summary().values()))


@pytest.mark.parametrize("scored", [True, False])
def test_lm_prefill_prices_to_repros_float(scored):
    """Every plan of the 4-layer search over {exact, int8, proposed@8 on
    either backend} prices, at the published widths, to the float ``repro``
    computes, in scoring (stat) and in validation. Summed per layer instead,
    a move of one layer to ``int8`` came out an ulp below the baseline, and
    the greedy took it though it saves nothing."""
    import itertools

    specs = ("exact", "int8", "approx_bitexact:proposed@8",
             "approx_cuda:proposed@8")
    base = splan.SubstratePlan.uniform("exact")
    for assign in itertools.product(specs, repeat=4):
        plan = base
        for i, spec in enumerate(assign):
            if spec != "exact":
                plan = at.with_rule(plan, f"layer.{i}.*", spec)
        got, want = _priced_prefill(at.stat_plan(plan) if scored else plan)
        assert got == want, assign
    exact_fj = _priced_prefill(base)[0]
    for i in range(4):
        assert _priced_prefill(at.with_rule(base, f"layer.{i}.*", "int8"))[0] \
            == exact_fj


def _fold(site_macs: dict) -> dict:
    out: dict = {}
    for site, macs in site_macs.items():
        parts = site.split(".")
        key = ".".join(["layer", "*"] + parts[2:])
        out[key] = out.get(key, 0) + macs
    return out


@pytest.fixture(scope="module")
def lm_pair():
    want = jat.autotune_lm("minitron-8b", overrides={**LM_SIZE, "dtype": jnp.float32},
                           div_budget=LM_BUDGET)
    tree = jax.tree.map(np.asarray, want["params"])
    mp = pytest.MonkeyPatch()
    mp.setattr(plm, "init_params", lambda cfg, gen, device=None:
               convert.lm_params_from_jax(cfg, tree, device or "cpu"))
    try:
        got = {b: at.autotune_lm("minitron-8b", div_budget=b, device="cpu",
                                 overrides={**LM_SIZE, "dtype": torch.float32})
               for b in (LM_BUDGET, 0.25)}
    finally:
        mp.undo()
    return got, want


def test_lm_autotune_equals_repro(lm_pair):
    got, want = lm_pair[0][LM_BUDGET], lm_pair[1]
    assert _fold(got["site_macs"]) == want["site_macs"]
    assert got["sites"] == want["sites"] == ["layer.0.*", "layer.1.*"]
    assert got["plan"].to_dict() == want["plan"].to_dict()
    assert len(got["history"]) == 2  # one move accepted
    assert got["rolled_back"] == want["rolled_back"]
    _same_history(got["history"], want["history"], 1e-4)
    for k in ("baseline", "tuned"):
        assert got[k]["plan"] == want[k]["plan"]
        assert got[k]["pdp_fj"] == pytest.approx(want[k]["pdp_fj"], rel=1e-12)
        assert got[k]["divergence"] == pytest.approx(want[k]["divergence"],
                                                     abs=1e-4)


def test_lm_autotune_default_budget_accepts_no_move(lm_pair):
    res = lm_pair[0][0.25]
    assert res["plan"].rules == () and len(res["history"]) == 1
    assert res["tuned"]["divergence"] == 0.0
    # every metered prefill counts the same MACs: 2 x 16 rows per dense
    per_layer = 2 * 16 * (2 * 32 * 32 + 2 * 32 * 16 + 3 * 32 * 64)
    assert sum(res["site_macs"].values()) == 2 * per_layer


# ---------------------------------------------------------------------------
# the CLI and the bundles, both ways
# ---------------------------------------------------------------------------


def test_cli_bundle_loads_in_repro_and_back(tmp_path):
    out = str(tmp_path / "port_bundle")
    res = at.main(["--workload", "edge", "--out", out, "--device", "cpu",
                   "--wirings", "proposed", "--widths", "6,8", "--images", "2",
                   "--size", "32x32", "--json", str(tmp_path / "rec.json")])
    jp, jparams, jextra = jload_plan_bundle(out)
    assert jp.to_dict() == res["plan"].to_dict() and jparams is None
    assert jextra["autotune"]["tuned"] == json.loads(
        (tmp_path / "rec.json").read_text())["tuned"]
    imgs = jimage_batch(2, 24, 24, seed=1)
    np.testing.assert_array_equal(
        np.asarray(jconv.edge_detect_planned(imgs, jp)),
        conv.edge_detect_planned(torch.from_numpy(imgs), res["plan"]).numpy())
    # the reverse: a bundle written by repro, with edge params, loads here
    jdir = str(tmp_path / "repro_bundle")
    jsave_plan_bundle(jdir, jp, params=jqat.init_edge_params(),
                      extra={"from": "repro"})
    plan, params, extra = load_plan_bundle(jdir)
    assert plan == res["plan"] and extra == {"from": "repro"}
    np.testing.assert_array_equal(params["kernel"].numpy(), conv.LAPLACIAN)


def test_cli_lm_bundle_serves_through_the_launcher(tmp_path, monkeypatch):
    """``--workload lm`` writes repro's parameter tree with the plan; the
    serve launcher's ``--plan DIR`` restores both (a reduced width stands in
    for the published one, which the CLI does not cut)."""
    small = reg.get_config("minitron-8b", d_model=32, d_ff=64, n_heads=2,
                           n_kv_heads=1, vocab=64)
    monkeypatch.setitem(reg._REGISTRY, "minitron-8b", small)
    out = str(tmp_path / "lm_bundle")
    res = at.main(["--workload", "lm", "--arch", "minitron-8b", "--n-layers", "2",
                   "--out", out, "--device", "cpu", "--div-budget", "2.0",
                   "--candidates", "int8,approx_cuda:proposed@8"])
    plan, flat, extra = load_plan_bundle(out)
    assert plan == res["plan"] and extra["autotune"]["workload"] == "lm"
    # the stored tree restores the searched parameters into a fresh model
    bundle = reg.get_bundle("minitron-8b", n_layers=2)
    fresh = bundle.init_params(torch.Generator().manual_seed(1), "cpu")
    template = bundle.layout.to_tree(
        {k: t.to("meta") for k, t in convert.named_leaves(fresh).items()})
    convert.assign_(fresh, bundle.layout.from_tree(
        unflatten_into(template, flat, "cpu")))
    searched = convert.named_leaves(res["params"])
    assert all(torch.equal(t, searched[k])
               for k, t in convert.named_leaves(fresh).items())
    served = launch_serve.main(["--arch", "minitron-8b", "--device", "cpu",
                                "--n-layers", "2", "--requests", "2",
                                "--max-tokens", "2", "--plan", out])
    assert [len(r.output) for r in served] == [2, 2]
