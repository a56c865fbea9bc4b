"""Parity of the port's per-site substrate plans (``repro_torch.nn.plan``)
with ``repro.nn.plan``, after ``tests/test_plan.py``'s unsharded, non-scan
cases: rule precedence and validation, JSON round trips within each package
and across the two in both directions, ``stat_spec``, the site scopes, and
the planned edge pipeline — ``edge_detect_planned`` byte-identical to
``repro``'s for mixed plans, a uniform plan equal to
``edge_detect_batched``, and ``EdgeDetectService(plan, device="cpu")``
byte-identical to the direct planned path. Edge maps are uint8 and compared
exactly."""
import json

import numpy as np
import pytest
import torch

from repro.data import images as jimages
from repro.nn import conv as jconv
from repro.nn import plan as jplan
from repro_torch.nn import conv
from repro_torch.nn import plan as splan
from repro_torch.serving import EdgeDetectService

#: sites both packages name, plus ones no rule of the plans below matches
SITES = ("conv.edge", "conv.edge.center", "conv.edge.ring", "layer.3.attn.wq",
         "layer.1.ffn.wg", "x.y", "patch_proj")
#: specs both registries know (repro has no approx_cuda)
SHARED_SPECS = ("exact", "int8", "approx_lut:proposed", "approx_bitexact:csp_axc1@6",
                "approx_pallas:design_du2022@5", "approx_lut:exact@7")


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -- resolution rules -----------------------------------------------------------


def test_resolution_precedence_exact_beats_glob():
    rules = (("layer.*", "int8"),
             ("layer.3.attn.wq", "approx_bitexact:proposed@6"))
    for mod in (splan, jplan):
        p = mod.SubstratePlan(default="exact", rules=rules)
        assert p.resolve("layer.3.attn.wq") == "approx_bitexact:proposed@6"
        assert p.resolve("layer.3.attn.wk") == "int8"


def test_resolution_most_literal_glob_wins_regardless_of_order():
    rules = [("layer.*", "int8"), ("layer.3.attn.*", "approx_lut:proposed")]
    for ordering in (rules, rules[::-1]):
        p = splan.SubstratePlan(default="exact", rules=tuple(ordering))
        assert p.resolve("layer.3.attn.wq") == "approx_lut:proposed"
        assert p.resolve("layer.1.ffn.wg") == "int8"


def test_resolution_tie_goes_to_later_rule():
    p = splan.SubstratePlan(default="exact", rules=(
        ("layer.1.*", "int8"), ("*.attn.wq", "approx_lut:proposed")))
    assert splan._specificity("layer.1.*") == splan._specificity("*.attn.wq")
    assert splan._specificity("layer.1.*") == jplan._specificity("layer.1.*")
    assert p.resolve("layer.1.attn.wq") == "approx_lut:proposed"


def test_resolution_unknown_site_falls_back_to_default_and_cache_is_per_plan():
    p = splan.SubstratePlan(default="approx_bitexact:proposed@8",
                            rules=(("conv.edge.*", "int8"),))
    assert p.resolve("layer.0.ffn.wo") == "approx_bitexact:proposed@8"
    assert p.resolve(None) == "approx_bitexact:proposed@8"
    a = splan.SubstratePlan(default="exact", rules=(("x.y", "int8"),))
    b = splan.SubstratePlan(default="exact",
                            rules=(("x.y", "approx_lut:proposed"),))
    assert (a.resolve("x.y"), b.resolve("x.y"), a.resolve("x.y")) == \
        ("int8", "approx_lut:proposed", "int8")


def test_plan_validates_specs_like_reference():
    for mod in (splan, jplan):
        with pytest.raises(ValueError, match="unknown substrate backend"):
            mod.SubstratePlan(default="no_such_backend")
        with pytest.raises(ValueError, match="unknown substrate backend"):
            mod.SubstratePlan(rules=(("a.b", "mystery:proposed"),))
        with pytest.raises(ValueError):
            mod.SubstratePlan(rules=(("", "exact"),))
        with pytest.raises(ValueError, match="malformed"):
            mod.SubstratePlan(default="approx_lut:")
    # wirings are validated by the backend factories at resolution time
    p = splan.SubstratePlan(rules=(("a.b", "approx_lut:mystery_wiring"),))
    with pytest.raises(ValueError):
        p.substrate_for("a.b")
    assert splan.SubstratePlan(default="approx_cuda:exact").substrate_for(
        "conv.edge").meta.spec == "approx_cuda:exact"


def test_plan_json_and_dict_round_trip(tmp_path):
    p = splan.SubstratePlan(default="approx_cuda:proposed@8", rules=(
        ("conv.edge.center", "approx_cuda:exact"),
        ("layer.*.ffn.*", "int8")))
    assert splan.SubstratePlan.from_json(p.to_json()) == p
    assert splan.as_plan(p.to_dict()) == p
    assert p.label == "plan(approx_cuda:proposed@8+2 rules)"
    path = tmp_path / "plan.json"
    splan.save_plan(str(path), p)
    assert splan.load_plan(str(path)) == p
    assert splan.load_plan(str(tmp_path)) == p  # dir → dir/plan.json
    with pytest.raises(ValueError, match="newer than supported"):
        splan.SubstratePlan.from_dict({"version": 99, "default": "exact"})


def test_as_plan_accepts_spec_string_and_rejects_junk():
    p = splan.as_plan("int8")
    assert p.is_uniform and p.default == "int8" and p.label == "plan(int8)"
    assert splan.as_plan(p) is p
    assert splan.SubstratePlan.uniform("exact") == splan.SubstratePlan()
    with pytest.raises(TypeError):
        splan.as_plan(42)


# -- across the two packages ----------------------------------------------------


def _mixed_rules(specs):
    return tuple((pat, specs[i % len(specs)]) for i, pat in enumerate(
        ("conv.edge.center", "conv.edge.*", "layer.*", "layer.3.attn.*",
         "*.ffn.wg")))


@pytest.mark.parametrize("default", ["exact", "approx_pallas:proposed@4"])
def test_reference_plan_file_loads_and_resolves_alike(tmp_path, default):
    """A plan ``repro`` writes (file and bundle directory) loads in the port
    and resolves every site to the same spec."""
    jp = jplan.SubstratePlan(default=default, rules=_mixed_rules(SHARED_SPECS))
    jplan.save_plan(str(tmp_path / "plan.json"), jp)
    for path in (tmp_path / "plan.json", tmp_path):
        p = splan.load_plan(str(path))
        assert p.to_dict() == jp.to_dict()
        for site in SITES:
            assert p.resolve(site) == jp.resolve(site), site


def test_port_plan_file_loads_in_reference_and_approx_cuda_stays_refused(tmp_path):
    p = splan.SubstratePlan(default="int8",
                            rules=_mixed_rules(SHARED_SPECS[::-1]))
    splan.save_plan(str(tmp_path / "plan.json"), p)
    jp = jplan.load_plan(str(tmp_path))
    assert jp.to_dict() == p.to_dict()
    for site in SITES:
        assert jp.resolve(site) == p.resolve(site), site
    cuda = splan.SubstratePlan(default="exact",
                               rules=(("conv.edge.center", "approx_cuda:exact"),))
    with pytest.raises(ValueError, match="unknown substrate backend"):
        jplan.SubstratePlan.from_json(cuda.to_json())


def test_stat_spec_and_stat_plan_match_reference():
    for spec in SHARED_SPECS + ("approx_stat:csp_axc1@4", "approx_pallas"):
        assert splan.stat_spec(spec) == jplan.stat_spec(spec), spec
    assert splan.stat_spec("approx_cuda:csp_axc1@6") == "approx_stat:csp_axc1@6"
    p = splan.SubstratePlan(default="approx_lut", rules=_mixed_rules(SHARED_SPECS))
    jp = jplan.SubstratePlan(default="approx_lut", rules=_mixed_rules(SHARED_SPECS))
    assert splan.stat_plan(p).to_dict() == jplan.stat_plan(jp).to_dict()


def test_site_scope_composes_and_rejects_wildcards():
    for mod in (splan, jplan):
        with mod.site_scope("layer.3", "attn"):
            assert mod.current_sites("wq") == (None, ("layer.3.attn.wq",))
            with mod.site_scope("inner"):
                assert mod.current_sites() == (None, ("layer.3.attn.inner",))
        assert mod.current_sites("wq") == (None, ("wq",))
        assert mod.current_sites() == (None, ("",))
        with pytest.raises(ValueError, match="invalid site segment"):
            with mod.site_scope("ok", "layer.*"):
                pass
        assert mod.current_sites() == (None, ("",))


def test_plan_override_scope_is_ambient_and_restores():
    assert splan.current_plan_override() is None
    with splan.plan_override_scope("int8") as p:
        assert p == splan.current_plan_override() == splan.as_plan("int8")
        with splan.plan_override_scope(None):
            assert splan.current_plan_override() is None
        assert splan.current_plan_override() == p
    assert splan.current_plan_override() is None


# -- the planned edge pipeline --------------------------------------------------

#: (port plan, reference plan) — mixed over every backend family, widths 4..8
MIXED_PLANS = [
    ({"default": "exact", "rules": [
        {"site": "conv.edge.center", "spec": "approx_cuda:exact"},
        {"site": "conv.edge.ring", "spec": "approx_cuda:csp_axc1@6"}]},
     {"default": "exact", "rules": [
         {"site": "conv.edge.center", "spec": "approx_pallas:exact"},
         {"site": "conv.edge.ring", "spec": "approx_pallas:csp_axc1@6"}]}),
    ({"default": "int8", "rules": [
        {"site": "conv.edge.ring", "spec": "approx_lut:design_du2022@5"}]},) * 2,
    ({"default": "approx_bitexact:proposed@7", "rules": [
        {"site": "conv.edge.center", "spec": "exact"}]},) * 2,
    ({"default": "approx_pallas:proposed@4", "rules": [
        {"site": "conv.edge.center", "spec": "approx_lut:csp_axc3@8"},
        {"site": "conv.edge.ring", "spec": "approx_pallas:exact@4"}]},) * 2,
    ({"version": 1, "default": "approx_cuda:proposed@8", "rules": [
        {"site": "conv.edge.center", "spec": "approx_cuda:exact"},
        {"site": "conv.edge.ring", "spec": "approx_cuda:csp_axc1@6"}]},
     {"version": 1, "default": "approx_pallas:proposed@8", "rules": [
         {"site": "conv.edge.center", "spec": "approx_pallas:exact"},
         {"site": "conv.edge.ring", "spec": "approx_pallas:csp_axc1@6"}]}),
]


def test_edge_tap_sites_match_reference():
    assert conv.edge_tap_sites() == jconv.edge_tap_sites()
    assert conv.EDGE_SITE == jconv.EDGE_SITE
    assert conv._EDGE_TAP_GROUPS == jconv._EDGE_TAP_GROUPS


@pytest.mark.parametrize("i", range(len(MIXED_PLANS)))
def test_mixed_planned_edge_matches_reference(i):
    plan, jp = MIXED_PLANS[i]
    imgs = jimages.image_batch(2, 20, 24, seed=i)
    want = np.asarray(jconv.edge_detect_planned(imgs, jp))
    got = conv.edge_detect_planned(_t(imgs), plan)
    assert got.dtype == torch.uint8 and tuple(got.shape) == imgs.shape
    np.testing.assert_array_equal(got.numpy(), want)
    ragged = jimages.mixed_shape_batch(2, shapes=((9, 21), (12, 10)), seed=i)
    for img in ragged:
        np.testing.assert_array_equal(
            conv.edge_detect_planned(_t(img)[None], plan)[0].numpy(),
            np.asarray(jconv.edge_detect_planned(img[None], jp))[0])


@pytest.mark.parametrize("spec", ["exact", "approx_cuda:exact", "int8",
                                  "approx_cuda:csp_axc5@5", "approx_lut"])
def test_uniform_planned_edge_equals_batched(spec):
    imgs = jimages.image_batch(2, 16, 24, seed=3)
    planned = conv.edge_detect_planned(_t(imgs), splan.SubstratePlan.uniform(spec))
    np.testing.assert_array_equal(planned.numpy(),
                                  conv.edge_detect_batched(_t(imgs), spec).numpy())


@pytest.mark.parametrize("n_workers", [1, 2])
def test_service_serves_plan_like_direct_path(n_workers):
    plan = MIXED_PLANS[-1][0]
    imgs = jimages.mixed_shape_batch(6, shapes=((8, 8), (12, 10), (16, 16),
                                                (9, 21)), seed=4)
    svc = EdgeDetectService(plan, device="cpu", max_batch_size=2,
                            max_wait_s=1e-3, bucket_granularity=8,
                            n_workers=n_workers)
    try:
        got = svc.detect(imgs)
    finally:
        svc.close()
    assert svc.plan == splan.as_plan(plan)
    assert svc.spec == "plan(approx_cuda:proposed@8+2 rules)"
    assert svc.substrate.meta.spec == "approx_cuda:proposed"
    for img, out in zip(imgs, got):
        assert out.dtype == np.uint8 and out.shape == img.shape
        np.testing.assert_array_equal(
            out, conv.edge_detect_planned(_t(img)[None], plan)[0].numpy())
    assert svc.stats()["requests_served"] == len(imgs)
    assert json.loads(svc.plan.to_json()) == splan.as_plan(plan).to_dict()
