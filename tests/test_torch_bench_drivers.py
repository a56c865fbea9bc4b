"""The port's bench drivers (``benchmarks/torch_{kernelbench,edge_serving,
autotune_plan,qat_recovery,run}.py``) against ``repro``'s, on the CPU.

Each driver runs with ``device="cpu"`` (its kernels' plain versions), its
JSON into ``tmp_path``; ``repro``'s drivers run only with
``json_path=None`` (or a dry run, which writes nothing), and ``repro``'s
committed ``BENCH_*.json`` give the record keys of its full runs. Bars:

* ``torch_kernelbench``: the records of each section carry ``repro``'s
  keys, the ``designs`` section (each design of the two contraction
  kernels, equal to the tile design) in the place of ``kslab``; the
  registry sweep is ``repro``'s registry with the alias once, as
  ``approx_cuda``;
* ``torch_edge_serving``: its rows are ``repro``'s dry run's, row for row,
  its payload carries ``repro``'s keys, every worker-sweep row is
  bit-identical;
* ``torch_autotune_plan``: its rows equal ``repro``'s (PSNR to 0.01 dB,
  PDP to 1 fJ, the accepted moves), the PDP figures ``repro``'s as floats
  and the PSNRs (the stat-scored budget too) within ``PSNR_ATOL_DB``;
* ``torch_qat_recovery``: per edge row ``psnr_pre_db`` within
  ``PSNR_ATOL_DB`` and ``plan_pdp_fj`` / ``pdp_per_mac_fj`` equal as
  floats, ``psnr_post_db`` within ``test_torch_qat.py``'s calibrated bar
  (rel 1e-3); the LM row, from ``repro``'s initial parameters, within
  ``LM_LOSS_RTOL``; a full run with no recovered point raises;
* ``torch_run``: ``repro``'s bench names, ``--json-dir`` routes each
  ``BENCH_torch_*.json``, ``--sharded`` raises.
"""
import contextlib
import importlib
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.nn import substrate as jsub
from repro_torch.models import convert

ROOT = Path(__file__).resolve().parents[1]
#: PSNRs: both packages take the mean squared error in float32, summed in
#: their own orders (torch's and XLA's reductions): over the 24576 pixels
#: of 6 × 64 × 64 maps the two sums differ by up to ~15 ulps (1.4e-5 dB);
#: the maps they are taken from are equal bit for bit
PSNR_ATOL_DB = 1e-4
#: the QAT LM rows' losses: both packages train the reduced model in
#: bfloat16 (XLA and torch round its matmuls in different orders), 3 + 3
#: AdamW steps; they differ by up to 6.5e-4 relative (the approximate
#: forward's int8 codes move with the rounding)
LM_LOSS_RTOL = 5e-3
#: psnr_post_db after the calibrated fine-tune (tests/test_torch_qat.py)
PSNR_POST_RTOL = 1e-3
_ONCE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module: the test runner's workers share the
    machine's cores, which intra-op threads would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def once(key, fn):
    """``fn()`` computed once per ``key`` in this process."""
    if key not in _ONCE:
        _ONCE[key] = fn()
    return _ONCE[key]


@pytest.fixture(autouse=True)
def _benchmarks_importable(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))


def bench(name: str):
    return importlib.import_module(f"benchmarks.{name}")


def quiet(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _keys_by_section(records) -> dict:
    out: dict = {}
    for r in records:
        out.setdefault(r["section"], set()).update(r)
    return out


# ---------------------------------------------------------------------------
# torch_kernelbench
# ---------------------------------------------------------------------------


def _kernelbench(tmp_path_factory):
    def go():
        path = tmp_path_factory.mktemp("kernelbench") / "k.json"
        rows, _ = quiet(bench("torch_kernelbench").run, dry_run=True,
                        json_path=path, device="cpu")
        return rows, json.loads(path.read_text())
    return once("kernelbench", go)


def test_kernelbench_records_have_repros_keys(tmp_path_factory):
    rows, payload = _kernelbench(tmp_path_factory)
    want = json.loads((ROOT / "BENCH_kernels.json").read_text())
    assert set(payload) == set(want) - {"interpret"} | {"card"}
    assert payload["backend"] == "cpu" and payload["card"] is None
    assert payload["dry_run"] is True
    got_keys = _keys_by_section(payload["records"])
    want_keys = _keys_by_section(want["records"])
    kslab = want_keys.pop("kslab")
    designs = got_keys.pop("designs")
    assert got_keys == want_keys
    assert designs == (kslab - {"k_chunk", "speedup_vs_fori"}
                       | {"design", "ran", "speedup_vs_tile", "equal_to_tile"})
    assert len(rows) == len(payload["records"])


def test_kernelbench_sweeps_the_registry_once_and_every_design(tmp_path_factory):
    from repro_torch.kernels import blocking

    _, payload = _kernelbench(tmp_path_factory)
    specs = [r["spec"] for r in payload["records"] if r["section"] == "substrates"]
    assert specs == sorted(s.replace("approx_pallas", "approx_cuda")
                           for s in jsub.list_substrates())
    designs = [(r["kernel"], r["design"]) for r in payload["records"]
               if r["section"] == "designs"]
    eligible = [d for d, ok in blocking.eligible_designs(32, 32, 32, 8).items()
                if ok]
    assert designs == [("closed_form_matmul", "tile"), ("closed_form_matmul", "rows"),
                       ("lut_matmul", "tile"), ("lut_matmul", "rows"),
                       ("lut_matmul", "gather")]
    assert eligible == ["rows", "tile"]
    assert all(r["equal_to_tile"] for r in payload["records"]
               if r["section"] == "designs")


def _sharded_records(path):
    return [r for r in json.loads(path.read_text())["records"]
            if r["section"] == "sharded"]


def test_kernelbench_sharded_raises(tmp_path):
    """Named when ``--sharded`` raised; it now checks the sharded rows at a
    world of one: the reference's record keys, one row per substrate, each
    held to the unsharded result inside the bench."""
    path = tmp_path / "k.json"
    rows, printed = quiet(bench("torch_kernelbench").run, sharded=True,
                          dry_run=True, json_path=path, device="cpu",
                          substrates=["approx_lut", "exact", "approx_stat"])
    recs = _sharded_records(path)
    assert [r["spec"] for r in recs] == ["approx_lut", "exact", "approx_stat"]
    assert all(set(r) == {"section", "kernel", "spec", "us", "gmacs", "devices"}
               and r["devices"] == 1 for r in recs)
    assert [n for n, _, _ in rows if n.startswith("kernel/sharded_")] == [
        "kernel/sharded_approx_lut", "kernel/sharded_exact",
        "kernel/sharded_approx_stat"]
    assert "sharded dot_general (mesh {'data': 1, 'model': 1}" in printed


def test_kernelbench_sharded_on_two_ranks(tmp_path):
    """Two gloo ranks (a 1 × 2 mesh): rank 0 alone prints and writes, both
    time the sharded rows."""
    from tests import test_torch_ranks as tr

    ranks = tr.spawn("driver_program", 2, tmp_path, "kernelbench",
                     str(tmp_path))
    recs = _sharded_records(tmp_path / "k.json")
    assert [r["spec"] for r in recs] == ["approx_lut", "int8",
                                         "approx_cuda:csp_axc1@4"]
    assert {r["devices"] for r in recs} == {2}
    assert "'model': 2" in ranks[0]["printed"] and ranks[1]["printed"] == ""
    assert ranks[1]["rows"] == [] and ranks[0]["rows"]


# ---------------------------------------------------------------------------
# torch_edge_serving
# ---------------------------------------------------------------------------


def test_edge_serving_dry_run_rows_and_keys_are_repros(tmp_path):
    path = tmp_path / "s.json"
    got, _ = quiet(bench("torch_edge_serving").run, dry_run=True,
                   json_path=path, device="cpu")
    want, _ = quiet(bench("edge_serving").run, dry_run=True, json_path=None)
    assert [r[0] for r in got] == [r[0] for r in want]
    payload = json.loads(path.read_text())
    ref = json.loads((ROOT / "BENCH_serving.json").read_text())
    assert set(payload) == set(ref) | {"card"}
    assert set(payload["records"][0]) == set(ref["records"][0])
    sweep = payload["worker_sweep"]
    assert set(sweep) == set(ref["worker_sweep"]) - {"cpu_sync_dispatch"} | {"device"}
    assert all(set(r) == set(ref["worker_sweep"]["rows"][0]) for r in sweep["rows"])
    assert [(r["mode"], r["workers"]) for r in sweep["rows"]] == [
        ("host", 1), ("host", 2), ("emulated", 1), ("emulated", 2)]
    assert all(r["bit_identical_to_1worker"] for r in sweep["rows"])
    assert payload["records"][0]["requests"] == 6


def test_edge_serving_default_substrates_add_approx_cuda():
    drv, ref = bench("torch_edge_serving"), bench("edge_serving")
    assert drv.DEFAULT_SUBSTRATES == (*ref.DEFAULT_SUBSTRATES, "approx_cuda")
    assert (drv.SETTINGS, drv.WORKER_COUNTS, drv.WORKER_SWEEP_BATCH) == (
        ref.SETTINGS, ref.WORKER_COUNTS, ref.WORKER_SWEEP_BATCH)


# ---------------------------------------------------------------------------
# torch_autotune_plan
# ---------------------------------------------------------------------------


def test_autotune_plan_equals_repro(tmp_path):
    path = tmp_path / "a.json"
    got, _ = quiet(bench("torch_autotune_plan").run, json_path=path, device="cpu")
    want, _ = quiet(bench("autotune_plan").run, json_path=None)
    assert [(n, d) for n, _, d in got] == [(n, d) for n, _, d in want]
    payload = json.loads(path.read_text())
    ref = json.loads((ROOT / "BENCH_autotune.json").read_text())
    assert set(payload) == set(ref) | {"backend", "card"}
    assert payload["search"]["accepted_moves"] == ref["search"]["accepted_moves"]
    assert payload["search"]["rolled_back"] == ref["search"]["rolled_back"]
    assert abs(payload["search"]["budget_scored_db"]
               - ref["search"]["budget_scored_db"]) <= PSNR_ATOL_DB
    for name in ("uniform", "plan"):
        g, w = payload[name], ref[name]
        assert g["plan"] == w["plan"] and g["site_macs"] == w["site_macs"]
        assert g["pdp_fj"] == w["pdp_fj"]
        assert abs(g["psnr_db"] - w["psnr_db"]) <= PSNR_ATOL_DB
    assert payload["energy_saved_frac"] == ref["energy_saved_frac"]


# ---------------------------------------------------------------------------
# torch_qat_recovery
# ---------------------------------------------------------------------------


def _qat_pair(monkeypatch_spec):
    """(port's dry-run measurement, repro's edge rows, repro's LM rows),
    repro's edge rows on approx_lut (the same integers as its bit-exact
    substrate) and its LM from its own PRNGKey(0) init, which the port
    starts from too."""
    from repro.data import image_batch
    from repro.models import registry as jreg

    drv, ref = bench("torch_qat_recovery"), bench("qat_recovery")
    jb = jreg.get_bundle(ref.LM_ARCH, dot_plan="exact", **ref.LM_OVERRIDES)
    # copies: the port trains its parameters in place, and a tensor made
    # from a numpy view would write into repro's buffers
    tree = jax.tree.map(np.array, jb.init_params(jax.random.PRNGKey(0)))

    def init(bundle, device):
        return convert.lm_params_from_jax(bundle.cfg, tree).to(device)

    got, _ = quiet(drv.measure, dry_run=True, device="cpu", init_params=init)
    with monkeypatch_spec(ref):
        want_edge = ref._edge_rows(image_batch(2, 24, 24), steps=4)
    want_lm = ref._lm_rows(pretrain_steps=3, qat_steps=3, widths=(8,))
    return got, want_edge, want_lm


@contextlib.contextmanager
def _lut_specs(ref):
    spec = ref._spec
    ref._spec = lambda wiring, width: f"approx_lut:{wiring}@{width}"
    try:
        yield
    finally:
        ref._spec = spec


def test_qat_recovery_rows_equal_repro():
    got, want_edge, want_lm = once("qat", lambda: _qat_pair(_lut_specs))
    assert got["images"] == (2, 24, 24)
    assert [(r["wiring"], r["width"]) for r in got["edge"]] == [
        (r["wiring"], r["width"]) for r in want_edge]
    for g, w in zip(got["edge"], want_edge):
        assert g["spec"] == w["spec"].replace("approx_lut", "approx_bitexact")
        assert abs(g["psnr_pre_db"] - w["psnr_pre_db"]) <= PSNR_ATOL_DB, g["spec"]
        assert g["plan_pdp_fj"] == w["plan_pdp_fj"]
        assert g["pdp_per_mac_fj"] == w["pdp_per_mac_fj"]
        assert g["psnr_post_db"] == pytest.approx(w["psnr_post_db"],
                                                  rel=PSNR_POST_RTOL)
        assert g["psnr_post_db"] >= g["psnr_pre_db"]
    assert len(got["lm"]) == len(want_lm) == 1
    g, w = got["lm"][0], want_lm[0]
    assert (g["spec"], g["pdp_per_mac_fj"]) == (w["spec"], w["pdp_per_mac_fj"])
    for k in ("loss_exact", "loss_pre", "loss_post"):
        assert g[k] == pytest.approx(w[k], rel=LM_LOSS_RTOL), k
    assert set(g) == set(w)


def test_qat_recovery_run_reports_and_gates(tmp_path, monkeypatch):
    """``run`` over the measurement above: repro's row names, no JSON on a
    dry run, and a full run with no recovered point raises."""
    got, _, _ = once("qat", lambda: _qat_pair(_lut_specs))
    drv = bench("torch_qat_recovery")
    monkeypatch.setattr(drv, "measure", lambda *a, **k: got)
    path = tmp_path / "q.json"
    rows, printed = quiet(drv.run, dry_run=True, json_path=path, device="cpu")
    assert [r[0] for r in rows] == [
        f"qat/edge/{w}@{n}" for w in drv.WIRINGS for n in drv.WIDTHS] + [
        "qat/lm/proposed@8"]
    assert not path.exists()
    assert "[qat] recovered point" in printed
    rows, _ = quiet(drv.run, dry_run=False, json_path=path, device="cpu")
    payload = json.loads(path.read_text())
    ref = json.loads((ROOT / "BENCH_qat.json").read_text())
    assert set(payload) == set(ref) | {"backend", "card"}
    assert set(payload["edge"][0]) == set(ref["edge"][0])
    assert set(payload["lm"][0]) == set(ref["lm"][0])
    flat = {**got, "edge": [dict(r, psnr_post_db=r["psnr_pre_db"] - 1)
                            for r in got["edge"]]}
    monkeypatch.setattr(drv, "measure", lambda *a, **k: flat)
    with pytest.raises(AssertionError, match="no recovered operating point"):
        quiet(drv.run, dry_run=False, json_path=None, device="cpu")


# ---------------------------------------------------------------------------
# torch_run
# ---------------------------------------------------------------------------


def test_run_has_repros_benches_and_routes_json(tmp_path, monkeypatch):
    drv = bench("torch_run")
    ref_names = ("table2", "table3", "table4", "table5", "fig9", "fig10",
                 "kernel", "serve_edge", "autotune", "qat")
    assert tuple(drv.MODULES) == ref_names
    seen = {}
    for name in ("kernel", "serve_edge", "autotune", "qat"):
        monkeypatch.setattr(drv.MODULES[name], "run",
                            lambda _n=name, **kw: seen.setdefault(_n, kw) and [])
    rows, printed = quiet(drv.main, ["--only", "table5", "--device", "cpu"])
    assert rows and printed.splitlines()[-len(rows) - 1] == \
        "name,us_per_call,derived"
    for name in ("kernel", "serve_edge", "autotune", "qat"):
        quiet(drv.main, ["--only", name, "--device", "cpu", "--json-dir",
                         str(tmp_path)])
        assert seen[name]["json_path"] == \
            tmp_path / drv.MODULES[name].DEFAULT_JSON.name
        assert seen[name]["device"] == torch.device("cpu")
    assert ("substrates" in seen["kernel"]) and ("plan" in seen["autotune"])


def test_run_sharded_raises(monkeypatch):
    """Named when ``--sharded`` raised; at a world of one it now hands the
    kernel bench ``sharded=True`` and the backend, as the reference's
    harness hands it ``sharded``."""
    drv = bench("torch_run")
    seen = {}
    monkeypatch.setattr(drv.MODULES["kernel"], "run",
                        lambda **kw: seen.update(kw) or [])
    quiet(drv.main, ["--only", "kernel", "--sharded", "--device", "cpu"])
    assert seen["sharded"] is True and seen["backend"] == "gloo"


def test_run_sharded_on_two_ranks(tmp_path):
    """``torch_run --only kernel --sharded`` on two gloo ranks (the kernel
    bench cut to its dry-run shapes): rank 0 prints the CSV and writes the
    JSON with the sharded rows, rank 1 prints nothing."""
    from tests import test_torch_ranks as tr

    ranks = tr.spawn("driver_program", 2, tmp_path, "run", str(tmp_path))
    recs = _sharded_records(tmp_path / "BENCH_torch_kernels.json")
    assert [(r["spec"], r["devices"]) for r in recs] == [("approx_lut", 2),
                                                        ("exact", 2)]
    assert "kernel/sharded_approx_lut," in ranks[0]["printed"]
    assert ranks[1]["printed"] == ""
