"""The paper's tables in the port: error metrics (Table 4), the unit-gate
energy model (Table 5), and the six ``benchmarks/torch_*.py`` drivers,
held against ``repro`` on the CPU.

Every comparison is exact: the reports are numpy statistics over the same
int64 products, the energy model is the same Python arithmetic, and the
drivers' value fields are the same formatted strings (timings dropped).
Each package's exhaustive report of a design is computed once per module
(:func:`_once`): the report tests compare them, and the Table 4 and Fig. 10
drivers of both packages format the same reports.
"""
import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import energy as jenergy
from repro.core import metrics as jmetrics
from repro.core import multiplier as jmult
from repro_torch.core import energy, metrics
from repro_torch.core import multiplier as mult

ROOT = Path(__file__).resolve().parents[1]
WIDTH8 = [k for k in mult.ALL_MULTIPLIERS if "@" not in k]
WIDTH4 = [k for k in mult.ALL_MULTIPLIERS if k.endswith("@4")]
WIDTH16 = [k for k in mult.ALL_MULTIPLIERS if k.endswith("@16")]


_REPORTS: dict = {}


def _once(evaluate):
    """``evaluate`` computed once per (package, design, width) in this
    module."""
    def remembered(mult_fn, name="", n_bits=8, **kw):
        key = (evaluate.__module__, name, n_bits)
        if key not in _REPORTS:
            _REPORTS[key] = evaluate(mult_fn, name, n_bits, **kw)
        return _REPORTS[key]
    return remembered


def test_registries_match():
    assert list(mult.ALL_MULTIPLIERS) == list(jmult.ALL_MULTIPLIERS)
    assert mult.default_width_names() == jmult.default_width_names()
    assert metrics.PAPER_TABLE4 == jmetrics.PAPER_TABLE4
    assert metrics.MAX_EXHAUSTIVE_BITS == jmetrics.MAX_EXHAUSTIVE_BITS


@pytest.mark.parametrize("n_bits", [3, 4, 8])
def test_operand_grid_matches(n_bits):
    a, b = metrics.operand_grid(n_bits, device="cpu")
    ja, jb = jmetrics.operand_grid(n_bits)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    with pytest.raises(ValueError, match="evaluate_sampled"):
        metrics.operand_grid(13, device="cpu")


def test_sample_operands_match():
    a, b = metrics.sample_operands(16, 1000, seed=5, device="cpu")
    ja, jb = jmetrics.sample_operands(16, 1000, seed=5)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("name", WIDTH8 + WIDTH4)
def test_evaluate_equals_repro(name):
    n = 4 if name.endswith("@4") else 8
    got = _once(metrics.evaluate)(mult.ALL_MULTIPLIERS[name], name, n,
                                  device="cpu")
    want = _once(jmetrics.evaluate)(jmult.ALL_MULTIPLIERS[name], name, n)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()


@pytest.mark.parametrize("name", WIDTH16)
def test_evaluate_sampled_equals_repro(name):
    got = metrics.evaluate_sampled(mult.ALL_MULTIPLIERS[name], name, 16,
                                   n_samples=1 << 14, seed=3, device="cpu")
    want = jmetrics.evaluate_sampled(jmult.ALL_MULTIPLIERS[name], name, 16,
                                     n_samples=1 << 14, seed=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_evaluate_all_equals_repro():
    fns = {k: mult.ALL_MULTIPLIERS[k] for k in WIDTH4}
    jfns = {k: jmult.ALL_MULTIPLIERS[k] for k in WIDTH4}
    got = metrics.evaluate_all(fns, 4, device="cpu")
    want = jmetrics.evaluate_all(jfns, 4)
    assert list(got) == list(want)
    assert all(dataclasses.asdict(got[k]) == dataclasses.asdict(want[k])
               for k in want)


def test_evaluate_defaults_to_cuda():
    fn = mult.ALL_MULTIPLIERS["proposed@4"]
    if torch.cuda.is_available():
        assert metrics.operand_grid(4)[0].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        metrics.evaluate(fn, "proposed@4", 4)


def test_proposed_within_paper_bands():
    rep = _once(metrics.evaluate)(mult.ALL_MULTIPLIERS["proposed"], "proposed",
                                  device="cpu")
    paper = metrics.PAPER_TABLE4["proposed"]
    assert abs(rep.nmed * 100 - paper["nmed"]) < 0.035
    assert abs(rep.mred * 100 - paper["mred"]) < 0.2


# ---------------------------------------------------------------------------
# energy model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("design", list(jenergy.DESIGNS))
def test_multiplier_cost_and_estimate_equal_repro(design):
    for n in range(3, 17):
        assert dataclasses.asdict(energy.multiplier_cost(design, n)) == \
            dataclasses.asdict(jenergy.multiplier_cost(design, n)), (design, n)
        assert energy.estimate(design, n) == jenergy.estimate(design, n)


def test_table5_and_savings_equal_repro():
    assert energy.table5() == jenergy.table5()
    assert energy.PAPER_TABLE5 == jenergy.PAPER_TABLE5
    for d in energy.DESIGNS:
        for base in ("exact", "design_du2022"):
            assert energy.savings_vs(d, base) == jenergy.savings_vs(d, base)


def test_framework_heights_and_reduction_equal_repro():
    for n in range(3, 17):
        for four in (False, True):
            h = energy._framework_heights(four, n)
            assert h == jenergy._framework_heights(four, n)
            assert energy.reduce_columns(h) == jenergy.reduce_columns(h)


# ---------------------------------------------------------------------------
# the paper-table drivers
# ---------------------------------------------------------------------------

DRIVERS = ["table2_compressors", "table3_compressor4", "table4_errors",
           "table5_hardware", "fig9_edge", "fig10_tradeoff"]
#: rows whose third field describes the run instead of a computed value
_DESCRIPTIVE = {"fig9/pallas_fused_conv": "interpret=True",
                "fig9/cuda_fused_conv": "device=cpu"}


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"_drv_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _values(rows) -> dict:
    """{row name: value field}, the backend alias folded onto repro's name
    and the descriptive rows checked, then dropped."""
    out = {}
    for name, _us, value in rows:
        if name in _DESCRIPTIVE:
            assert value == _DESCRIPTIVE[name], (name, value)
            continue
        out[name.replace("approx_cuda", "approx_pallas")] = value
    return out


@pytest.mark.parametrize("name", DRIVERS)
def test_torch_driver_values_equal_jax_driver(name, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setattr(metrics, "evaluate", _once(metrics.evaluate))
    monkeypatch.setattr(jmetrics, "evaluate", _once(jmetrics.evaluate))
    with contextlib.redirect_stdout(io.StringIO()):
        got = _load(ROOT / "benchmarks" / f"torch_{name}.py").run(device="cpu")
        want = _load(ROOT / "benchmarks" / f"{name}.py").run()
    assert _values(got) == _values(want)


def test_fig9_driver_width_rows_take_the_alias():
    """The ``approx_pallas:*`` width specs resolve onto ``approx_cuda``."""
    drv = _load(ROOT / "benchmarks" / "torch_fig9_edge.py")
    from repro_torch.nn import substrate as sub

    pallas = [s for s in drv.WIDTH_SPECS if s.startswith("approx_pallas")]
    assert pallas and all(sub.get_substrate(s).meta.name == "approx_cuda"
                          for s in pallas)
