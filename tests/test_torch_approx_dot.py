"""The port's ``nn.approx_dot`` façade against ``repro``'s, on the CPU: the
``approx_dot`` cases of ``tests/test_nn.py`` on the same numpy inputs.

Integer contractions are compared exactly. ``approx_dot`` quantizes the
same float32 inputs to the same codes, contracts them exactly and rescales
in float32: the same floats under every quantizing mode, within 1e-6 of
``repro``'s float32 dot under ``exact``.
"""
import numpy as np
import pytest
import torch

from repro.core import lut as lut_lib
from repro.nn import approx_dot as jad
from repro_torch.nn import approx_dot as ad
from repro_torch.nn import substrate as sub

RNG = np.random.default_rng(7)
INT_MODES = ["approx_bitexact", "approx_lut", "int8", "approx_stat",
             "approx_cuda", "exact"]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("mode", INT_MODES)
def test_approx_matmul_int_equals_repro(mode):
    a8 = RNG.integers(-128, 128, (24, 40)).astype(np.int8)
    b8 = RNG.integers(-128, 128, (40, 8)).astype(np.int8)
    jmode = mode.replace("approx_cuda", "approx_pallas")
    want = np.asarray(jad.approx_matmul_int(a8, b8, mode=jmode))
    np.testing.assert_array_equal(
        ad.approx_matmul_int(_t(a8), _t(b8), mode=mode).numpy(), want)
    np.testing.assert_array_equal(
        ad.approx_matmul_int8(_t(a8), _t(b8), mode=mode).numpy(), want)


def test_bitexact_equals_lut_mode_and_dense_oracle():
    a8 = RNG.integers(-128, 128, (9, 21)).astype(np.int8)
    b8 = RNG.integers(-128, 128, (21, 5)).astype(np.int8)
    table = lut_lib.build_lut("proposed").astype(np.int64)
    oracle = table[a8.astype(np.int64)[:, :, None] + 128,
                   b8.astype(np.int64)[None, :, :] + 128].sum(axis=1)
    for mode in ("approx_bitexact", "approx_lut", "approx_cuda"):
        np.testing.assert_array_equal(
            ad.approx_matmul_int8(_t(a8), _t(b8), mode=mode).numpy(), oracle)


@pytest.mark.parametrize("mult_name", ["design_du2022", "proposed@6",
                                       "csp_axc1@4"])
def test_mult_name_overrides_the_suffix(mult_name):
    a = RNG.integers(-8, 8, (6, 10)).astype(np.int8)
    b = RNG.integers(-8, 8, (10, 3)).astype(np.int8)
    want = np.asarray(jad.approx_matmul_int(a, b, mode="approx_lut:proposed",
                                            mult_name=mult_name))
    got = ad.approx_matmul_int(_t(a), _t(b), mode="approx_lut:proposed",
                               mult_name=mult_name)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["exact", "int8", "approx_bitexact",
                                  "approx_lut", "approx_stat", "approx_cuda"])
def test_approx_dot_modes_equal_repro(mode):
    x = RNG.normal(size=(4, 6, 48)).astype(np.float32)
    w = RNG.normal(size=(48, 24)).astype(np.float32)
    want = np.asarray(jad.approx_dot(x, w, mode=mode.replace(
        "approx_cuda", "approx_pallas")))
    got = ad.approx_dot(_t(x), _t(w), mode=mode).numpy()
    assert got.shape == want.shape == (4, 6, 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 if mode == "exact" else 0)
    ref = x @ w
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    budget = {"exact": 1e-6, "int8": 0.05}.get(mode, 0.2)
    assert rel < budget, (mode, rel)


def test_approx_dot_k_not_multiple_of_chunk():
    x = RNG.normal(size=(3, 19)).astype(np.float32)
    w = RNG.normal(size=(19, 5)).astype(np.float32)
    got = ad.approx_dot(_t(x), _t(w), mode="approx_bitexact")
    want = np.asarray(jad.approx_dot(x, w, mode="approx_bitexact"))
    assert got.shape == (3, 5) and bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(got.numpy(), want)


def test_approx_dot_general_front_door():
    x = RNG.integers(-100, 100, (2, 5, 7)).astype(np.int32)
    w = RNG.integers(-100, 100, (2, 7, 3)).astype(np.int32)
    dims = (((2,), (1,)), ((0,), (0,)))
    want = np.asarray(jad.approx_dot_general(
        x, w, jad.sub.ContractionSpec(dims), mode="approx_lut:csp_axc1"))
    got = ad.approx_dot_general(_t(x), _t(w), sub.ContractionSpec(dims),
                                mode="approx_lut:csp_axc1")
    np.testing.assert_array_equal(got.numpy(), want)
    # None spec: plain integer matmul dims
    a = RNG.integers(-100, 100, (4, 6)).astype(np.int32)
    b = RNG.integers(-100, 100, (6, 2)).astype(np.int32)
    np.testing.assert_array_equal(
        ad.approx_dot_general(_t(a), _t(b), mode="int8").numpy(), a @ b)
