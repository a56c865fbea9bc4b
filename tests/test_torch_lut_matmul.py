"""Parity of the port's LUT-input contraction (``repro_torch.kernels.
lut_matmul``, CPU tensors → its plain version) with ``repro``'s Pallas kernel
(interpret mode off-TPU): the exhaustive N=4 operand grid for every wiring
and ``exact``, ragged shapes with a K tail (f(0,0) = 192 at proposed@8
shows there), batched operands, out-of-range operands that wrap, and the
table checks. Integer results are compared exactly."""
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.core import multiplier as jm
from repro.kernels.lut_matmul.kernel import table_width as j_table_width
from repro.kernels.lut_matmul.ops import lut_matmul as j_lut_matmul
from repro_torch.core import lut as tlut
from repro_torch.kernels.lut_matmul.ops import (device_table, lut_matmul,
                                                lut_matmul_plain, table_width)
from repro_torch.kernels.lut_matmul.ref import lut_matmul_ref

RNG = np.random.default_rng(12)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _table(key):
    return device_table(key, "cpu")


@pytest.mark.parametrize("name", sorted(jm.WIRINGS) + ["exact"])
def test_exhaustive_n4_matches_pallas_and_table(name):
    """(16,1)@(1,16): every operand pair once, K=1."""
    key = f"{name}@4"
    v = np.arange(-8, 8, dtype=np.int32)
    got = lut_matmul(_t(v[:, None]), _t(v[None, :]), _table(key)).numpy()
    np.testing.assert_array_equal(got, jlut.build_lut(key), err_msg=name)
    want = np.asarray(j_lut_matmul(v[:, None], v[None, :], jlut.flat_lut(key)))
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("mkn", [(1, 1, 1), (17, 33, 9), (5, 19, 3)])
@pytest.mark.parametrize("key", ["proposed", "exact", "design_strollo2020@4"])
def test_ragged_shapes_with_k_tail_match_pallas(mkn, key):
    m, k, n = mkn
    hi = 1 << (jm.split_width(key)[1] - 1)
    a = RNG.integers(-hi, hi, (m, k)).astype(np.int32)
    b = RNG.integers(-hi, hi, (k, n)).astype(np.int32)
    want = np.asarray(j_lut_matmul(a, b, jlut.flat_lut(key)))
    got = lut_matmul(_t(a), _t(b), _table(key)).numpy()
    np.testing.assert_array_equal(got, want, err_msg=f"{key} {mkn}")
    np.testing.assert_array_equal(
        lut_matmul_ref(_t(a), _t(b), _table(key)).numpy(), want)


def test_k_tail_keeps_f00_out_of_the_sum():
    """K=33 is no multiple of the plain version's slab nor of the kernel's
    tile: a padded zero would add f(0,0) = 192 (proposed@8) per padded
    element. The sum equals the sum of the K table reads and nothing else."""
    assert tlut.f00("proposed") == 192
    a = RNG.integers(-128, 128, (3, 33)).astype(np.int32)
    b = RNG.integers(-128, 128, (33, 2)).astype(np.int32)
    table = jlut.build_lut("proposed").astype(np.int64)
    want = table[a[:, :, None] + 128, b[None, :, :] + 128].sum(axis=1)
    got = lut_matmul(_t(a), _t(b), _table("proposed")).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))


def test_batched_equals_stacked_2d():
    a = RNG.integers(-128, 128, (3, 6, 21)).astype(np.int32)
    b = RNG.integers(-128, 128, (3, 21, 4)).astype(np.int32)
    got = lut_matmul(_t(a), _t(b), _table("csp_axc5")).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(j_lut_matmul(a[i], b[i], jlut.flat_lut("csp_axc5"))))


def test_out_of_range_operands_wrap_like_pallas():
    """As ``test_lut_kernel.py::test_lut_kernel_exhaustive_n4_out_of_range_wraps``:
    operands outside the signed N-bit range hit their low-N-bits entry."""
    a = RNG.integers(-2**31, 2**31 - 1, (6, 10), dtype=np.int64).astype(np.int32)
    b = RNG.integers(-40, 40, (10, 5)).astype(np.int32)
    want = np.asarray(j_lut_matmul(a, b, jlut.flat_lut("proposed@4")))
    got = lut_matmul(_t(a), _t(b), _table("proposed@4")).numpy()
    np.testing.assert_array_equal(got, want)
    wrapped = ((a.astype(np.int64) + 8) & 15) - 8
    np.testing.assert_array_equal(
        got, lut_matmul(_t(wrapped.astype(np.int32)), _t(b),
                        _table("proposed@4")).numpy())


def test_table_width_and_checks():
    for n in (1, 3, 4, 8):
        assert table_width(1 << (2 * n)) == j_table_width(1 << (2 * n)) == n
    with pytest.raises(ValueError, match="flat product-LUT length"):
        table_width(1000)
    a = torch.zeros((2, 3), dtype=torch.int32)
    b = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        lut_matmul(a, b, _table("proposed").to(torch.int64))
    with pytest.raises(ValueError, match="lies on"):
        lut_matmul(a, b, _table("proposed").to("meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        lut_matmul(a.to("meta"), b.to("meta"), _table("proposed").to("meta"))
    with pytest.raises(ValueError, match="mismatch"):
        lut_matmul(a, a, _table("proposed"))


def test_device_table_is_built_once_and_plain_runs_on_cpu():
    t = device_table("csp_axc1@6", "cpu")
    assert device_table("design_esposito2018@6", torch.device("cpu")) is t
    np.testing.assert_array_equal(t.numpy(), jlut.flat_lut("csp_axc1@6"))
    a = _t(RNG.integers(-32, 32, (1, 6, 7)).astype(np.int32))
    b = _t(RNG.integers(-32, 32, (1, 7, 5)).astype(np.int32))
    before = lut_matmul.launches.value
    got = lut_matmul(a, b, t)
    assert lut_matmul.launches.value == before  # no kernel launch on CPU
    np.testing.assert_array_equal(got.numpy(), lut_matmul_plain(a, b, t).numpy())
