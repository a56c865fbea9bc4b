"""The decode and tensor designs of the port's two contraction kernels, on
the CPU.

``csrc/decode_contract.cuh`` contracts few rows (M ≤ 16) against the whole
int16 product table; its plain twin is ``blocking.decode_matmul_plain``
with ``closed_form_table16`` (``kernels.approx_matmul``, built from the
closed form) or ``lut_matmul.table16`` (the int16 twin of a flat table).
``lut_matmul``'s tensor design computes the exact product on the INT8
tensor cores; its plain twin is ``blocking.tensor_matmul_plain``. Here both
twins are held exactly against ``repro``'s Pallas kernels (interpret mode
off-TPU) at M ∈ {1, 3, 8, 13, 16}, ragged K up to ~300 and N up to ~200,
every wiring at widths 3..8 and ``exact``, batched operands, out-of-range
int32 operands that wrap; int8 and int32 operands against each other
through the wrappers; ``approx_matmul_ref`` against ``repro``'s; and the
dispatch rules ``blocking.decode_design`` / ``tensor_design`` and the
exact-table mark on both sides of each threshold.
"""
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.core import multiplier as jm
from repro.kernels.approx_matmul.ops import closed_form_matmul as j_cfm
from repro.kernels.approx_matmul.ref import approx_matmul_ref as j_ref
from repro.kernels.lut_matmul.ops import lut_matmul as j_lut_matmul
from repro_torch.kernels import blocking
from repro_torch.kernels.approx_matmul import ops as am
from repro_torch.kernels.approx_matmul.ref import approx_matmul_ref
from repro_torch.kernels.lut_matmul import ops as lm

RNG = np.random.default_rng(16)
WIRINGS = sorted(jm.WIRINGS)
WIDTHS = range(3, 9)
ROWS = (1, 3, 8, 13, 16)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _shape(i: int):
    """(M, K, N) cycling M through ROWS, ragged K in 17..~300, N in 9..~200."""
    return ROWS[i % len(ROWS)], 17 + (37 * i) % 283, 9 + (53 * i) % 191


def _operands(m, k, n, n_bits, bsz=None, wide=False):
    hi = 1 << (n_bits - 1)
    lead = () if bsz is None else (bsz,)
    if wide:  # anywhere in int32: wraps to the low n bits
        a = RNG.integers(-2**31, 2**31, lead + (m, k), dtype=np.int64)
        b = RNG.integers(-2**31, 2**31, lead + (k, n), dtype=np.int64)
    else:
        a = RNG.integers(-hi, hi, lead + (m, k))
        b = RNG.integers(-hi, hi, lead + (k, n))
    return a.astype(np.int32), b.astype(np.int32)


def _squeeze(out, a):
    return out.numpy() if a.ndim == 3 else out[0].numpy()


def _closed_form_decode(a, b, key):
    n_bits = jm.split_width(key)[1]
    a3, b3 = blocking.as3(_t(a), _t(b))
    table = am.closed_form_table16(key, "cpu")
    return _squeeze(blocking.decode_matmul_plain(a3, b3, table, n_bits), a)


def _table_decode(a, b, key):
    table = lm.device_table(key, "cpu")
    a3, b3 = blocking.as3(_t(a), _t(b))
    return _squeeze(blocking.decode_matmul_plain(
        a3, b3, lm.table16(table), lm.table_width(table.shape[0])), a)


def _tensor(a, b):
    a3, b3 = blocking.as3(_t(a), _t(b))
    return _squeeze(blocking.tensor_matmul_plain(a3, b3), a)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", WIRINGS)
def test_decode_twin_matches_pallas(name, width):
    """Every wiring at widths 3..8: the closed-form table and the product
    table through the decode twin, against repro's closed-form kernel."""
    key = f"{name}@{width}"
    m, k, n = _shape(WIRINGS.index(name) * 6 + width)
    assert blocking.decode_design(m, k, n, width)
    a, b = _operands(m, k, n, width)
    want = np.asarray(j_cfm(a, b, key))
    np.testing.assert_array_equal(_closed_form_decode(a, b, key), want,
                                  err_msg=f"{key} {(m, k, n)}")
    np.testing.assert_array_equal(_table_decode(a, b, key), want)


@pytest.mark.parametrize("width", WIDTHS)
def test_exact_table_decode_twin_matches_pallas(width):
    key = f"exact@{width}"
    m, k, n = _shape(width + 40)
    a, b = _operands(m, k, n, width)
    want = np.asarray(j_lut_matmul(a, b, jlut.flat_lut(key)))
    np.testing.assert_array_equal(_table_decode(a, b, key), want,
                                  err_msg=f"{key} {(m, k, n)}")


@pytest.mark.parametrize("m", ROWS)
def test_tensor_twin_matches_pallas(m):
    """The exact product at width 8: the tensor twin (an int64 matmul of the
    codes) and the decode twin against repro's LUT kernel."""
    k, n = 250 + 9 * m, 190 - 5 * m
    assert blocking.tensor_design(m, k, n, 8)
    a, b = _operands(m, k, n, 8)
    want = np.asarray(j_lut_matmul(a, b, jlut.flat_lut("exact")))
    np.testing.assert_array_equal(_tensor(a, b), want)
    np.testing.assert_array_equal(_table_decode(a, b, "exact"), want)


@pytest.mark.parametrize("key", ["proposed", "csp_axc1@6", "exact", "exact@5"])
def test_batched_with_a_different_b_per_batch(key):
    width = jm.split_width(key)[1]
    a, b = _operands(8, 123, 77, width, bsz=3)
    assert len({b[i].tobytes() for i in range(3)}) == 3
    got = _table_decode(a, b, key)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(j_lut_matmul(a[i], b[i], jlut.flat_lut(key))))
    if not key.startswith("exact"):
        cf = _closed_form_decode(a, b, key)
        np.testing.assert_array_equal(cf, got)
    elif width == 8:
        np.testing.assert_array_equal(_tensor(a, b), got)


@pytest.mark.parametrize("key", ["proposed@4", "design_strollo2020@5",
                                 "csp_axc5@8", "exact"])
def test_out_of_range_operands_wrap_like_pallas(key):
    """Operands anywhere in int32 wrap to their low n bits in repro; the
    twins (and codes8, the tensor and decode designs' int8 narrowing) wrap
    the same way."""
    width = jm.split_width(key)[1]
    a, b = _operands(13, 70, 33, width, wide=True)
    want = np.asarray(j_lut_matmul(a, b, jlut.flat_lut(key)))
    np.testing.assert_array_equal(_table_decode(a, b, key), want)
    a8, b8 = blocking.codes8(_t(a)), blocking.codes8(_t(b))
    assert a8.dtype == torch.int8
    np.testing.assert_array_equal(_table_decode(a8.numpy(), b8.numpy(), key), want)
    if key == "exact":
        np.testing.assert_array_equal(_tensor(a, b), want)
    else:
        np.testing.assert_array_equal(want, np.asarray(j_cfm(a, b, key)))
        np.testing.assert_array_equal(_closed_form_decode(a, b, key), want)


@pytest.mark.parametrize("key", ["proposed@8", "csp_axc1@6", "exact"])
def test_int8_and_int32_operands_give_the_same_integers(key):
    """Through closed_form_matmul / lut_matmul on the CPU (the plain
    versions), int8 codes and the same values in int32 agree, 2-D and
    batched."""
    a, b = _operands(8, 200, 150, 8, bsz=2)
    for sl in (np.s_[0], np.s_[:]):
        a32, b32 = _t(a[sl]), _t(b[sl])
        a8, b8 = a32.to(torch.int8), b32.to(torch.int8)
        if key == "exact":
            t = lm.device_table(key, "cpu")
            got8, got32 = lm.lut_matmul(a8, b8, t), lm.lut_matmul(a32, b32, t)
        else:
            got8 = am.closed_form_matmul(a8, b8, key)
            got32 = am.closed_form_matmul(a32, b32, key)
        assert got8.dtype == torch.int32
        torch.testing.assert_close(got8, got32, rtol=0, atol=0)


def test_as3_keeps_integer_dtypes():
    a8 = torch.zeros((3, 4), dtype=torch.int8)
    b8 = torch.zeros((4, 5), dtype=torch.int8)
    a3, b3 = blocking.as3(a8, b8)
    assert a3.dtype == b3.dtype == torch.int8 and a3.shape == (1, 3, 4)
    assert a3.data_ptr() == a8.data_ptr()  # a view: no copy
    af, _ = blocking.as3(a8.float(), b8)
    assert af.dtype == torch.int32
    with pytest.raises(ValueError, match="shape mismatch"):
        blocking.as3(a8, b8[:3])


@pytest.mark.parametrize("width", [4, 6, 8])
@pytest.mark.parametrize("name", WIRINGS)
def test_closed_form_table_equals_flat_lut(name, width):
    key = f"{name}@{width}"
    table = am.closed_form_table16(key, "cpu")
    assert table.dtype == torch.int16 and table.shape == (1 << (2 * width),)
    np.testing.assert_array_equal(table.numpy(), jlut.flat_lut(key))


def test_approx_matmul_ref_matches_repro():
    a, b = _operands(9, 37, 21, 8)
    want = np.asarray(j_ref(a, b))
    np.testing.assert_array_equal(approx_matmul_ref(a, b).numpy(), want)
    np.testing.assert_array_equal(
        am.closed_form_matmul(_t(a), _t(b), "proposed").numpy(), want)


@pytest.mark.parametrize("m,k,n,n_bits,decode", [
    (8, 4096, 4096, 8, True), (8, 16384, 4096, 8, True),    # the LM shapes
    (1, 17, 1, 8, True), (16, 17, 1, 8, True), (17, 17, 1, 8, False),  # M
    (0, 64, 64, 8, False),
    (8, 16, 8, 8, False), (8, 17, 8, 8, True), (8, 16, 9, 8, True),  # narrow
    (8, 64, 64, 1, True), (8, 64, 64, 9, False), (8, 64, 64, 0, False),  # width
    (8, 0, 64, 8, False), (8, 64, 0, 8, False),  # empty
])
def test_decode_design_thresholds(m, k, n, n_bits, decode):
    assert blocking.decode_design(m, k, n, n_bits) is decode


@pytest.mark.parametrize("m,k,n,n_bits,tensor", [
    (8, 4096, 1024, 8, True), (16, 131071, 17, 8, True),
    (17, 4096, 1024, 8, False), (0, 4096, 1024, 8, False),       # M
    (8, 131072, 1024, 8, False), (8, 0, 1024, 8, False),         # K
    (8, 4096, 1024, 7, False), (8, 4096, 1024, 16, False),       # width
    (8, 9, 1, 8, False),  # narrow first
])
def test_tensor_design_thresholds(m, k, n, n_bits, tensor):
    assert blocking.tensor_design(m, k, n, n_bits) is tensor


def test_exact_table_mark_on_both_sides():
    """device_table marks the exact product at width 8 on its host copy; any
    other table is checked once per tensor version."""
    assert lm._is_exact(lm.device_table("exact", "cpu"))
    assert lm._is_exact(lm.device_table("exact@8", "cpu"))
    for key in ("exact@7", "exact@4", "proposed", "csp_axc1@8"):
        assert not lm._is_exact(lm.device_table(key, "cpu")), key
    t = lm.device_table("exact", "cpu").clone()  # not from device_table
    assert lm._is_exact(t)
    t[5] += 1  # an in-place edit is checked anew
    assert not lm._is_exact(t)
    t[5] -= 1
    assert lm._is_exact(t)
    assert not lm._is_exact(lm.device_table("exact", "cpu")[:4096].clone())


def test_table16_follows_the_table_version():
    t = lm.device_table("proposed@6", "cpu").clone()
    t16 = lm.table16(t)
    assert t16.dtype == torch.int16 and torch.equal(t16.to(torch.int32), t)
    t[0] = 7
    assert int(lm.table16(t)[0]) == 7


def test_forced_designs_are_checked_before_any_launch():
    """No fallback: a forced design the shape, width or table does not fit
    raises before a launch is attempted (here on CPU tensors, which would
    otherwise need a card)."""
    a17 = torch.zeros((1, 17, 64), dtype=torch.int8)
    a8 = torch.zeros((1, 8, 64), dtype=torch.int8)
    b = torch.zeros((1, 64, 64), dtype=torch.int8)
    exact, prop = lm.device_table("exact", "cpu"), lm.device_table("proposed", "cpu")
    with pytest.raises(ValueError, match="decode design does not take"):
        am._launch(a17, b, "proposed@8", design="decode")
    with pytest.raises(ValueError, match="decode design does not take"):
        am._launch(a8, b, "proposed@12", design="decode")
    with pytest.raises(ValueError, match="decode design does not take"):
        lm._launch(a17, b, prop, 8, design="decode")
    with pytest.raises(ValueError, match="tensor design does not take"):
        lm._launch(a17, b, exact, 8, design="tensor")
    with pytest.raises(ValueError, match="tensor design does not take"):
        lm._launch(a8, b, prop, 8, design="tensor")
    with pytest.raises(ValueError, match="tensor design does not take"):
        lm._launch(a8, b, lm.device_table("exact@7", "cpu"), 7, design="tensor")
    with pytest.raises(ValueError, match="unknown lut_matmul design"):
        lm._launch(a8, b, exact, 8, design="wgmma")
    big = exact * 4  # beyond int16: no decode design
    with pytest.raises(ValueError, match="decode design does not take"):
        lm._launch(a8, b, big, 8, design="decode")


def test_cpu_tensors_run_the_plain_versions_without_launching():
    a = _t(RNG.integers(-128, 128, (1, 8, 300)).astype(np.int8))
    b = _t(RNG.integers(-128, 128, (1, 300, 200)).astype(np.int8))
    counters = (am.closed_form_matmul.decode_launches,
                lm.lut_matmul.decode_launches, lm.lut_matmul.tensor_launches)
    before = [c.value for c in counters]
    got = am.closed_form_matmul(a, b, "proposed")
    exact = lm.lut_matmul(a, b, lm.device_table("exact", "cpu"))
    assert [c.value for c in counters] == before
    np.testing.assert_array_equal(got.numpy(), blocking.decode_matmul_plain(
        a, b, am.closed_form_table16("proposed", "cpu"), 8).numpy())
    np.testing.assert_array_equal(exact.numpy(),
                                  blocking.tensor_matmul_plain(a, b).numpy())
