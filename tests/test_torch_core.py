"""Parity of the port's multiplier model (``repro_torch.core``) with ``repro``.

Inputs are made with numpy and handed to both packages; every integer
result must be exactly equal: compressor tables, the closed-form and
structural multipliers (exhaustive at N=4 and N=8 for all 9 wirings plus
``exact``, sampled at N=16), product tables, f(0,0), error tables and
their moments (equal in float64).
"""
import numpy as np
import pytest
import torch

from repro.core import compressors as jcomp
from repro.core import lut as jlut
from repro.core import multiplier as jm
from repro_torch.core import compressors as tcomp
from repro_torch.core import lut as tlut
from repro_torch.core import multiplier as tm

RNG = np.random.default_rng(11)
NAMES = sorted(jm.WIRINGS)


def _grid(n):
    v = np.arange(-(1 << (n - 1)), 1 << (n - 1), dtype=np.int32)
    a, b = np.meshgrid(v, v, indexing="ij")
    return a.reshape(-1), b.reshape(-1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_compressor_tables_and_statistics_match():
    assert sorted(tcomp.ALL) == sorted(jcomp.ALL)
    for name, jc in jcomp.ALL.items():
        tc = tcomp.ALL[name]
        assert tc.n_inputs == jc.n_inputs and tc.reconstructed == jc.reconstructed
        np.testing.assert_array_equal(tc.values, jc.values, err_msg=name)
        np.testing.assert_array_equal(tc.errors, jc.errors, err_msg=name)
        assert tc.error_probability() == jc.error_probability()
        assert tc.mean_error() == jc.mean_error()
        idx = np.arange(2 ** jc.n_inputs, dtype=np.int32)
        for method in ("apply_packed", "error_packed", "carry_bit", "sum_bit"):
            np.testing.assert_array_equal(
                getattr(tc, method)(_t(idx)).numpy(),
                np.asarray(getattr(jc, method)(idx)), err_msg=f"{name}.{method}")
    assert tcomp.PAPER_TABLE2_STATS == jcomp.PAPER_TABLE2_STATS


def test_pack_bits_and_gates_match():
    bits = RNG.integers(0, 2, (4, 64)).astype(np.int32)
    for k in (3, 4):
        np.testing.assert_array_equal(
            tcomp.pack_bits([_t(b) for b in bits[:k]]).numpy(),
            np.asarray(jcomp.pack_bits(list(bits[:k]))))
    for t_fn, j_fn, k in ((tcomp.proposed3_gates, jcomp.proposed3_gates, 3),
                          (tcomp.proposed4_gates, jcomp.proposed4_gates, 4)):
        for got, want in zip(t_fn(*[_t(b) for b in bits[:k]]), j_fn(*bits[:k])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tcomp.exact4_value(*[_t(b) for b in bits]).numpy(),
        np.asarray(jcomp.exact4_value(*bits)))


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("name", NAMES + ["exact"])
def test_multiplier_exhaustive(name, n):
    """Against ``repro``'s exhaustive table (its ``make_multiplier`` on the
    full operand grid, cached across tests)."""
    a, b = _grid(n)
    want = jlut.build_lut(f"{name}@{n}").reshape(-1)
    got = tm.make_multiplier(name, n)(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want, err_msg=f"{name}@{n}")


@pytest.mark.parametrize("name", NAMES)
def test_structural_multiplier_exhaustive_n4(name):
    a, b = _grid(4)
    want = np.asarray(jm.StructuralMultiplier(4, jm.WIRINGS[name])(a, b))
    got = tm.StructuralMultiplier(4, tm.WIRINGS[name])(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", NAMES)
def test_multiplier_sampled_n16(name):
    """N=16 on random pairs, out-of-range ints included (they wrap)."""
    a = RNG.integers(-(1 << 20), 1 << 20, 4096).astype(np.int32)
    b = RNG.integers(-(1 << 20), 1 << 20, 4096).astype(np.int32)
    want = np.asarray(jm.make_multiplier(name, 16)(a, b))
    got = tm.make_multiplier(name, 16)(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want, err_msg=name)


def test_exact_baugh_wooley_and_truncation_match():
    a, b = _grid(4)
    for fn in ("exact_baugh_wooley", "truncated_sum"):
        np.testing.assert_array_equal(
            getattr(tm, fn)(_t(a), _t(b), 4).numpy(),
            np.asarray(getattr(jm, fn)(a, b, 4)), err_msg=fn)
    x = RNG.integers(-(1 << 31), 1 << 31, 512, dtype=np.int64).astype(np.int32)
    for bits in (3, 4, 8, 16, 32):
        np.testing.assert_array_equal(tm.wrap_to_width(_t(x), bits).numpy(),
                                      np.asarray(jm.wrap_to_width(x, bits)))
    for n in range(3, 17):
        assert tm.compensation_constant(n) == jm.compensation_constant(n)
        assert tm.csp_slot_taps(n) == jm.csp_slot_taps(n)


@pytest.mark.parametrize("n", [3, 4, 5, 6, 7, 8])
def test_build_lut_flat_lut_f00_every_key(n):
    for name in NAMES + ["exact"] + sorted(jm.WIRING_ALIASES):
        key = f"{name}@{n}"
        np.testing.assert_array_equal(tlut.build_lut(key), jlut.build_lut(key),
                                      err_msg=key)
        np.testing.assert_array_equal(tlut.flat_lut(key), jlut.flat_lut(key))
        assert tlut.f00(key) == jlut.f00(key), key


def test_f00_regression_values_and_lut_multiply():
    assert tlut.f00("design_strollo2020") == 64
    assert tlut.f00("design_strollo2020@4") == -4
    assert tlut.f00("proposed") == 192
    a = RNG.integers(-300, 300, 256).astype(np.int32)  # out of range: wraps
    b = RNG.integers(-300, 300, 256).astype(np.int32)
    for key in ("proposed", "csp_axc1@4"):
        np.testing.assert_array_equal(
            tlut.lut_multiply(_t(a), _t(b), tlut.build_lut(key)).numpy(),
            np.asarray(jlut.lut_multiply(a, b, jlut.build_lut(key))))
    with pytest.raises(ValueError, match="widths <= 8"):
        tlut.build_lut("proposed@9")


@pytest.mark.parametrize("key", ["proposed", "proposed@4", "csp_axc1@16",
                                 "exact@8", "design_du2022"])
def test_key_resolution_matches(key):
    assert tm.canonical_key(key) == jm.canonical_key(key)
    assert tm.split_width(key) == jm.split_width(key)
    assert tm.resolve_multiplier(key)[0::2] == jm.resolve_multiplier(key)[0::2]


@pytest.mark.parametrize("bad", ["proposed@ 8", "proposed@+8", "proposed@",
                                 "proposed@2", "proposed@17", "nonsense",
                                 "proposed@８"])
def test_bad_keys_rejected_like_reference(bad):
    with pytest.raises(ValueError) as jerr:
        jm.canonical_key(bad)
    with pytest.raises(ValueError) as terr:
        tm.canonical_key(bad)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("key", ["proposed", "csp_axc1@4", "design_du2022@6",
                                 "exact@5", "csp_krishna@8"])
def test_error_lut_and_moments_match(key):
    np.testing.assert_array_equal(tlut.error_lut(key), jlut.error_lut(key))
    assert tlut.error_lut(key).dtype == np.int32
    assert tlut.error_moments(key) == jlut.error_moments(key)
