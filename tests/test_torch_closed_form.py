"""Parity of the port's closed forms (``repro_torch.kernels.closed_form``)
with ``repro.kernels.closed_form``, and of the CUDA parameter block.

``closed_form_from_params`` is the plain twin of the device function in
``csrc/closed_form.cuh``: holding it exhaustively against the generator is
what tests the kernels' product on the CPU.
"""
import numpy as np
import pytest
import torch

from repro.core import multiplier as jm
from repro.kernels import closed_form as jcf
from repro_torch.kernels import closed_form as tcf

RNG = np.random.default_rng(23)
NAMES = sorted(jm.WIRINGS)


def _grid(n):
    v = np.arange(-(1 << (n - 1)), 1 << (n - 1), dtype=np.int32)
    a, b = np.meshgrid(v, v, indexing="ij")
    return a.reshape(-1), b.reshape(-1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("name", NAMES)
def test_make_closed_form_exhaustive_n4(name):
    a, b = _grid(4)
    want = np.asarray(jcf.make_closed_form(name, 4)(a, b))
    got = tcf.make_closed_form(name, 4)(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want, err_msg=name)


def test_proposed8_exhaustive_generated_and_hand_derived():
    a, b = _grid(8)
    want = np.asarray(jcf.approx_product_i32(a, b))
    np.testing.assert_array_equal(
        tcf.approx_product_i32(_t(a), _t(b)).numpy(), want)
    np.testing.assert_array_equal(
        tcf.make_closed_form("proposed")(_t(a), _t(b)).numpy(), want)


@pytest.mark.parametrize("width", [3, 4, 5, 6, 7, 8])
def test_make_closed_form_sampled_widths(width):
    """Every wiring at every kernel width, random pairs incl. out-of-range
    ints (operands wrap into the signed width-bit domain)."""
    a = RNG.integers(-600, 600, 2048).astype(np.int32)
    b = RNG.integers(-600, 600, 2048).astype(np.int32)
    for name in NAMES:
        want = np.asarray(jcf.make_closed_form(name, width)(a, b))
        got = tcf.make_closed_form(f"{name}@{width}")(_t(a), _t(b)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{name}@{width}")


@pytest.mark.parametrize("width", [3, 4, 5, 6, 7, 8, 16])
def test_closed_form_f00(width):
    for name in NAMES + sorted(jm.WIRING_ALIASES):
        key = f"{name}@{width}"
        assert tcf.closed_form_f00(key) == jcf.closed_form_f00(key), key
    with pytest.raises(ValueError, match="unknown multiplier wiring"):
        tcf.make_closed_form(f"exact@{width}")


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("name", NAMES)
def test_params_block_exhaustive(name, n):
    """The device function's plain twin ≡ the generated closed form."""
    a, b = _grid(n)
    want = np.asarray(jcf.make_closed_form(name, n)(a, b))
    got = tcf.closed_form_from_params(_t(a), _t(b),
                                      tcf.closed_form_params(name, n)).numpy()
    np.testing.assert_array_equal(got, want, err_msg=f"{name}@{n}")


@pytest.mark.parametrize("width", [3, 5, 6, 7, 16])
def test_params_block_sampled_other_widths(width):
    a = RNG.integers(-(1 << 17), 1 << 17, 2048).astype(np.int32)
    b = RNG.integers(-(1 << 17), 1 << 17, 2048).astype(np.int32)
    for name in NAMES:
        want = np.asarray(jcf.make_closed_form(name, width)(a, b))
        got = tcf.closed_form_from_params(
            _t(a), _t(b), tcf.closed_form_params(f"{name}@{width}")).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{name}@{width}")


def test_params_block_layout():
    p = tcf.closed_form_params("proposed")
    assert p.dtype == np.int32 and p.shape == (tcf.PARAM_LEN,)
    assert (p[0], p[1]) == (8, 192)
    slot = [p[2 + s * tcf.SLOT_LEN: 2 + (s + 1) * tcf.SLOT_LEN] for s in range(3)]
    # C1a: proposed4 with 8 error terms, ¬(a0·b7) + taps p(1,6) p(2,5) p(3,4)
    assert list(slot[0][:4]) == [8, 4, 0, 3]
    assert list(slot[0][4:10]) == [1, 6, 2, 5, 3, 4]
    assert slot[0][10] == 7
    assert [s[0] for s in slot[1:]] == [0, 0]  # exact compressors: no terms
    assert tcf.closed_form_params("design_krishna2024")[2] == 6
    np.testing.assert_array_equal(tcf.closed_form_params("csp_axc1@4"),
                                  tcf.closed_form_params("design_esposito2018@4"))
    assert tcf.closed_form_params("proposed", 4)[0] == 4
    p[0] = 99  # callers get a copy, the cached block stays intact
    assert tcf.closed_form_params("proposed")[0] == 8
    with pytest.raises(ValueError):
        tcf.closed_form_params("exact")
