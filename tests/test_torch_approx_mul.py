"""Parity of the port's elementwise approximate multiply (``repro_torch.
kernels.approx_mul``, CPU tensors → its plain version) with ``repro``'s
Pallas kernel (interpret mode off-TPU): all 65,536 in-range operand pairs,
an odd shape, and int32 operands far outside [-128, 127], where the
hand-derived closed form the kernel evaluates differs from the generic one.
Integer results are compared exactly."""
import numpy as np
import pytest
import torch

from repro.kernels.approx_mul.ops import approx_mul as j_approx_mul
from repro.kernels.closed_form import approx_product_i32 as j_product
from repro_torch.kernels.approx_mul.ops import approx_mul, approx_mul_plain
from repro_torch.kernels.approx_mul.ref import approx_mul_ref
from repro_torch.kernels.closed_form import make_closed_form

RNG = np.random.default_rng(21)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_all_in_range_pairs_match_pallas_and_core_model():
    v = np.arange(-128, 128, dtype=np.int32)
    a, b = (x.reshape(256, 256) for x in np.meshgrid(v, v, indexing="ij"))
    want = np.asarray(j_approx_mul(a, b))
    got = approx_mul(_t(a), _t(b))
    assert got.dtype == torch.int32 and got.shape == (256, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(approx_mul_ref(_t(a), _t(b)).numpy(), want)


@pytest.mark.parametrize("shape", [(7, 13, 3), (1,), (129,), (3, 1, 257)])
def test_odd_shapes_match_pallas(shape):
    a = RNG.integers(-128, 128, shape).astype(np.int32)
    b = RNG.integers(-128, 128, shape).astype(np.int32)
    np.testing.assert_array_equal(approx_mul(_t(a), _t(b)).numpy(),
                                  np.asarray(j_approx_mul(a, b)))


def test_any_int32_input_gives_the_hand_form():
    """Outside [-128, 127] the kernel keeps the hand-derived form's integers
    (int32 wraparound of a·b included), which the generic closed form of
    proposed@8 does not share."""
    a = RNG.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    b = RNG.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    got = approx_mul(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_product(a, b)))
    np.testing.assert_array_equal(got, np.asarray(j_approx_mul(a, b)))
    generic = make_closed_form("proposed")(_t(a), _t(b)).numpy()
    assert (got != generic).any()


def test_plain_version_runs_for_cpu_tensors_and_checks():
    a = _t(RNG.integers(-128, 128, (5, 6)).astype(np.int32))
    b = _t(RNG.integers(-128, 128, (5, 6)).astype(np.int32))
    before = approx_mul.launches.value
    got = approx_mul(a, b)
    assert approx_mul.launches.value == before  # no kernel launch on CPU
    np.testing.assert_array_equal(got.numpy(), approx_mul_plain(a, b).numpy())
    with pytest.raises(ValueError, match="shape mismatch"):
        approx_mul(a, b.T)
    with pytest.raises(ValueError, match="cpu or cuda"):
        approx_mul(a.to("meta"), b.to("meta"))
