"""Parity of the port's approximate contraction
(``repro_torch.kernels.approx_matmul``, CPU tensors → its plain version) with
``repro``'s Pallas kernel (interpret mode off-TPU): ragged shapes, the
k-padding f(0,0) correction (design_strollo2020 included), batched operands,
an exhaustive N=4 outer product, and the pad/crop contract of
``kernels.blocking``."""
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.core import multiplier as jm
from repro.kernels.approx_matmul.ops import approx_matmul as j_approx_matmul
from repro.kernels.approx_matmul.ops import closed_form_matmul as j_cfm
from repro.nn import substrate as jsub
from repro_torch.kernels import blocking
from repro_torch.kernels.approx_matmul.ops import (approx_matmul,
                                                   closed_form_matmul,
                                                   closed_form_matmul_plain)

RNG = np.random.default_rng(5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("mkn", [(1, 1, 1), (17, 33, 9), (5, 19, 3),
                                 (8, 128, 4)])
@pytest.mark.parametrize("key", ["proposed", "design_strollo2020@4"])
def test_ragged_shapes_match_pallas(mkn, key):
    m, k, n = mkn
    a = RNG.integers(-128, 128, (m, k)).astype(np.int32)
    b = RNG.integers(-128, 128, (k, n)).astype(np.int32)
    want = np.asarray(j_cfm(a, b, key))
    got = closed_form_matmul(_t(a), _t(b), key).numpy()
    np.testing.assert_array_equal(got, want, err_msg=f"{key} {mkn}")


def test_k_padding_correction_matches_bitexact():
    """K=37 is no multiple of the plain version's k slab: the zero padding's
    f(0,0) (192 for proposed@8, 64 / −4 for design_strollo2020 @8 / @4) is
    subtracted back."""
    a = RNG.integers(-128, 128, (9, 37)).astype(np.int32)
    b = RNG.integers(-128, 128, (37, 11)).astype(np.int32)
    for key in ("proposed", "design_strollo2020", "design_strollo2020@4"):
        want = np.asarray(
            jsub.get_substrate(f"approx_bitexact:{key}").dot_int(a, b))
        got = closed_form_matmul(_t(a), _t(b), key).numpy()
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("name", sorted(jm.WIRINGS))
def test_exhaustive_n4_outer_product(name):
    """(16,1)@(1,16): every operand pair once, K=1."""
    v = np.arange(-8, 8, dtype=np.int32)
    got = closed_form_matmul(_t(v[:, None]), _t(v[None, :]), f"{name}@4").numpy()
    np.testing.assert_array_equal(got, jlut.build_lut(f"{name}@4"), err_msg=name)


def test_exhaustive_n4_outer_product_matches_pallas_kernel():
    v = np.arange(-8, 8, dtype=np.int32)
    want = np.asarray(j_cfm(v[:, None], v[None, :], "proposed@4"))
    got = closed_form_matmul(_t(v[:, None]), _t(v[None, :]), "proposed@4")
    np.testing.assert_array_equal(got.numpy(), want)


def test_batched_equals_stacked_2d_and_historical_entry():
    a = RNG.integers(-128, 128, (3, 5, 19)).astype(np.int32)
    b = RNG.integers(-128, 128, (3, 19, 4)).astype(np.int32)
    got = closed_form_matmul(_t(a), _t(b), "csp_axc5").numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], np.asarray(j_cfm(a[i], b[i], "csp_axc5")))
    np.testing.assert_array_equal(approx_matmul(_t(a[0]), _t(b[0])).numpy(),
                                  np.asarray(j_approx_matmul(a[0], b[0])))


def test_plain_version_runs_for_cpu_tensors_without_launching():
    a = _t(RNG.integers(-128, 128, (1, 6, 7)).astype(np.int32))
    b = _t(RNG.integers(-128, 128, (1, 7, 5)).astype(np.int32))
    before = closed_form_matmul.launches.value
    got = closed_form_matmul(a, b, "proposed")
    assert closed_form_matmul.launches.value == before
    np.testing.assert_array_equal(got.numpy(),
                                  closed_form_matmul_plain(a, b, "proposed").numpy())
    with pytest.raises(ValueError, match="cpu or cuda"):
        closed_form_matmul(a.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="mismatch"):
        closed_form_matmul(a, b.transpose(1, 2))


def test_blocking_contract():
    """pad_crop_correct: arbitrary shapes through a block-multiple-only
    contraction, cropped and f(0,0)-corrected; check_kernel_shapes rejects
    non-multiples loudly."""
    a = _t(RNG.integers(-8, 8, (2, 5, 7)).astype(np.int32))
    b = _t(RNG.integers(-8, 8, (2, 7, 3)).astype(np.int32))
    f00 = 10  # pretend every padded product contributes 10

    def kernel(ap, bp):
        blocking.check_kernel_shapes("k", "ops", ap.shape, bp.shape, 4, 4, 4)
        return ap @ bp + f00 * ap.shape[-1]

    got = blocking.pad_crop_correct(a, b, f00, kernel, block_m=4, block_n=4,
                                    block_k=4)
    np.testing.assert_array_equal(got.numpy(), (a @ b + f00 * 7).numpy())
    with pytest.raises(ValueError, match="multiple of its block size"):
        blocking.check_kernel_shapes("k", "ops", (5, 8), (8, 4), 4, 4, 4)
    with pytest.raises(ValueError, match="contraction-dim mismatch"):
        blocking.check_kernel_shapes("k", "ops", (4, 8), (4, 4), 4, 4, 4)


def test_launch_counter_counts_by_shape():
    """A launch that names its shape is also counted under it; reset clears
    both counts."""
    from repro_torch.kernels.build import LaunchCounter

    c = LaunchCounter()
    for shape in ((1, 32, 4096, 1024), (1, 32, 4096, 1024), (2, 8, 9, 1)):
        c.add(shape)
    c.add()
    assert c.value == 4
    assert c.by_shape() == {(1, 32, 4096, 1024): 2, (2, 8, 9, 1): 1}
    c.reset()
    assert (c.value, c.by_shape()) == (0, {})
