"""The narrow design of the port's two contraction kernels, on the CPU.

``csrc/narrow_contract.cuh`` contracts rows against one 2^n-entry product
column per coefficient. Its plain twin is
``blocking.narrow_matmul_plain`` with ``closed_form_columns``
(``kernels.approx_matmul``) or ``table_columns`` (``kernels.lut_matmul``).
Here that twin is held exactly against ``repro``'s Pallas kernels
(interpret mode off-TPU) on ragged shapes, K = 1..9, N = 1..8, widths 3..8,
every wiring and ``exact``, batched operands with a different b per batch
and out-of-range operands that wrap; the columns against
``repro.core.lut.build_lut``; and the dispatch rule
``blocking.narrow_design`` on both sides of each threshold.
"""
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.core import multiplier as jm
from repro.kernels.approx_matmul.ops import closed_form_matmul as j_cfm
from repro.kernels.lut_matmul.ops import lut_matmul as j_lut_matmul
from repro_torch.kernels import blocking
from repro_torch.kernels.approx_matmul import ops as am
from repro_torch.kernels.lut_matmul import ops as lm

RNG = np.random.default_rng(13)
WIRINGS = sorted(jm.WIRINGS)
WIDTHS = range(3, 9)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _shape(i: int):
    """(M, K, N) cycling K through 1..9 and N through 1..8, ragged M."""
    return 5 + 7 * (i % 5), 1 + i % 9, 1 + (i * 5) % 8


def _operands(m, k, n, n_bits, bsz=None, wide=False):
    hi = 1 << (n_bits - 1)
    lead = () if bsz is None else (bsz,)
    if wide:  # anywhere in int32: wraps to the low n bits
        a = RNG.integers(-2**31, 2**31, lead + (m, k), dtype=np.int64)
    else:
        a = RNG.integers(-hi, hi, lead + (m, k))
    b = RNG.integers(-hi, hi, lead + (k, n))
    return a.astype(np.int32), b.astype(np.int32)


def _closed_form_narrow(a, b, key):
    n_bits = jm.split_width(key)[1]
    a3, b3 = blocking.as3(_t(a), _t(b))
    out = blocking.narrow_matmul_plain(a3, am.closed_form_columns(b3, key), n_bits)
    return out.numpy() if a.ndim == 3 else out[0].numpy()


def _table_narrow(a, b, key):
    n_bits = jm.split_width(key)[1]
    table = lm.device_table(key, "cpu")
    a3, b3 = blocking.as3(_t(a), _t(b))
    out = blocking.narrow_matmul_plain(a3, lm.table_columns(b3, table), n_bits)
    return out.numpy() if a.ndim == 3 else out[0].numpy()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", WIRINGS)
def test_closed_form_columns_match_pallas(name, width):
    key = f"{name}@{width}"
    m, k, n = _shape(WIRINGS.index(name) * 6 + width)
    a, b = _operands(m, k, n, width)
    want = np.asarray(j_cfm(a, b, key))
    np.testing.assert_array_equal(_closed_form_narrow(a, b, key), want,
                                  err_msg=f"{key} {(m, k, n)}")
    np.testing.assert_array_equal(_table_narrow(a, b, key), want)


@pytest.mark.parametrize("key", [f"exact@{w}" for w in WIDTHS]
                         + [f"{name}@{3 + i % 6}" for i, name in enumerate(WIRINGS)])
def test_table_columns_match_pallas(key):
    width = jm.split_width(key)[1]
    m, k, n = _shape(width + len(key))
    a, b = _operands(m, k, n, width)
    want = np.asarray(j_lut_matmul(a, b, jlut.flat_lut(key)))
    np.testing.assert_array_equal(_table_narrow(a, b, key), want,
                                  err_msg=f"{key} {(m, k, n)}")


@pytest.mark.parametrize("key", ["proposed", "csp_axc1@6", "exact@5"])
def test_batched_with_a_different_b_per_batch(key):
    width = jm.split_width(key)[1]
    a, b = _operands(11, 9, 3, width, bsz=3)
    assert len({b[i].tobytes() for i in range(3)}) == 3
    got = _table_narrow(a, b, key)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(j_lut_matmul(a[i], b[i], jlut.flat_lut(key))))
    if not key.startswith("exact"):
        cf = _closed_form_narrow(a, b, key)
        for i in range(3):
            np.testing.assert_array_equal(cf[i], np.asarray(j_cfm(a[i], b[i], key)))


@pytest.mark.parametrize("key", ["proposed@4", "design_strollo2020@4", "csp_axc5@7"])
def test_out_of_range_operands_wrap_like_pallas(key):
    width = jm.split_width(key)[1]
    a, _ = _operands(13, 8, 2, width, wide=True)
    b = RNG.integers(-300, 300, (8, 2)).astype(np.int32)  # wraps as well
    want = np.asarray(j_cfm(a, b, key))
    np.testing.assert_array_equal(_closed_form_narrow(a, b, key), want)
    np.testing.assert_array_equal(
        _table_narrow(a, b, key), np.asarray(j_lut_matmul(a, b, jlut.flat_lut(key))))
    np.testing.assert_array_equal(_table_narrow(a, b, key), want)


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("name", WIRINGS + ["exact"])
def test_columns_equal_build_lut(name, width):
    """Column c of every coefficient is the table's column of c: the pixel is
    the first (row) operand."""
    key = f"{name}@{width}"
    off = 1 << (width - 1)
    coeffs = torch.arange(-off, off, dtype=torch.int32).reshape(1, 2 * off, 1)
    lut = jlut.build_lut(key)
    cols = lm.table_columns(coeffs, lm.device_table(key, "cpu"))
    assert cols.shape == (1, 2 * off, 1, 2 * off) and cols.dtype == torch.int32
    np.testing.assert_array_equal(cols[0, :, 0, :].numpy().T, lut)
    if name != "exact":
        np.testing.assert_array_equal(
            am.closed_form_columns(coeffs, key)[0, :, 0, :].numpy().T, lut)
    assert lut.min() >= -2**15 and lut.max() < 2**15  # int16 columns are lossless


@pytest.mark.parametrize("k,n,n_bits,narrow", [
    (9, 1, 8, True), (8, 1, 6, True), (1, 1, 8, True),     # the served shapes
    (16, 8, 8, True), (17, 8, 8, False), (17, 1, 3, False),  # K threshold
    (1, 8, 8, True), (1, 9, 8, False), (9, 16, 4, False),    # N threshold
    (9, 1, 1, True), (9, 1, 9, False), (9, 1, 16, False),    # width threshold
    (0, 1, 8, False), (9, 0, 8, False), (9, 1, 0, False),    # empty
    (1, 16, 4, False),  # the exhaustive width-4 outer product: tile
])
def test_narrow_design_thresholds(k, n, n_bits, narrow):
    assert blocking.narrow_design(k, n, n_bits) is narrow
    if narrow:  # the columns a block stages fit the kernel's 64 KiB
        assert k * n * (2 << n_bits) <= 64 * 1024


def test_narrow_operands_align_every_batch():
    base = torch.arange(1 + 7 * 3, dtype=torch.int32)
    a = base[1:].view(1, 7, 3)  # storage offset 4 bytes: not 16-byte aligned
    assert a.data_ptr() % 16
    b = torch.ones((1, 3, 2), dtype=torch.int32)
    a2, b2, out, cols, crop = blocking.narrow_operands(a, b, 6)
    assert a2.data_ptr() % 16 == 0 and crop is None and torch.equal(a2, a)
    assert out.shape == (1, 7, 2) and cols.shape == (1, 3, 2, 64)
    assert cols.dtype == torch.int16 and out.dtype == torch.int32
    aligned = torch.zeros((1, 7, 3), dtype=torch.int32)
    assert blocking.narrow_operands(aligned, b, 6)[0] is aligned
    batched = torch.ones((2, 5, 3), dtype=torch.int32)  # M % 4 != 0
    a3, _, out, _, crop = blocking.narrow_operands(batched, b.expand(2, 3, 2), 6)
    assert a3.shape == (2, 8, 3) and out.shape == (2, 8, 2) and crop == 5
    assert torch.equal(a3[:, :5], batched) and not a3[:, 5:].any()


def test_design_argument_is_checked_before_any_launch():
    a = torch.zeros((1, 4, 17), dtype=torch.int32)
    b = torch.zeros((1, 17, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="narrow design does not take"):
        am._launch(a, b, "proposed@8", design="narrow")
    with pytest.raises(ValueError, match="narrow design does not take"):
        lm._launch(a, b, lm.device_table("exact", "cpu"), 8, design="narrow")
    with pytest.raises(ValueError, match="wide design does not take"):
        am._launch(a[:, :, :9], b[:, :9], "proposed@8", design="wide")
    with pytest.raises(ValueError, match="unknown lut_matmul design"):
        lm._launch(a[:, :, :9], b[:, :9], lm.device_table("exact", "cpu"), 8,
                   design="wide")


def test_table_beyond_int16_is_not_narrow():
    """A table from device_table is known to fit int16; any other table is
    checked once per tensor version, and one that does not fit goes to the
    gather design."""
    t = lm.device_table("exact", "cpu")
    assert lm._fits_int16(t)
    big = t * 4  # 16384 * 4 is no int16
    assert not lm._fits_int16(big)
    a = torch.zeros((1, 4, 1), dtype=torch.int32)
    b = torch.zeros((1, 1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="beyond int16"):
        lm._launch(a, b, big, 8, design="narrow")
    big.clamp_(-2**15, 2**15 - 1)  # an in-place edit is checked anew
    assert lm._fits_int16(big)


def test_cpu_tensors_run_the_plain_versions_without_launching():
    a = _t(RNG.integers(-128, 128, (1, 9, 9)).astype(np.int32))
    b = _t(RNG.integers(-128, 128, (1, 9, 1)).astype(np.int32))
    counters = (am.closed_form_matmul.launches, am.closed_form_matmul.narrow_launches,
                lm.lut_matmul.launches, lm.lut_matmul.narrow_launches)
    before = [c.value for c in counters]
    got = am.closed_form_matmul(a, b, "proposed")
    lut = lm.lut_matmul(a, b, lm.device_table("proposed", "cpu"))
    assert [c.value for c in counters] == before
    np.testing.assert_array_equal(got.numpy(), lut.numpy())
    np.testing.assert_array_equal(
        got.numpy(), blocking.narrow_matmul_plain(
            a, am.closed_form_columns(b, "proposed@8"), 8).numpy())


@pytest.mark.parametrize("source", ["approx_matmul", "lut_matmul"])
def test_an_edit_of_the_shared_header_rebuilds(source, tmp_path, monkeypatch):
    """The library name hashes every ``csrc/*.cuh``, so an edit of
    ``narrow_contract.cuh`` names a new library for both sources that
    include it, and a stale one is never loaded."""
    from repro_torch.kernels import build

    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path(source)
    header = tmp_path / "narrow_contract.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path(source) != before
