"""The fused conv's stencil design, held on the CPU through its plain twin.

``fused_conv_columns`` builds one int16 product column per distinct wrapped
tap (closed-form kind: the closed form evaluated per column; LUT kind: the
product table's columns), and ``stencil_conv_plain`` gathers each kernel
row's pixels once per column, as the CUDA kernel does. Both are held against
``repro``'s fused conv (its Pallas kernel in interpret mode) and against
``repro``'s product table gathered in numpy (``_lut_conv``), with tolerance
0: every wiring exhaustively at N=4 and ``exact``, widths 3..8, 1×1 / 2×3 /
5×5 kernels with many distinct taps, ragged shapes with W % 4 != 0, the zero
border, pixels and taps anywhere in int32 (the tap-wrapping identity behind
the column dedupe), and the design chooser. The kernel itself runs only on
the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.core import multiplier as jm
from repro.kernels.fused_conv.ops import fused_conv2d as j_fused
from repro.nn import conv as jconv
from repro_torch.core import multiplier as mult
from repro_torch.kernels.closed_form import make_closed_form
from repro_torch.kernels.fused_conv import ops as fc
from repro_torch.kernels.fused_conv.ops import (fused_conv2d, fused_conv2d_plain,
                                                fused_conv_columns,
                                                stencil_conv_plain, stencil_design)
from repro_torch.nn import conv

RNG = np.random.default_rng(140)
#: a 4×4 kernel holding every signed 4-bit tap value once
TAPS_N4 = np.arange(-8, 8, dtype=np.int32).reshape(4, 4)


def _taps(kern) -> tuple:
    return tuple(tuple(int(c) for c in row) for row in np.asarray(kern))


def _kinds(key: str) -> tuple:
    return ("lut",) if key.split("@")[0] == "exact" else ("lut", "closed_form")


def _stencil(imgs, kern, key: str, kind: str) -> np.ndarray:
    """The stencil design's plain twin on numpy images."""
    key = mult.canonical_key(key)
    taps = _taps(kern)
    slots, cols = fused_conv_columns(taps, key, kind, "cpu")
    return stencil_conv_plain(torch.from_numpy(np.asarray(imgs, np.int32)),
                              slots, cols, mult.split_width(key)[1],
                              len(taps), len(taps[0])).numpy()


def _lut_conv(imgs, kern, key):
    """'same' conv gathered from ``repro``'s product table for ``key``
    (out-of-range operands wrap)."""
    table = jlut.build_lut(key)
    n = table.shape[0].bit_length() - 1
    off, mask = 1 << (n - 1), (1 << n) - 1
    kern = np.asarray(kern)
    kh, kw = kern.shape
    _, h, w = imgs.shape
    x = np.pad(imgs, ((0, 0), (kh // 2, kh // 2), (kw // 2, kw // 2)))
    out = np.zeros(imgs.shape, np.int64)
    for di in range(kh):
        for dj in range(kw):
            xi = (x[:, di:di + h, dj:dj + w].astype(np.int64) + off) & mask
            out += table[xi, (int(kern[di, dj]) + off) & mask]
    return out.astype(np.int32)


@pytest.mark.parametrize("name", sorted(jm.WIRINGS) + ["exact"])
def test_stencil_exhaustive_n4_matches_pallas(name):
    """Every pixel value × every tap value at N=4 (the images hold all 16
    values, the 4×4 kernel all 16 taps: 16 columns), in every kind the
    product model has, against the reference's fused conv."""
    key = f"{name}@4"
    imgs = np.stack([RNG.permutation(np.tile(np.arange(-8, 8), 12)).reshape(12, 16)
                     .astype(np.int32) for _ in range(2)])
    want = np.asarray(j_fused(imgs, TAPS_N4, key, kernel_kind="lut"))
    np.testing.assert_array_equal(want, _lut_conv(imgs, TAPS_N4, key))
    if name != "exact":
        np.testing.assert_array_equal(
            want, np.asarray(j_fused(imgs, TAPS_N4, key, kernel_kind="closed_form")))
    for kind in _kinds(key):
        slots, cols = fused_conv_columns(_taps(TAPS_N4), key, kind, "cpu")
        assert cols.shape == (16, 16)
        np.testing.assert_array_equal(_stencil(imgs, TAPS_N4, key, kind), want,
                                      err_msg=f"{name} {kind}")


@pytest.mark.parametrize("width", [3, 4, 5, 6, 7, 8])
def test_stencil_widths(width):
    """proposed at widths 3..8: the Laplacian against the reference's fused
    conv, a random 3×3 kernel (taps beyond the width wrap) against the
    product table."""
    key = f"proposed@{width}"
    hi = 1 << (width - 1)
    imgs = RNG.integers(-hi, hi, (2, 11, 19)).astype(np.int32)
    want = np.asarray(j_fused(imgs, jconv.LAPLACIAN, key))
    rnd = RNG.integers(-3 * hi, 3 * hi, (3, 3)).astype(np.int32)
    for kind in _kinds(key):
        np.testing.assert_array_equal(_stencil(imgs, conv.LAPLACIAN, key, kind),
                                      want, err_msg=kind)
        np.testing.assert_array_equal(_stencil(imgs, rnd, key, kind),
                                      _lut_conv(imgs, rnd, key), err_msg=kind)


@pytest.mark.parametrize("kern", [np.full((1, 1), -3, np.int32),
                                  RNG.permutation(np.arange(-128, 128))[:6]
                                  .reshape(2, 3).astype(np.int32),
                                  RNG.permutation(np.arange(-128, 128))[:25]
                                  .reshape(5, 5).astype(np.int32)],
                         ids=["1x1", "2x3", "5x5"])
@pytest.mark.parametrize("key", ["proposed", "csp_axc3@6", "exact"])
def test_stencil_kernel_shapes_many_distinct_taps(kern, key):
    """1×1, 2×3 (an even kernel dim: the window sits one row up) and 5×5
    with as many distinct taps as the kernel has."""
    assert len(set(kern.ravel().tolist())) == kern.size
    n = jm.split_width(key)[1]
    imgs = RNG.integers(-(1 << (n - 1)), 1 << (n - 1), (2, 13, 18)).astype(np.int32)
    want = _lut_conv(imgs, kern, key)
    for kind in _kinds(key):
        np.testing.assert_array_equal(_stencil(imgs, kern, key, kind), want,
                                      err_msg=kind)
    np.testing.assert_array_equal(np.asarray(j_fused(imgs, kern, key, kernel_kind="lut")),
                                  want)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (5, 9), (20, 7), (17, 129),
                                   (33, 47)])
def test_stencil_ragged_shapes(shape):
    """H and W that are no multiple of anything the kernel tiles by (W % 4
    != 0 takes the kernel's scalar path), against the reference."""
    imgs = RNG.integers(-128, 128, (2, *shape)).astype(np.int32)
    for key in ("proposed", "exact"):
        want = np.asarray(j_fused(imgs, jconv.LAPLACIAN, key, kernel_kind="lut"))
        for kind in _kinds(key):
            np.testing.assert_array_equal(
                _stencil(imgs, conv.LAPLACIAN, key, kind), want,
                err_msg=f"{key} {kind} {shape}")


def test_stencil_zero_border_is_looked_up():
    """An all-zero image answers Σ f(0, c) at every pixel, border included:
    out-of-image pixels are 0 and still read their column (f(0, 0) = 192
    at proposed@8, f(0, c) ≠ 0 for the Laplacian's taps)."""
    imgs = np.zeros((1, 6, 7), np.int32)
    want = np.asarray(j_fused(imgs, jconv.LAPLACIAN, "proposed"))
    for kind in ("closed_form", "lut"):
        got = _stencil(imgs, conv.LAPLACIAN, "proposed", kind)
        np.testing.assert_array_equal(got, want, err_msg=kind)
        assert (got != 0).all()
    f = make_closed_form("proposed")
    assert int(f(torch.tensor(0), torch.tensor(0))) == 192
    assert (want == sum(int(f(torch.tensor(0), torch.tensor(int(c))))
                        for c in conv.LAPLACIAN.ravel())).all()


@pytest.mark.parametrize("name", sorted(jm.WIRINGS) + ["exact"])
def test_tap_wrapping_identity(name):
    """The dedupe behind the columns: both kinds give f(x, c) = f(x,
    wrap_n(c)) for every pixel x and every int32 tap c, so taps equal modulo
    2^n share a column. Checked at widths 3..8 for the closed form (which
    wraps its operands first) and for the table read (whose index wraps)."""
    for n in range(3, 9):
        key = mult.canonical_key(f"{name}@{n}")
        off, mask = 1 << (n - 1), (1 << n) - 1
        x = torch.arange(-off, off, dtype=torch.int32)[:, None]
        c = torch.from_numpy(np.concatenate([
            np.arange(-3 << n, 3 << n),
            RNG.integers(-2**31, 2**31, 64, dtype=np.int64)]).astype(np.int32))[None, :]
        wrapped = ((c + off) & mask) - off
        if name != "exact":
            f = make_closed_form(key)
            assert torch.equal(f(x, c), f(x, wrapped)), key
        table = torch.from_numpy(jlut.build_lut(key).astype(np.int32))
        assert torch.equal(table[(x + off).long(), ((c + off) & mask).long()],
                           table[(x + off).long(), (wrapped + off).long()])
        for kind in _kinds(key):
            taps = _taps(RNG.integers(-off, off, (2, 3)))
            shifted = tuple(tuple(t + (k << n) for t, k in zip(row, (1, -3, 1000)))
                            for row in taps)
            s1, c1 = fused_conv_columns(taps, key, kind, "cpu")
            s2, c2 = fused_conv_columns(shifted, key, kind, "cpu")
            np.testing.assert_array_equal(s1, s2)
            assert c1 is c2


def test_stencil_pixels_anywhere_in_int32():
    """Pixels beyond the operand width wrap in both product models; the
    column index (x + 2^(n-1)) & (2^n - 1) equals that wrap for every int32
    x, so the stencil twin and the generic plain version agree."""
    imgs = RNG.integers(-2**31, 2**31, (2, 9, 14), dtype=np.int64).astype(np.int32)
    kern = RNG.integers(-300, 300, (3, 3)).astype(np.int32)
    for key in ("proposed", "csp_axc1@5", "exact@6"):
        ck = mult.canonical_key(key)
        want = _lut_conv(imgs, kern, ck)
        for kind in _kinds(ck):
            np.testing.assert_array_equal(_stencil(imgs, kern, ck, kind), want)
            np.testing.assert_array_equal(
                fused_conv2d_plain(torch.from_numpy(imgs), _taps(kern), ck,
                                   kind).numpy(), want)


def test_columns_built_once_closed_form_equals_table():
    """One (D, 2^n) int16 column set per (key, kind, taps, device), the same
    tensor on every call; the closed-form kind's columns (evaluated from the
    closed form, not read from the table) equal the table's columns for
    every CSP wiring, and the Laplacian needs 2 columns."""
    lap = _taps(conv.LAPLACIAN)
    for name in sorted(mult.WIRINGS):
        for n in (4, 8):
            key = mult.canonical_key(f"{name}@{n}")
            s_cf, c_cf = fused_conv_columns(lap, key, "closed_form", "cpu")
            s_lut, c_lut = fused_conv_columns(lap, key, "lut", "cpu")
            assert c_cf.dtype == c_lut.dtype == torch.int16
            assert c_cf.shape == c_lut.shape == (2, 1 << n)
            np.testing.assert_array_equal(s_cf, s_lut)
            assert torch.equal(c_cf, c_lut), key
            assert fused_conv_columns(lap, key, "closed_form", "cpu")[1] is c_cf
    with pytest.raises(ValueError, match="width <= 8"):
        fused_conv_columns(lap, "proposed@12", "closed_form", "cpu")


def test_stencil_design_chooser():
    """Every served conv (the 3×3 Laplacian: 2 distinct taps at widths 6
    and 8, both kinds) takes the stencil design; width 12 (the closed form
    serves widths to 16) and kernels beyond 5×5 keep the generic design."""
    lap = _taps(conv.LAPLACIAN)
    for key in ("proposed", "exact", "csp_axc1@6", "proposed@3"):
        n = mult.split_width(key)[1]
        distinct = len(fused_conv_columns(lap, mult.canonical_key(key), "lut", "cpu")[1])
        assert distinct == 2 and stencil_design(n, 3, 3, distinct)
    for kh, kw in ((1, 1), (2, 3), (5, 5), (1, 5), (4, 2)):
        assert stencil_design(8, kh, kw, kh * kw)
    assert not stencil_design(12, 3, 3, 2)
    assert not stencil_design(9, 3, 3, 2)
    for kh, kw in ((7, 7), (6, 1), (3, 6), (16, 16)):
        assert not stencil_design(8, kh, kw, 2)
    assert fc.STENCIL_MAX_K == 5 and fc.STENCIL_MAX_BITS == 8
    x = torch.zeros((1, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="stencil design does not take"):
        fc._launch(x, lap, "proposed@12", "closed_form", design="stencil")
    with pytest.raises(ValueError, match="stencil design does not take"):
        fc._launch(x, _taps(np.ones((7, 7), np.int32)), "exact", "lut",
                   design="stencil")
    with pytest.raises(ValueError, match="unknown fused_conv design"):
        fc._launch(x, lap, "proposed", "closed_form", design="tile")


def test_cpu_tensors_run_the_generic_plain_version():
    """A CPU batch runs ``fused_conv2d_plain`` and launches nothing, in
    either design's shape."""
    imgs = torch.from_numpy(RNG.integers(-128, 128, (2, 9, 12)).astype(np.int32))
    counters = (fused_conv2d.launches, fused_conv2d.lut_launches,
                fused_conv2d.stencil_launches)
    before = [c.value for c in counters]
    for key in ("proposed", "exact", "proposed@12"):
        got = fused_conv2d(imgs, conv.LAPLACIAN, key)
        kind = fc.resolve_kind(mult.canonical_key(key), "auto")
        np.testing.assert_array_equal(
            got.numpy(), fused_conv2d_plain(imgs, _taps(conv.LAPLACIAN),
                                            mult.canonical_key(key), kind).numpy())
    assert [c.value for c in counters] == before
