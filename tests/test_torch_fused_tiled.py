"""The fused conv's tiled design, held on the CPU through its plain twin.

``tiled_products`` builds the product data the tiled kernel stages: the
int16 columns at widths ≤ 8 (both kinds), and at widths 9..16 of the closed
form int32 columns (``fused_conv_columns32``) or int32 byte tables
(``fused_conv_byte_tables``: ``f(u, c) = lo[u & 255] + hi[u >> 8]``).
``tiled_conv_plain`` reads it as the kernel does. Both are held with
tolerance 0 (the int32 ring) against ``repro``'s fused conv (its Pallas
kernel in interpret mode) and ``fused_conv2d_plain``: widths 9..16 under the
Laplacian, 6×6 / 7×7 / 9×9 / 16×16 kernels with many distinct taps at width
8 in both kinds, ragged H and W, the zero border, pixels anywhere in int32.
The product data is held against ``closed_form_from_params`` on every
pixel value of a seeded set of taps and the extremes at widths 9..16, and on
every operand pair at widths 9..11, for every wiring; the design chooser
too. The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.core import multiplier as jm
from repro.kernels.fused_conv.ops import fused_conv2d as j_fused
from repro.nn import conv as jconv
from repro_torch.core import multiplier as mult
from repro_torch.kernels import monomials
from repro_torch.kernels.closed_form import (closed_form_from_params,
                                             closed_form_params)
from repro_torch.kernels.fused_conv import ops as fc
from repro_torch.kernels.fused_conv.ops import (byte_tables_from_columns,
                                                fused_conv2d_plain,
                                                fused_conv_byte_tables,
                                                fused_conv_columns32,
                                                tiled_conv_plain, tiled_products)
from repro_torch.nn import conv

RNG = np.random.default_rng(290)
WIRINGS = sorted(jm.WIRINGS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module: the test runner's workers share the
    machine's cores, which intra-op threads would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _taps(kern) -> tuple:
    return tuple(tuple(int(c) for c in row) for row in np.asarray(kern))


def _width(key: str) -> int:
    return mult.split_width(mult.canonical_key(key))[1]


def _sources(key: str, kind: str) -> tuple:
    """Every product data the tiled design may read for ``key``."""
    return ("columns16",) if _width(key) <= 8 else ("columns32", "bytes")


def _tiled(imgs, kern, key: str, kind: str, source: str) -> np.ndarray:
    """The tiled design's plain twin on numpy images."""
    key = mult.canonical_key(key)
    taps = _taps(kern)
    slots, prod, src = tiled_products(taps, key, kind, "cpu", source)
    return tiled_conv_plain(torch.from_numpy(np.asarray(imgs, np.int32)), slots,
                            prod, _width(key), len(taps), len(taps[0]),
                            src).numpy()


def _plain(imgs, kern, key: str, kind: str) -> np.ndarray:
    return fused_conv2d_plain(torch.from_numpy(np.asarray(imgs, np.int32)),
                              _taps(kern), mult.canonical_key(key), kind).numpy()


def _lut_conv(imgs, kern, key):
    """'same' conv gathered from ``repro``'s product table for ``key``
    (widths ≤ 8; out-of-range operands wrap)."""
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


def _check_all(imgs, kern, key: str, kind: str, want: np.ndarray) -> None:
    for source in _sources(key, kind):
        np.testing.assert_array_equal(_tiled(imgs, kern, key, kind, source), want,
                                      err_msg=f"{key} {kind} {source}")
    np.testing.assert_array_equal(_plain(imgs, kern, key, kind), want,
                                  err_msg=f"{key} {kind} plain")


@pytest.mark.parametrize("width", range(9, 17))
def test_tiled_widths_9_to_16_match_pallas(width):
    """proposed at widths 9..16 under the Laplacian, both product data
    (int32 columns and byte tables), against the reference's fused conv;
    a random 3×3 kernel (taps beyond the width wrap) against the plain
    version."""
    key = f"proposed@{width}"
    hi = 1 << (width - 1)
    imgs = RNG.integers(-hi, hi, (2, 11, 19)).astype(np.int32)
    _check_all(imgs, conv.LAPLACIAN, key, "closed_form",
               np.asarray(j_fused(imgs, jconv.LAPLACIAN, key)))
    rnd = RNG.integers(-3 * hi, 3 * hi, (3, 3)).astype(np.int32)
    _check_all(imgs, rnd, key, "closed_form", _plain(imgs, rnd, key, "closed_form"))


#: an integer 7×7 Laplacian of Gaussian: 5 distinct taps, runs of equal taps
#: down its columns
LOG7 = np.array([[0, 0, -1, -1, -1, 0, 0], [0, -1, -3, -3, -3, -1, 0],
                 [-1, -3, 0, 7, 0, -3, -1], [-1, -3, 7, 24, 7, -3, -1],
                 [-1, -3, 0, 7, 0, -3, -1], [0, -1, -3, -3, -3, -1, 0],
                 [0, 0, -1, -1, -1, 0, 0]], dtype=np.int32)


@pytest.mark.parametrize("k", [6, 7, 9, 16])
def test_tiled_large_kernels_both_kinds(k):
    """Kernels beyond the stencil design's 5×5 at width 8, as many distinct
    taps as the kernel has (256 at 16×16: every column of the table), in
    both kinds, against the reference's fused conv (table kind) and the
    product table."""
    kern = RNG.permutation(np.arange(-128, 128))[:k * k].reshape(k, k).astype(np.int32)
    imgs = RNG.integers(-128, 128, (2, 13, 18)).astype(np.int32)
    want = np.asarray(j_fused(imgs, kern, "proposed", kernel_kind="lut"))
    np.testing.assert_array_equal(want, _lut_conv(imgs, kern, "proposed"))
    for kind in ("closed_form", "lut"):
        assert fc.conv_design(_taps(kern), "proposed") == "tiled"
        _check_all(imgs, kern, "proposed", kind, want)
    _check_all(imgs, kern, "exact", "lut", _lut_conv(imgs, kern, "exact"))


def test_tiled_log7_matches_the_closed_form_kind():
    """A 7×7 Laplacian of Gaussian at width 12 (int32 columns and byte
    tables) against the reference's fused conv in its closed-form kind."""
    imgs = RNG.integers(-2048, 2048, (2, 15, 21)).astype(np.int32)
    _check_all(imgs, LOG7, "proposed@12", "closed_form",
               np.asarray(j_fused(imgs, LOG7, "proposed@12", kernel_kind="closed_form")))


def _oracle(imgs, kern, key: str) -> np.ndarray:
    """'same' conv summed tap by tap from the closed form's plain twin
    (``closed_form_from_params``), any width, pixels anywhere in int32."""
    key = mult.canonical_key(key)
    kern = np.asarray(kern, np.int32)
    kh, kw = kern.shape
    _, h, w = imgs.shape
    x = torch.from_numpy(np.pad(imgs, ((0, 0), (kh // 2, kh // 2), (kw // 2, kw // 2))))
    params = closed_form_params(key)
    out = torch.zeros(imgs.shape, dtype=torch.int32)
    for di in range(kh):
        for dj in range(kw):
            out += closed_form_from_params(x[:, di:di + h, dj:dj + w],
                                           torch.tensor(int(kern[di, dj]), dtype=torch.int32),
                                           params)
    return out.numpy()


@pytest.mark.parametrize("kern", [np.ones((1, 7), np.int32),
                                  RNG.integers(-9, 10, (6, 2)).astype(np.int32),
                                  RNG.integers(-9, 10, (2, 11)).astype(np.int32)],
                         ids=["1x7", "6x2", "2x11"])
def test_tiled_uneven_kernels(kern):
    """One side beyond 5 and the other within it, even sizes (the window
    sits one row or column up), in both kinds and at width 12."""
    imgs = RNG.integers(-128, 128, (2, 9, 23)).astype(np.int32)
    for kind in ("closed_form", "lut"):
        _check_all(imgs, kern, "csp_axc1@6", kind, _lut_conv(imgs, kern, "csp_axc1@6"))
    wide = (imgs << 4).astype(np.int32)
    want = _oracle(wide, kern, "proposed@12")
    if kern.shape == (6, 2):
        np.testing.assert_array_equal(np.asarray(j_fused(wide, kern, "proposed@12")), want)
    _check_all(wide, kern, "proposed@12", "closed_form", want)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (20, 7), (33, 47), (17, 129)])
def test_tiled_ragged_shapes(shape):
    """H and W that are no multiple of the tile: width 12 under the
    Laplacian against the reference, ``exact`` 7×7 against its table."""
    imgs = RNG.integers(-2048, 2048, (2, *shape)).astype(np.int32)
    _check_all(imgs, conv.LAPLACIAN, "proposed@12", "closed_form",
               np.asarray(j_fused(imgs, jconv.LAPLACIAN, "proposed@12")))
    k7 = RNG.integers(-100, 100, (7, 7)).astype(np.int32)
    small = np.clip(imgs, -128, 127)
    _check_all(small, k7, "exact", "lut", _lut_conv(small, k7, "exact"))


def test_tiled_zero_border_is_looked_up():
    """An all-zero image answers Σ f(0, c) at every pixel, border included:
    out-of-image pixels are 0 and still read their product (f(0, c) ≠ 0)."""
    imgs = np.zeros((1, 6, 9), np.int32)
    for key, kern in (("proposed@12", jconv.LAPLACIAN), ("proposed@16", jconv.LAPLACIAN),
                      ("proposed", RNG.integers(-100, 100, (7, 7)))):
        f0 = closed_form_from_params(torch.zeros(1, dtype=torch.int32),
                                     torch.tensor(np.ravel(kern), dtype=torch.int32),
                                     closed_form_params(mult.canonical_key(key)))
        want = np.full(imgs.shape, int(f0.sum()), np.int32)
        assert (want != 0).all()
        if np.shape(kern) == (3, 3):
            np.testing.assert_array_equal(np.asarray(j_fused(imgs, kern, key)), want)
        _check_all(imgs, kern, key, "closed_form", want)


def test_tiled_pixels_anywhere_in_int32():
    """Pixels beyond the operand width wrap: the column index (x + 2^(n−1))
    & (2^n − 1) equals that wrap for every int32 x, in every product data;
    held against the closed form summed tap by tap."""
    imgs = RNG.integers(-2**31, 2**31, (2, 9, 14), dtype=np.int64).astype(np.int32)
    for key, kern in (("proposed@9", RNG.integers(-900, 900, (3, 3))),
                      ("proposed@16", conv.LAPLACIAN),
                      ("csp_axc1@13", RNG.integers(-2**20, 2**20, (7, 7))),
                      ("proposed", RNG.integers(-300, 300, (7, 7)))):
        _check_all(imgs, kern, key, "closed_form", _oracle(imgs, kern, key))
    _check_all(imgs, kern, "exact", "lut", _lut_conv(imgs, kern, "exact"))


def _oracle_columns(taps: list, key: str) -> torch.Tensor:
    """(len(taps), 2^n) products f(u − 2^(n−1), c) from the closed form's
    plain twin, the oracle of the product data."""
    n = _width(key)
    x = torch.arange(1 << n, dtype=torch.int32) - (1 << (n - 1))
    return closed_form_from_params(x[None, :],
                                   torch.tensor(taps, dtype=torch.int32)[:, None],
                                   closed_form_params(key))


def _read(prod: torch.Tensor, slot: int, source: str, n: int) -> torch.Tensor:
    """Row ``slot`` of the product data read at every column index."""
    u = torch.arange(1 << n)
    if source == "bytes":
        return prod[slot][u & 255] + prod[slot][256 + (u >> 8)]
    return prod[slot]


@pytest.mark.parametrize("key", sorted(
    {f"{w}@{n}" for n in range(9, 17) for w in ("proposed", "csp_axc1")}
    | {f"{w}@{n}" for n in (12, 16) for w in WIRINGS}))
def test_product_data_every_pixel_value(key):
    """Both product data of widths 9..16, every pixel value, for a seeded
    set of taps, the extremes, and taps beyond the width (which wrap); two
    wirings at every width, every wiring at 12 and 16 (and at 9..11 below,
    on every pair)."""
    n = _width(key)
    hi = 1 << (n - 1)
    taps = sorted(set(RNG.integers(-hi, hi, 6).tolist())
                  | {-hi, -hi + 1, -1, 0, 1, hi - 2, hi - 1}) + [hi, 3 * hi + 5, -2**31]
    kern = (tuple(taps),)
    want = _oracle_columns(taps, key)
    for source, build_ in (("columns", fused_conv_columns32),
                           ("bytes", fused_conv_byte_tables)):
        slots, prod = build_(kern, key, "cpu")
        assert prod.dtype == torch.int32
        assert prod.shape[1] == (1 << n if source == "columns" else 256 + (1 << (n - 8)))
        for t, c in enumerate(taps):
            assert torch.equal(_read(prod, int(slots[t]), source, n), want[t]), (source, c)


@pytest.mark.parametrize("key", [f"{w}@{n}" for n in (9, 10, 11) for w in WIRINGS])
def test_product_data_every_pair(key):
    """Every tap × every pixel value at widths 9..11: the int32 columns of
    all 2^n taps and the byte tables split from them."""
    n = _width(key)
    taps = list(range(-(1 << (n - 1)), 1 << (n - 1)))
    cols = fc._closed_form_columns(taps, key, "cpu")
    want = _oracle_columns(taps, key)
    assert torch.equal(cols, want)
    tabs = byte_tables_from_columns(cols, n)
    u = torch.arange(1 << n)
    assert torch.equal(tabs[:, u & 255] + tabs[:, 256 + (u >> 8)], want)


def test_byte_split_holds_by_the_closed_forms_structure():
    """Why the byte tables exist: at widths 9..16 no bit-monomial pair of any
    wiring's error terms has pixel-operand bits in both bytes
    (``monomials.wide_planes``), so f(., c) is a sum of a low-byte and a
    high-byte function; columns that do not split are refused."""
    for name in WIRINGS:
        for n in range(9, 17):
            pairs = monomials.wide_planes(closed_form_params(f"{name}@{n}")).pairs
            assert all(not (sa & 0xFF and sa >> 8) for sa, _, _ in pairs), (name, n)
    noise = torch.from_numpy(RNG.integers(-2**20, 2**20, (2, 1 << 10)).astype(np.int32))
    with pytest.raises(ValueError, match="do not split"):
        byte_tables_from_columns(noise, 10)


def test_product_data_built_once_per_key_and_taps():
    """One tensor per (key, taps, device), the same on every call; taps
    equal modulo 2^n share a column."""
    lap = _taps(conv.LAPLACIAN)
    for build_ in (fused_conv_columns32, fused_conv_byte_tables):
        s1, p1 = build_(lap, "proposed@12", "cpu")
        s2, p2 = build_(tuple(tuple(c + 4096 for c in row) for row in lap),
                        "proposed@12", "cpu")
        np.testing.assert_array_equal(s1, s2)
        assert p1 is p2 and p1.shape[0] == 2


def test_tiled_design_chooser():
    """Every conv the stencil design refuses takes the tiled design, to
    16 × 16 at widths to 16; the generic design only a kernel beyond 16 rows
    or columns; the product data by width and distinct taps."""
    lap = _taps(conv.LAPLACIAN)
    for key in ("proposed", "exact", "csp_axc1@6"):
        assert fc.conv_design(lap, key) == "stencil"
    for n in range(9, 17):
        assert fc.conv_design(lap, f"proposed@{n}") == "tiled"
        assert fc.tiled_design(n, 3, 3) and fc.tiled_design(n, 16, 16)
    for kh, kw in ((6, 6), (7, 7), (1, 7), (6, 1), (16, 16)):
        assert fc.conv_design(_taps(np.ones((kh, kw), np.int32)), "proposed") == "tiled"
    for kh, kw in ((17, 1), (1, 17), (2, 100)):
        assert not fc.tiled_design(8, kh, kw)
        assert fc.conv_design(_taps(np.ones((kh, kw), np.int32)), "proposed") == "generic"
    assert not fc.tiled_design(17, 3, 3)
    # product data: int16 columns to width 8; int32 columns staged to
    # TILED_SMEM bytes, read from global memory to TILED_L1; byte tables
    # staged to TILED_SMEM, else read from global memory
    assert fc.tiled_source(8, 256) == "columns16"
    assert fc.tiled_source(12, 2) == "columns32"
    assert fc.tiled_source(9, 46) == "columns32_global"
    assert fc.tiled_source(14, 2) == "bytes" and fc.tiled_source(12, 49) == "bytes"
    assert fc.tiled_source(16, 2) == "bytes"
    assert fc.tiled_source(16, 49) == "bytes_global"
    for n in range(9, 17):
        for d in (1, 2, 9, 49, 256):
            cols, tabs = d * (4 << n), d * 4 * (256 + (1 << (n - 8)))
            want = ("columns32" if cols <= fc.TILED_SMEM else
                    "columns32_global" if cols <= fc.TILED_L1 else
                    "bytes" if tabs <= fc.TILED_SMEM else "bytes_global")
            assert fc.tiled_source(n, d) == want, (n, d)
    assert set(fc.TILED_SOURCES) == {"columns16", "columns32", "columns32_global",
                                     "bytes", "bytes_global"}
    x = torch.zeros((1, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="tiled design does not take"):
        fc._launch(x, _taps(np.ones((17, 1), np.int32)), "proposed", "closed_form",
                   design="tiled")
    with pytest.raises(ValueError, match="the closed form's"):
        tiled_products(lap, "proposed@12", "lut", "cpu", "bytes")
    with pytest.raises(ValueError, match="widths 9..16"):
        fused_conv_columns32(lap, "proposed", "cpu")
    with pytest.raises(ValueError, match="unknown tiled product source"):
        tiled_products(lap, "proposed@12", "closed_form", "cpu", "tile")
