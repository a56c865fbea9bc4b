"""The rows design of the port's two contraction kernels, on the CPU.

``csrc/rows_contract.cuh`` contracts many rows (M > 16) on the INT8 tensor
cores as an exact int8 GEMM plus a few bit-monomial int8 GEMMs: the product
table taken apart by ``kernels.monomials``. Its plain twin is
``blocking.rows_matmul_plain``. Here, without a card:

* the decomposition of every wiring at widths 3..8 and of ``exact`` rebuilds
  the port's tables and ``repro.core.lut.build_lut``'s exhaustively, bit for
  bit, and the kernel's layout of it (``monomials.device_planes``) with the
  kernel's per-word arithmetic (the SIMD-within-a-word bit test, the
  sign-replicating byte permute, the wrap of narrow codes) gives the table
  back for every pair of raw int8 codes;
* the plain twin equals ``repro``'s Pallas kernels (interpret mode off-TPU)
  and the port's tile plain versions at ragged shapes (M ∈ {17, 33}, K no
  multiple of 32, N odd, B = 2), on a case whose int32 sums wrap, and adds
  f(0,0) once per real k row and never for padding;
* ``blocking.rows_design`` and the dispatch order
  (``blocking.eligible_designs`` / ``resolve_design``) as pure functions.
"""
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.core import multiplier as jm
from repro.kernels.approx_matmul.ops import closed_form_matmul as j_cfm
from repro.kernels.lut_matmul.ops import lut_matmul as j_lut_matmul
from repro_torch.kernels import blocking, monomials
from repro_torch.kernels.approx_matmul import ops as am
from repro_torch.kernels.lut_matmul import ops as lm

RNG = np.random.default_rng(18)
WIRINGS = sorted(jm.WIRINGS)
KEYS = [f"{name}@{n}" for name in WIRINGS + ["exact"] for n in range(3, 9)]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _offset_layout(rebuilt: np.ndarray, n: int) -> np.ndarray:
    """A table indexed by unsigned codes [u(a), u(b)] → build_lut's layout
    [a + 2^(n−1), b + 2^(n−1)]."""
    xi = np.arange(1 << n) ^ (1 << (n - 1))
    return rebuilt[xi[:, None], xi[None, :]]


@pytest.mark.parametrize("key", KEYS)
def test_decomposition_rebuilds_every_table(key):
    """Exhaustive and bit for bit: the planes of the port's table (and, for
    a wiring, of the closed form's int16 table) give back repro's table."""
    n = jm.split_width(key)[1]
    want = jlut.build_lut(key).astype(np.int64)
    d = lm.rows_decomposition(lm.device_table(key, "cpu"))
    assert d is not None and d.n_bits == n and d.planes <= monomials.MAX_PLANES
    np.testing.assert_array_equal(_offset_layout(d.rebuild(), n), want)
    np.testing.assert_array_equal(
        lm.device_table(key, "cpu").numpy().reshape(want.shape), want)
    assert d.f00 == want[1 << (n - 1), 1 << (n - 1)] == jlut.f00(key)
    if key.startswith("exact"):
        assert d.planes == 0 and d.f00 == 0
    else:
        cf = am.rows_decomposition(key)
        assert (cf.masks, cf.scales, cf.f00) == (d.masks, d.scales, d.f00)
        np.testing.assert_array_equal(cf.factors, d.factors)
        np.testing.assert_array_equal(_offset_layout(cf.rebuild(), n), want)


def test_plane_counts():
    """proposed@8: 19 planes, all one int8 plane each (its factors reach +128
    but never −128: those take the negated mask); design_akbari2017@8 needs
    scale-256 planes; every wiring at widths 3..8 fits the kernel's 32."""
    d = am.rows_decomposition("proposed@8")
    assert (d.planes, d.f00) == (19, 192) and 256 not in d.scales
    assert d.pairs == 40  # monomial pairs (S, T) with S nonempty
    assert sorted(set(d.scales)) == [-1, 1]
    assert all(mask != 0 for mask in d.masks)  # f(0, b) is the constant 192
    ak = am.rows_decomposition("design_akbari2017@8")
    assert 256 in ak.scales and ak.planes <= monomials.MAX_PLANES
    assert max(am.rows_decomposition(f"{name}@{n}").planes
               for name in WIRINGS for n in range(3, 9)) <= monomials.MAX_PLANES
    assert am.rows_decomposition("proposed@8") is d  # cached per key


def _sign_bytes(x: np.ndarray) -> np.ndarray:
    """prmt's sign replication: each byte 0xFF where its bit 7 is set."""
    out = np.zeros_like(x)
    for i in range(4):
        out |= np.where((x >> (8 * i + 7)) & 1, np.uint32(0xFF << (8 * i)),
                        np.uint32(0))
    return out


def _bytes(words: np.ndarray) -> np.ndarray:
    """uint32 words → their 4 bytes each as int8, low byte first."""
    return words.astype("<u4").view(np.int8).astype(np.int64)


@pytest.mark.parametrize("key", KEYS)
def test_device_planes_with_the_kernels_word_arithmetic(key):
    """rows_contract.cuh's arithmetic on 32-bit words of 4 raw codes, in
    numpy: every pair of raw int8 codes gives the table's product of their
    low n bits."""
    n = jm.split_width(key)[1]
    d = lm.rows_decomposition(lm.device_table(key, "cpu"))
    words = monomials.device_planes(d).view(np.uint32)
    masks, abytes = words[:32], words[32:64]
    groups = (len(words) - 64) // 256
    rows = words[64:].reshape(256, groups)
    codes = np.arange(256, dtype=np.uint32)
    packed = codes.reshape(64, 4)
    xw = (packed[:, 0] | packed[:, 1] << 8 | packed[:, 2] << 16
          | packed[:, 3] << 24).astype(np.uint32)
    if n < 8:  # RcWrap
        mask, sign = (1 << n) - 1, 1 << (n - 1)
        wrapped = ((((xw & np.uint32(mask * 0x01010101)) ^ np.uint32(sign * 0x01010101))
                    + np.uint32((0x80 - sign) * 0x01010101)) ^ np.uint32(0x80808080))
    else:
        wrapped = xw
    value = _bytes(wrapped)  # the wrapped value of each raw code
    got = value[:, None] * value[None, :] + d.f00
    for p in range(d.planes):
        low = masks[p] & np.uint32(0x7F7F7F7F)
        top = ~(masks[p] & np.uint32(0x80808080))
        t = (np.uint32(0x80808080) - (~xw & low)) & (xw | top)
        a_side = _bytes(_sign_bytes(t) & abytes[p])
        factor = _bytes(rows[:, p // 4])[np.arange(256) * 4 + p % 4]
        got = got + a_side[:, None] * factor[None, :]
    lut = jlut.build_lut(key).astype(np.int64)
    off = 1 << (n - 1)
    idx = (codes.astype(np.int64) + off) & ((1 << n) - 1)
    np.testing.assert_array_equal(got, lut[idx[:, None], idx[None, :]])


def _shape(i: int):
    """(M, K, N): M ∈ {17, 33}, K no multiple of 32, N odd."""
    return (17, 33)[i % 2], (45, 70, 100)[i % 3], (17, 31)[(i // 2) % 2]


def _rows_plain(a, b, key):
    n = jm.split_width(key)[1]
    if key.startswith("exact"):
        d = lm.rows_decomposition(lm.device_table(key, "cpu"))
    else:
        d = am.rows_decomposition(key)
    return blocking.rows_matmul_plain(_t(a), _t(b), d, n).numpy()


@pytest.mark.parametrize("key", [f"{name}@{n}" for name in WIRINGS for n in (4, 6, 8)]
                         + [f"exact@{n}" for n in range(3, 9)])
def test_rows_twin_matches_pallas(key):
    """Ragged shapes, B = 2 with a distinct weight per batch: the plain twin
    against repro's closed-form or LUT kernel per batch, and the port's tile
    plain versions."""
    n = jm.split_width(key)[1]
    m, k, nn = _shape(KEYS.index(key))
    assert blocking.rows_design(m, k, nn, n)
    hi = 1 << (n - 1)
    a = RNG.integers(-hi, hi, (2, m, k)).astype(np.int32)
    b = RNG.integers(-hi, hi, (2, k, nn)).astype(np.int32)
    got = _rows_plain(a, b, key)
    for i in range(2):
        if key.startswith("exact"):
            want = np.asarray(j_lut_matmul(a[i], b[i], jlut.flat_lut(key)))
        else:
            want = np.asarray(j_cfm(a[i], b[i], key))
        np.testing.assert_array_equal(got[i], want, err_msg=f"{key} {(m, k, nn)}")
    table = lm.device_table(key, "cpu")
    np.testing.assert_array_equal(got, lm.lut_matmul_plain(_t(a), _t(b), table).numpy())
    if not key.startswith("exact"):
        np.testing.assert_array_equal(
            got, am.closed_form_matmul_plain(_t(a), _t(b), key).numpy())


@pytest.mark.parametrize("key", ["proposed@4", "csp_axc1@6", "design_akbari2017@8"])
def test_rows_twin_wraps_out_of_range_operands_like_pallas(key):
    """Operands anywhere in int32 (and their int8 codes) wrap to their low n
    bits, as in repro."""
    a = RNG.integers(-2**31, 2**31, (33, 70), dtype=np.int64).astype(np.int32)
    b = RNG.integers(-2**31, 2**31, (70, 31), dtype=np.int64).astype(np.int32)
    want = np.asarray(j_cfm(a, b, key))
    np.testing.assert_array_equal(_rows_plain(a[None], b[None], key)[0], want)
    a8, b8 = blocking.codes8(_t(a)), blocking.codes8(_t(b))
    np.testing.assert_array_equal(
        _rows_plain(a8.numpy()[None], b8.numpy()[None], key)[0], want)


@pytest.mark.parametrize("key", ["proposed@8", "design_akbari2017@8", "exact"])
def test_rows_twin_int32_sums_wrap(key):
    """Sums beyond int32: K = 200000 rows of operands -128 and -127 (products
    near 2^14), the exact sum from repro's table in int64, wrapped."""
    k = 200_000
    a = np.full((1, 17, k), -128, np.int32)
    a[0, :, ::7] = RNG.integers(-128, 128, (17, len(range(0, k, 7))))
    b = RNG.integers(-128, -126, (1, k, 3)).astype(np.int32)
    lut = jlut.build_lut(key).astype(np.int64)
    exact = lut[a[0][:, :, None] + 128, b[0][None, :, :] + 128].sum(axis=1)
    assert (np.abs(exact) > 2**31).any()
    np.testing.assert_array_equal(_rows_plain(a, b, key)[0],
                                  exact.astype(np.int32))


def test_rows_twin_adds_f00_per_real_row_only():
    """Zero operands give f(0,0) once per real k row (K = 45, no multiple of
    the kernel's 32-row chunks); k rows of zero codes appended to both
    operands are real rows and add f(0,0) each."""
    d = am.rows_decomposition("proposed@8")
    a = torch.zeros((2, 17, 45), dtype=torch.int8)
    b = torch.zeros((2, 45, 9), dtype=torch.int8)
    assert (blocking.rows_matmul_plain(a, b, d, 8) == 45 * 192).all()
    a = _t(RNG.integers(-128, 128, (1, 17, 45)).astype(np.int8))
    b = _t(RNG.integers(-128, 128, (1, 45, 9)).astype(np.int8))
    base = blocking.rows_matmul_plain(a, b, d, 8)
    grown = blocking.rows_matmul_plain(torch.nn.functional.pad(a, (0, 19)),
                                       torch.nn.functional.pad(b, (0, 0, 0, 19)), d, 8)
    torch.testing.assert_close(grown, base + 19 * 192, rtol=0, atol=0)
    torch.testing.assert_close(base, am.closed_form_matmul_plain(
        a.to(torch.int32), b.to(torch.int32), "proposed@8"), rtol=0, atol=0)


def test_rows_twin_refuses_another_width():
    d = am.rows_decomposition("proposed@8")
    with pytest.raises(ValueError, match="width-8"):
        blocking.rows_matmul_plain(torch.zeros((1, 17, 4), dtype=torch.int8),
                                   torch.zeros((1, 4, 3), dtype=torch.int8), d, 6)


def test_decompose_refuses_what_it_cannot_take():
    """A table whose factors reach beyond the int8 planes, and one of the
    wrong length; the tile design takes such tables."""
    noise = RNG.integers(-2**20, 2**20, 1 << 16).astype(np.int32)
    with pytest.raises(ValueError, match="beyond int8 planes"):
        monomials.decompose(noise)
    assert monomials.try_decompose(noise) is None
    assert lm.rows_decomposition(_t(noise)) is None
    with pytest.raises(ValueError, match="not a flat product table"):
        monomials.decompose(np.zeros(1000, np.int32))
    # 40 small planes: representable, but beyond the kernel's 32
    masks = tuple(int(s) for s in RNG.choice(np.arange(1, 256), 40, replace=False))
    many = monomials.Decomposition(
        8, 0, masks, (1,) * 40, RNG.integers(1, 3, (40, 256)).astype(np.int8), 0)
    flat = _offset_layout(many.rebuild(), 8).reshape(-1)
    assert monomials.decompose(flat).planes == 40
    assert monomials.try_decompose(flat) is None
    assert lm.rows_decomposition(_t(flat.astype(np.int32))) is None


@pytest.mark.parametrize("m,k,n,n_bits,rows", [
    (256, 4096, 4096, 8, True), (256, 16384, 4096, 8, True),  # the LM shapes
    (17, 17, 1, 8, True), (16, 17, 1, 8, False), (4096, 64, 9, 8, True),  # M
    (256, 9, 1, 8, False), (256, 16, 8, 8, False), (256, 17, 8, 8, True),  # narrow
    (256, 64, 64, 3, True), (256, 64, 64, 2, False), (256, 64, 64, 9, False),
    (256, 64, 64, 12, False),  # width
    (256, 0, 64, 8, False), (256, 64, 0, 8, False),  # empty
])
def test_rows_design_thresholds(m, k, n, n_bits, rows):
    assert blocking.rows_design(m, k, n, n_bits) is rows


@pytest.mark.parametrize("m,k,n,key,design", [
    (256, 4096, 4096, "proposed@8", "rows"), (8, 4096, 4096, "proposed@8", "decode"),
    (256, 9, 1, "proposed@8", "narrow"), (256, 4096, 4096, "proposed@12", "tile"),
    (16, 64, 64, "csp_axc1@6", "decode"), (17, 64, 64, "csp_axc1@6", "rows"),
    (256, 4096, 4096, "exact", "rows"), (8, 4096, 4096, "exact", "tensor"),
    (8, 4096, 4096, "exact@6", "decode"), (256, 9, 1, "exact", "narrow"),
    (256, 64, 64, "exact@6", "rows"), (256, 64, 64, "noise", "tile"),
    (8, 64, 64, "noise", "tile"),
])
def test_dispatch_order(m, k, n, key, design):
    """narrow → (lut_matmul: tensor) → decode → rows → tile, a pure function
    of shape and width (and of the table's checks for lut_matmul)."""
    noise = _t(RNG.integers(-2**20, 2**20, 1 << 16).astype(np.int32))
    if key == "noise" or key.startswith("exact"):
        table = noise if key == "noise" else lm.device_table(key, "cpu")
        width = lm.table_width(table.shape[0])
        eligible = blocking.eligible_designs(m, k, n, width, lm.table_checks(table))
    else:
        width = jm.split_width(key)[1]
        eligible = blocking.eligible_designs(m, k, n, width)
        assert "tensor" not in eligible
        table = lm.device_table(key, "cpu") if width <= 8 else None
        if table is not None:  # the product table goes the same way
            assert blocking.resolve_design(None, blocking.eligible_designs(
                m, k, n, width, lm.table_checks(table)), "lut_matmul", "") == design
    assert tuple(eligible) == tuple(d for d in blocking.DESIGN_ORDER if d in eligible)
    assert blocking.resolve_design(None, eligible, "kernel", "") == design
    if design != "rows":
        with pytest.raises(ValueError, match="rows design does not take"):
            blocking.resolve_design("rows", eligible, "kernel", "the shape")


def test_device_table_marks_the_planes_without_a_sync():
    """device_table builds the planes from its host copy once per key; a
    table not from it is taken apart once per tensor version."""
    t = lm.device_table("csp_axc1@6", "cpu")
    version, d, planes = t._rows_at
    assert version == t._version and d.planes == 9
    assert planes.dtype == torch.int32 and planes.numel() == 64 + 256 * 3
    u = t.clone()
    assert not hasattr(u, "_rows_at")
    assert lm.rows_decomposition(u).planes == 9
    u[:] = _t(RNG.integers(-2**20, 2**20, u.numel()).astype(np.int32))
    assert lm.rows_decomposition(u) is None  # an in-place edit is checked anew
