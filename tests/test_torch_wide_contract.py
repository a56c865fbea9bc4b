"""The wide design of the port's ``approx_matmul`` kernel, on the CPU.

``csrc/wide_contract.cuh`` contracts the closed form at widths 9..16 on the
INT8 tensor cores as a few dozen byte GEMMs: the closed form taken apart
from its parameter block by ``kernels.monomials.wide_planes``. Its plain
twin is ``blocking.wide_matmul_plain``. Here, without a card, with
``repro`` as the oracle:

* the planes rebuild ``repro``'s closed form exhaustively at widths 9..11
  for every wiring, where its final 2n-bit wrap is seen never to change a
  value, and on seeded random pairs plus the extreme operands at 12..16;
* the kernel's parameter block (``monomials.wide_device_params``) with the
  kernel's per-word arithmetic (byte planes of four codes a word, the AND
  and the SIMD-within-a-word bit test, the signed or unsigned bytes of each
  side's mma type, the accumulator groups folded by ±2^shift in the int32
  ring) gives the closed form back;
* the plain twin equals ``repro``'s Pallas kernel (interpret mode off-TPU)
  at ragged shapes (M ∈ {17, 33}, K no multiple of 32, N odd, B = 2) at
  widths 9, 12 and 16, on operands anywhere in int32, on a case whose int32
  sums wrap, and adds f(0,0) once per real k row;
* ``blocking.wide_design`` and the dispatch order as pure functions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multiplier as jm
from repro.kernels.approx_matmul.ops import closed_form_matmul as j_cfm
from repro.kernels.closed_form import make_closed_form as j_closed_form
from repro_torch.kernels import blocking, monomials
from repro_torch.kernels.approx_matmul import ops as am
from repro_torch.kernels.closed_form import closed_form_params

RNG = np.random.default_rng(28)
WIRINGS = sorted(jm.WIRINGS)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _width(key: str) -> int:
    return jm.split_width(key)[1]


def _repro(key, a, b) -> np.ndarray:
    """repro's closed form at int32 operands, as int64."""
    fn = j_closed_form(key)
    return np.asarray(fn(jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32))).astype(np.int64)


@pytest.mark.parametrize("key", [f"{w}@{n}" for n in (9, 10, 11) for w in WIRINGS])
def test_planes_rebuild_repro_exhaustively_and_the_wrap_never_fires(key, monkeypatch):
    """Every pair of n-bit operands: the planes' integer sum (no wrap) is
    repro's closed form, and repro's final wrap to 2n bits leaves every raw
    sum as it is."""
    n = _width(key)
    wrap = jm.wrap_to_width
    changed = []

    def spy(x, bits):
        y = wrap(x, bits)
        if bits == 2 * n:
            changed.append(bool(jnp.any(y != x)))
        return y

    monkeypatch.setattr(jm, "wrap_to_width", spy)
    v = np.arange(-(1 << (n - 1)), 1 << (n - 1))
    want = _repro(key, v[:, None], v[None, :])
    assert changed == [False]
    planes = am.wide_decomposition(key)
    got = planes.rebuild(v[:, None], v[None, :])
    np.testing.assert_array_equal(got, want)
    assert -(1 << (2 * n - 1)) <= got.min() and got.max() < 1 << (2 * n - 1)


@pytest.mark.parametrize("key", [f"{w}@{n}" for n in range(12, 17) for w in WIRINGS])
def test_planes_rebuild_repro_at_random_and_extreme_pairs(key):
    n = _width(key)
    hi = 1 << (n - 1)
    ext = np.array([-hi, -hi + 1, -2, -1, 0, 1, 2, hi - 2, hi - 1])
    a = np.concatenate([np.repeat(ext, len(ext)), RNG.integers(-hi, hi, 1 << 17)])
    b = np.concatenate([np.tile(ext, len(ext)), RNG.integers(-hi, hi, 1 << 17)])
    np.testing.assert_array_equal(am.wide_decomposition(key).rebuild(a, b),
                                  _repro(key, a, b))


def test_plane_counts():
    """P = 26 at proposed@12 and 29 at proposed@16: 4 exact byte GEMMs and
    14 / 22 truncation planes, less those that merge (the truncation's bits
    i <= n - 9 fold into the exact LO.LO plane: 4 planes at width 12, and
    at width 16 they cancel it, 9 planes), plus 12 pair planes, in 5 / 3
    accumulator groups; every wiring at widths 9..16 fits the kernel's 64
    planes and 8 groups; the constant is f(0,0)."""
    for key, planes, groups in (("proposed@12", 26, 5), ("proposed@16", 29, 3)):
        w = am.wide_decomposition(key)
        assert (len(w.planes), len(w.groups), len(w.pairs)) == (planes, groups, 12)
        assert w.f00 == int(_repro(key, 0, 0))
    for name in WIRINGS:
        for n in range(9, 17):
            w = am.wide_decomposition(f"{name}@{n}")
            assert len(w.planes) <= monomials.WIDE_MAX_PLANES
            assert len(w.groups) <= monomials.WIDE_MAX_GROUPS
            assert all(s and t for s, t, _ in w.pairs)  # no empty side
    assert am.wide_decomposition("proposed@12") is am.wide_decomposition("proposed@12")


@pytest.mark.parametrize("n", [9, 12, 16])
def test_planes_of_one_b_side_and_scale_are_merged(n):
    """No two planes with a masked low or high byte on the a side share a b
    side and a scale (they would be one GEMM), and none has an empty mask:
    the bound counts only GEMMs that the function needs."""
    for name in WIRINGS:
        w = am.wide_decomposition(f"{name}@{n}")
        seen = set()
        for p in w.planes:
            if p.a.kind in (monomials.LO, monomials.AND_LO, monomials.AND_HI):
                family = monomials.AND_HI if p.a.kind == monomials.AND_HI else monomials.AND_LO
                key = (family, p.b, p.shift, p.sign)
                assert key not in seen, (name, n, p)
                seen.add(key)
                assert p.a.kind == monomials.LO or p.a.mask


def test_wide_planes_refuse_other_widths():
    with pytest.raises(ValueError, match="widths 9..16"):
        monomials.wide_planes(closed_form_params("proposed@8"))
    with pytest.raises(ValueError, match="width-12 wide planes"):
        blocking.wide_matmul_plain(torch.zeros((1, 17, 4), dtype=torch.int32),
                                   torch.zeros((1, 4, 3), dtype=torch.int32),
                                   am.wide_decomposition("proposed@12"), 16)


# -- the kernel's arithmetic on 32-bit words of four codes, in numpy --------

def _sign_bytes(x):
    out = np.zeros_like(x)
    for i in range(4):
        out |= np.where((x >> np.uint32(8 * i + 7)) & np.uint32(1),
                        np.uint32(0xFF << (8 * i)), np.uint32(0))
    return out


def _test(x, low, top):
    return (np.uint32(0x80808080) - (~x & low)) & (x | top)


def _side(kind, lo, hi, q):
    q = [np.uint32(v) for v in q]
    if kind == monomials.LO:
        return lo
    if kind == monomials.HI:
        return hi
    if kind == monomials.AND_LO:
        return lo & q[0]
    if kind == monomials.AND_HI:
        return hi & q[0]
    if kind == 5:  # the test's mask in the low byte only
        return _sign_bytes(_test(lo, q[0], q[1])) & q[4]
    if kind == 6:  # in the high byte only
        return _sign_bytes(_test(hi, q[2], q[3])) & q[4]
    return _sign_bytes(_test(lo, q[0], q[1]) & _test(hi, q[2], q[3])) & q[4]


def _bytes(words, signed):
    b = words.astype("<u4").view(np.uint8).astype(np.int64)
    return np.where(b >= 128, b - 256, b) if signed else b


def _kernel_products(key, va, vb) -> np.ndarray:
    """f(va[i], vb[j]) as wide_contract.cuh computes one k row of it: the
    split kernel's wrap and byte planes, each plane's sides on words of four
    codes, the group sums folded by their multipliers in the int32 ring,
    then f00."""
    n = _width(key)
    prm = am._wide_params(key).view(np.uint32).astype(np.int64)
    n_groups = int(prm[1])
    sh = 32 - n

    def planes(v):
        w = (v.astype(np.int64) << sh) & 0xFFFFFFFF
        w = np.where(w >= 1 << 31, w - (1 << 32), w) >> sh  # signed shifts
        lo = (w & 0xFF).astype(np.uint8).view("<u4").astype(np.uint32)
        hi = ((w >> 8) & 0xFF).astype(np.uint8).view("<u4").astype(np.uint32)
        return lo, hi

    (alo, ahi), (blo, bhi) = planes(va), planes(vb)
    acc = np.zeros((len(va), len(vb)), np.uint64)
    p = 0
    for g in range(n_groups):
        tmp = np.zeros((len(va), len(vb)), np.int64)
        while p < prm[2 + g]:
            at = 2 + 2 * monomials.WIDE_MAX_GROUPS + p * monomials.WIDE_PLANE_WORDS
            w = prm[at:at + monomials.WIDE_PLANE_WORDS]
            kinds = int(w[0])
            av = _bytes(_side(kinds & 0xFF, alo, ahi, w[1:6]), (kinds >> 16) & 1)
            bv = _bytes(_side((kinds >> 8) & 0xFF, blo, bhi, w[6:11]), (kinds >> 24) & 1)
            tmp += av[:, None] * bv[None, :]
            p += 1
        assert np.abs(tmp).max() < 1 << 31  # the mma accumulator never overflows
        mul = np.uint64(int(prm[2 + monomials.WIDE_MAX_GROUPS + g]) & 0xFFFFFFFF)
        acc = (acc + (tmp.astype(np.uint64) & np.uint64(0xFFFFFFFF)) * mul) \
            & np.uint64(0xFFFFFFFF)
    assert p == prm[0]
    f00 = np.uint64(am.wide_decomposition(key).f00 & 0xFFFFFFFF)
    acc = ((acc + f00) & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return np.where(acc >= 1 << 31, acc - (1 << 32), acc)


@pytest.mark.parametrize("key", [f"{w}@{n}" for n in (9, 12, 16) for w in WIRINGS])
def test_device_params_with_the_kernels_word_arithmetic(key):
    """Operands anywhere in int32 (the extremes among them), four codes a
    word: the kernel's arithmetic gives repro's closed form."""
    n = _width(key)
    hi = 1 << (n - 1)
    va = RNG.integers(-2**31, 2**31, 256, dtype=np.int64)
    vb = RNG.integers(-2**31, 2**31, 256, dtype=np.int64)
    va[:8] = [-hi, hi - 1, 0, -1, 1, hi, -hi - 1, 2**31 - 1]
    vb[:8] = [hi - 1, -hi, -1, 0, 1, -hi - 1, hi, -2**31]
    want = _repro(key, va.astype(np.int32)[:, None], vb.astype(np.int32)[None, :])
    np.testing.assert_array_equal(_kernel_products(key, va, vb), want)


# -- the plain twin against repro's Pallas kernel ---------------------------

def _shape(i: int):
    """(M, K, N): M ∈ {17, 33}, K no multiple of 32, N odd."""
    return (17, 33)[i % 2], (45, 70, 100)[i % 3], (17, 31)[(i // 2) % 2]


TWIN_KEYS = ["proposed@9", "proposed@12", "proposed@16", "design_akbari2017@12",
             "design_strollo2020@16", "trunc_exact_csp@9"]


@pytest.mark.parametrize("key", TWIN_KEYS)
def test_wide_twin_matches_pallas(key):
    """Ragged shapes, B = 2 with a distinct weight per batch, operands
    anywhere in int32 (they wrap to their low n bits): the plain twin
    against repro's closed-form kernel per batch and the port's plain
    closed form."""
    n = _width(key)
    m, k, nn = _shape(TWIN_KEYS.index(key))
    assert blocking.wide_design(m, k, nn, n)
    a = RNG.integers(-2**31, 2**31, (2, m, k), dtype=np.int64).astype(np.int32)
    b = RNG.integers(-2**31, 2**31, (2, k, nn), dtype=np.int64).astype(np.int32)
    got = blocking.wide_matmul_plain(_t(a), _t(b), am.wide_decomposition(key), n).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], np.asarray(j_cfm(a[i], b[i], key)),
                                      err_msg=f"{key} {(m, k, nn)}")
    np.testing.assert_array_equal(
        got, am.closed_form_matmul_plain(_t(a), _t(b), key).numpy())


@pytest.mark.parametrize("key", ["proposed@16", "design_akbari2017@16"])
def test_wide_twin_int32_sums_wrap(key):
    """Products near 2^30 (operands at the 16-bit extremes), K = 70: sums
    beyond int32, the exact int64 sum of repro's products, wrapped."""
    a = np.full((1, 17, 70), -32768, np.int32)
    a[0, :, ::5] = RNG.integers(-32768, 32768, (17, 14))
    b = RNG.integers(-32768, -32760, (1, 70, 9)).astype(np.int32)
    prods = _repro(key, a[0][:, :, None], b[0][None, :, :])
    exact = prods.sum(axis=1)
    assert (np.abs(exact) > 2**31).any()
    got = blocking.wide_matmul_plain(_t(a), _t(b), am.wide_decomposition(key), 16)
    np.testing.assert_array_equal(got[0].numpy(), exact.astype(np.int32))


def test_wide_twin_adds_f00_per_real_row_only():
    """Zero operands give f(0,0) once per real k row (K = 45, no multiple of
    the kernel's 32-row chunks); zero rows appended to both operands are real
    rows and add f(0,0) each."""
    w = am.wide_decomposition("proposed@12")
    f00 = w.f00
    assert f00 != 0
    a = torch.zeros((2, 17, 45), dtype=torch.int32)
    b = torch.zeros((2, 45, 9), dtype=torch.int32)
    assert (blocking.wide_matmul_plain(a, b, w, 12) == 45 * f00).all()
    a = _t(RNG.integers(-2048, 2048, (1, 17, 45)).astype(np.int32))
    b = _t(RNG.integers(-2048, 2048, (1, 45, 9)).astype(np.int32))
    base = blocking.wide_matmul_plain(a, b, w, 12)
    grown = blocking.wide_matmul_plain(torch.nn.functional.pad(a, (0, 19)),
                                       torch.nn.functional.pad(b, (0, 0, 0, 19)), w, 12)
    torch.testing.assert_close(grown, base + 19 * f00, rtol=0, atol=0)
    torch.testing.assert_close(base, am.closed_form_matmul_plain(a, b, "proposed@12"),
                               rtol=0, atol=0)


# -- dispatch, as pure functions --------------------------------------------

@pytest.mark.parametrize("m,k,n,n_bits,wide", [
    (256, 4096, 4096, 12, True), (8, 16384, 4096, 16, True),  # the LM shapes
    (1, 1, 1, 9, True), (4096, 9, 1, 12, True),  # any shape, narrow ones too
    (256, 64, 64, 8, False), (256, 64, 64, 17, False), (256, 64, 64, 3, False),
    (256, 0, 64, 12, False), (0, 64, 64, 12, False),  # empty
])
def test_wide_design_thresholds(m, k, n, n_bits, wide):
    assert blocking.wide_design(m, k, n, n_bits) is wide


@pytest.mark.parametrize("m,k,n,key,design", [
    (256, 4096, 4096, "proposed@12", "wide"), (8, 4096, 4096, "proposed@16", "wide"),
    (4096, 9, 1, "proposed@12", "wide"), (256, 4096, 4096, "proposed@8", "rows"),
    (8, 4096, 4096, "proposed@8", "decode"), (4096, 9, 1, "proposed@8", "narrow"),
])
def test_dispatch_order(m, k, n, key, design):
    """narrow → decode → rows → wide → tile for approx_matmul; the tile
    design takes every shape but only where forced."""
    eligible = blocking.eligible_designs(m, k, n, _width(key))
    assert "tensor" not in eligible and "gather" not in eligible
    assert tuple(eligible) == ("narrow", "decode", "rows", "wide", "tile")
    assert blocking.resolve_design(None, eligible, "approx_matmul", "") == design
    assert blocking.resolve_design("tile", eligible, "approx_matmul", "") == "tile"


def test_forced_designs_are_checked_before_any_launch():
    a = torch.zeros((1, 17, 64), dtype=torch.int32)
    b = torch.zeros((1, 64, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="wide design does not take"):
        am._launch(a, b, "proposed@8", design="wide")
    with pytest.raises(ValueError, match="rows design does not take"):
        am._launch(a, b, "proposed@12", design="rows")
    with pytest.raises(ValueError, match="unknown approx_matmul design"):
        am._launch(a, b, "proposed@12", design="gather")


def test_cpu_tensors_run_the_plain_versions_without_launching():
    a = _t(RNG.integers(-2048, 2048, (1, 33, 70)).astype(np.int32))
    b = _t(RNG.integers(-2048, 2048, (1, 70, 17)).astype(np.int32))
    counters = (am.closed_form_matmul.wide_launches, am.closed_form_matmul.launches)
    before = [c.value for c in counters]
    got = am.closed_form_matmul(a, b, "proposed@12")
    assert [c.value for c in counters] == before
    np.testing.assert_array_equal(got.numpy(), blocking.wide_matmul_plain(
        a, b, am.wide_decomposition("proposed@12"), 12).numpy())
    assert blocking.wide_scratch_bytes(1, 33, 70, 17) == 2 * (128 + 128) * 96
