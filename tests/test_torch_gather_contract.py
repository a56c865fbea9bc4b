"""The gather design of the port's ``lut_matmul`` kernel, on the CPU.

``csrc/gather_contract.cuh`` takes every product table the other designs
refuse (entries beyond int16; an int16 table beyond the rows design's
planes at M > 16) at any shape: the table in shared memory, its int16 twin
or the int32 table in row windows, one gather a product. Its plain twin is
the table contraction itself, ``lut_matmul_plain``. Here, without a card,
with ``repro`` as the oracle:

* the plain version equals ``repro``'s Pallas kernel (interpret mode off-TPU)
  at ragged shapes (M ∈ {17, 33}, K no multiple of 32, N odd, B = 2) on the
  ±2^20 noise table (two windows at width 8), on an int16 table beyond 32
  planes, on an int32 table at width 7 (one window), on operands that
  wrap, and on a case whose int32 sums wrap;
* the windows: the passes over row windows add up to the whole;
* ``blocking.gather_design``, ``lut_matmul.table_checks`` and the dispatch
  order as pure functions of shape, width and table.
"""
import numpy as np
import pytest
import torch

from repro.kernels.lut_matmul.ops import lut_matmul as j_lut_matmul
from repro_torch.kernels import blocking
from repro_torch.kernels.lut_matmul import ops as lm

RNG = np.random.default_rng(28)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _tables() -> dict:
    """Flat int32 tables the gather design takes: beyond int16 (the noise
    table of chip_smoke.py, and one at width 7), and an int16 one beyond
    the rows design's planes."""
    rng = np.random.default_rng(2028)
    return {"noise": rng.integers(-2**20, 2**20, 1 << 16).astype(np.int32),
            "int16": rng.integers(-2**15, 2**15, 1 << 16).astype(np.int32),
            "int32@7": rng.integers(-2**31, 2**31, 1 << 14, dtype=np.int64).astype(np.int32)}


TABLES = _tables()


def test_the_tables_take_no_other_design():
    for name, flat in TABLES.items():
        t = _t(flat)
        assert lm.rows_decomposition(t) is None
        assert lm._fits_int16(t) is (name == "int16")
        assert lm.gather_table(t).dtype == (torch.int16 if name == "int16" else torch.int32)


@pytest.mark.parametrize("name,i", [(name, i) for name in TABLES for i in range(2)])
def test_gather_twin_matches_pallas(name, i):
    """Ragged shapes, B = 2 with a distinct weight per batch, int32
    operands anywhere in int32 (they wrap to their low n bits) and their
    int8 codes: the plain twin against repro's LUT kernel per batch."""
    flat = TABLES[name]
    n = lm.table_width(flat.size)
    m, k, nn = (17, 33)[i], (45, 70)[i], (31, 17)[i]
    a = RNG.integers(-2**31, 2**31, (2, m, k), dtype=np.int64).astype(np.int32)
    b = RNG.integers(-2**31, 2**31, (2, k, nn), dtype=np.int64).astype(np.int32)
    t = _t(flat)
    got = lm.lut_matmul_plain(_t(a), _t(b), t).numpy()
    for z in range(2):
        np.testing.assert_array_equal(got[z], np.asarray(j_lut_matmul(a[z], b[z], flat)),
                                      err_msg=f"{name} {(m, k, nn)}")
    if n == 8:  # int8 codes give the same integers
        a8, b8 = blocking.codes8(_t(a)), blocking.codes8(_t(b))
        np.testing.assert_array_equal(lm.lut_matmul_plain(a8, b8, t).numpy(), got)


def test_gather_twin_int32_sums_wrap():
    """Entries in [2^19, 2^20), K = 3000: sums beyond int32, the exact int64
    sum from the table, wrapped; at width 8 the table takes two windows."""
    flat = RNG.integers(2**19, 2**20, 1 << 16).astype(np.int32)
    a = RNG.integers(-128, 128, (1, 17, 3000)).astype(np.int32)
    b = RNG.integers(-128, 128, (1, 3000, 3)).astype(np.int32)
    grid = flat.reshape(256, 256).astype(np.int64)
    exact = grid[a[0][:, :, None] + 128, b[0][None, :, :] + 128].sum(axis=1)
    assert (exact > 2**31).all()
    got = lm.lut_matmul_plain(_t(a), _t(b), _t(flat))
    np.testing.assert_array_equal(got[0].numpy(), exact.astype(np.int32))


@pytest.mark.parametrize("n_bits,entry,rows", [(8, 4, 128), (8, 2, 256), (7, 4, 128),
                                               (6, 4, 64), (1, 2, 2)])
def test_window_rows(n_bits, entry, rows):
    """An int32 table at width 8 (256 KiB) takes two windows of 128 rows;
    every smaller one fits whole."""
    assert blocking.gather_window_rows(n_bits, entry) == rows
    assert (rows << n_bits) * entry <= blocking.GATHER_WINDOW_BYTES


def test_each_product_in_one_window():
    """The noise table's two windows: a table that keeps only one window's
    rows gives that window's pass; the two passes add up to the whole."""
    flat = TABLES["noise"].reshape(256, 256)
    a = _t(RNG.integers(-128, 128, (1, 33, 70)).astype(np.int32))
    b = _t(RNG.integers(-128, 128, (1, 70, 17)).astype(np.int32))
    halves = []
    for r0 in (0, 128):
        part = np.zeros_like(flat)
        part[r0:r0 + 128] = flat[r0:r0 + 128]
        halves.append(lm.lut_matmul_plain(a, b, _t(part.reshape(-1))))
    whole = lm.lut_matmul_plain(a, b, _t(flat.reshape(-1)))
    torch.testing.assert_close(halves[0] + halves[1], whole, rtol=0, atol=0)


# -- dispatch, as pure functions --------------------------------------------

@pytest.mark.parametrize("m,k,n,n_bits,gather", [
    (256, 4096, 4096, 8, True), (8, 64, 64, 8, True), (1, 1, 1, 1, True),
    (4096, 9, 1, 8, True), (256, 64, 64, 9, False), (256, 0, 64, 8, False),
    (0, 64, 64, 8, False),
    # where the tile design is faster on the card (tools/gather_sweep.py):
    # narrow N at many rows, the edge contraction among them
    (4194304, 9, 1, 8, False), (524288, 9, 128, 8, False),
    (1048576, 64, 32, 8, False), (1048576, 64, 64, 8, True),
    (131072, 512, 16, 8, False), (131072, 512, 32, 8, True),
    (65536, 4096, 1, 8, False), (256, 4096, 1, 8, True), (4097, 9, 1, 8, False),
])
def test_gather_design_thresholds(m, k, n, n_bits, gather):
    assert blocking.gather_design(m, k, n, n_bits) is gather


@pytest.mark.parametrize("m,k,n,table,design", [
    (256, 4096, 4096, "noise", "gather"), (8, 4096, 4096, "noise", "gather"),
    (4096, 9, 1, "noise", "gather"),  # beyond int16: no narrow columns
    (4194304, 9, 1, "noise", "tile"),  # the edge contraction: tile is faster
    (256, 4096, 4096, "int16", "gather"), (8, 4096, 4096, "int16", "decode"),
    (4096, 9, 1, "int16", "narrow"), (256, 64, 64, "int32@7", "gather"),
    (256, 64, 64, "proposed", "rows"), (8, 64, 64, "exact", "tensor"),
])
def test_dispatch_order(m, k, n, table, design):
    """narrow → tensor → decode → rows → gather → tile for lut_matmul; the
    gather design takes what the others refuse where it beats the tile
    design, which keeps narrow N at many rows."""
    t = _t(TABLES[table]) if table in TABLES else lm.device_table(table, "cpu")
    width = lm.table_width(t.numel())
    checks = lm.table_checks(t)
    assert checks["gather"]()
    eligible = blocking.eligible_designs(m, k, n, width, checks)
    assert tuple(eligible) == ("narrow", "tensor", "decode", "rows", "gather", "tile")
    assert blocking.resolve_design(None, eligible, "lut_matmul", "") == design
    assert eligible["gather"] is blocking.gather_design(m, k, n, width)


@pytest.mark.parametrize("m,k,n", [(4194304, 9, 1), (1048576, 64, 32), (17, 64, 64)])
def test_a_forced_gather_takes_any_shape(m, k, n):
    """The gather kernel runs at any shape: forced, it is eligible even where
    the dispatch keeps the tile design (narrow N at many rows)."""
    checks = lm.table_checks(_t(TABLES["noise"]))
    assert blocking.gather_takes(m, k, n, 8)
    forced = blocking.eligible_designs(m, k, n, 8, checks, forced="gather")
    assert blocking.resolve_design("gather", forced, "lut_matmul", "") == "gather"
    picked = blocking.resolve_design(None, blocking.eligible_designs(m, k, n, 8, checks),
                                     "lut_matmul", "")
    assert picked == ("gather" if blocking.gather_design(m, k, n, 8) else "tile")
    assert not blocking.gather_takes(m, k, n, 9)


def test_forced_designs_are_checked_before_any_launch():
    a = torch.zeros((1, 17, 64), dtype=torch.int8)
    b = torch.zeros((1, 64, 64), dtype=torch.int8)
    noise = _t(TABLES["noise"])
    with pytest.raises(ValueError, match="decode design does not take"):
        lm._launch(a[:, :8], b, noise, 8, design="decode")
    with pytest.raises(ValueError, match="rows design does not take"):
        lm._launch(a, b, noise, 8, design="rows")
    with pytest.raises(ValueError, match="unknown lut_matmul design"):
        lm._launch(a, b, noise, 8, design="wide")


def test_cpu_tensors_run_the_plain_versions_without_launching():
    t = _t(TABLES["noise"])
    a = _t(RNG.integers(-128, 128, (1, 33, 70)).astype(np.int8))
    b = _t(RNG.integers(-128, 128, (1, 70, 17)).astype(np.int8))
    counters = (lm.lut_matmul.gather_launches, lm.lut_matmul.launches)
    before = [c.value for c in counters]
    got = lm.lut_matmul(a, b, t)
    assert [c.value for c in counters] == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_lut_matmul(
        a.numpy().astype(np.int32)[0], b.numpy().astype(np.int32)[0],
        TABLES["noise"]))[None])
