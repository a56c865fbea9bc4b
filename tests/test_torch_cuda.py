"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere (the
decision is taken in a fixture, never at import). On a GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core import multiplier as mult
from repro_torch.data import mixed_shape_batch
from repro_torch.kernels import blocking
from repro_torch.kernels.approx_matmul import ops as am
from repro_torch.kernels.approx_matmul.ops import (closed_form_matmul,
                                                   closed_form_matmul_plain)
from repro_torch.kernels.approx_mul.ops import approx_mul, approx_mul_plain
from repro_torch.kernels.closed_form import approx_product_i32
from repro_torch.kernels.fused_conv import ops as fc
from repro_torch.kernels.fused_conv.ops import (fused_conv2d, fused_conv2d_plain,
                                                fused_conv_columns,
                                                stencil_conv_plain)
from repro_torch.kernels.lut_matmul import ops as lm
from repro_torch.kernels.lut_matmul.ops import (device_table, lut_matmul,
                                                lut_matmul_plain)
from repro_torch.nn import conv
from repro_torch.nn import substrate as sub
from repro_torch.serving import EdgeDetectService

PLAN = {"version": 1, "default": "approx_cuda:proposed@8",
        "rules": [{"site": "conv.edge.center", "spec": "approx_cuda:exact"},
                  {"site": "conv.edge.ring", "spec": "approx_cuda:csp_axc1@6"}]}

pytestmark = pytest.mark.cuda
RNG = np.random.default_rng(3)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(mult.WIRINGS))
def test_closed_form_device_function_exhaustive_n4(dev, name):
    """Every operand pair at width 4: (16 x 1) @ (1 x 16) takes the decode
    design (its table from the table kernel) and, forced, the tile design
    (the closed form per product)."""
    v = torch.arange(-8, 8, dtype=torch.int32, device=dev)
    before = (closed_form_matmul.decode_launches.value,
              closed_form_matmul.launches.value)
    got = closed_form_matmul(v[:, None], v[None, :], f"{name}@4").cpu().numpy()
    tile = am._launch(v[None, :, None], v[None, None, :], mult.canonical_key(
        f"{name}@4"), design="tile")[0].cpu().numpy()
    assert (closed_form_matmul.decode_launches.value,
            closed_form_matmul.launches.value) == (before[0] + 1, before[1] + 1)
    np.testing.assert_array_equal(got, lut_lib.build_lut(f"{name}@4"))
    np.testing.assert_array_equal(tile, lut_lib.build_lut(f"{name}@4"))


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (1, 17, 33, 9), (3, 65, 9, 3),
                                   (2, 40, 100, 70)])
def test_approx_matmul_kernel_vs_plain(dev, shape):
    b, m, k, n = shape
    a = torch.from_numpy(RNG.integers(-128, 128, (b, m, k)).astype(np.int32)).to(dev)
    w = torch.from_numpy(RNG.integers(-128, 128, (b, k, n)).astype(np.int32)).to(dev)
    for key in ("proposed", "design_strollo2020@4"):
        torch.testing.assert_close(closed_form_matmul(a, w, key),
                                   closed_form_matmul_plain(a, w, mult.canonical_key(key)),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 13, 17), (3, 33, 65)])
@pytest.mark.parametrize("kh_kw", [(1, 1), (2, 3), (3, 3), (5, 5)])
def test_fused_conv_kernel_vs_plain(dev, shape, kh_kw):
    x = torch.from_numpy(RNG.integers(-128, 128, shape).astype(np.int32)).to(dev)
    kern = RNG.integers(-9, 10, kh_kw).astype(np.int32)
    taps = tuple(tuple(int(c) for c in row) for row in kern)
    for key in ("proposed", "csp_axc5@4"):
        torch.testing.assert_close(fused_conv2d(x, kern, key),
                                   fused_conv2d_plain(x, taps, mult.canonical_key(key)),
                                   rtol=0, atol=0)


def test_service_on_the_card_matches_cpu(dev):
    imgs = mixed_shape_batch(6, shapes=((8, 8), (12, 10), (33, 47)), seed=2)
    outs = {}
    for device in ("cpu", "cuda"):
        svc = EdgeDetectService("approx_cuda", device=device, max_batch_size=2,
                                bucket_granularity=8, n_workers=2)
        try:
            outs[device] = svc.detect(imgs)
        finally:
            svc.close()
    for a, b in zip(outs["cpu"], outs["cuda"]):
        np.testing.assert_array_equal(a, b)
    px = conv.to_signed_pixels(torch.from_numpy(imgs[0])[None].to(dev))
    before = fused_conv2d.launches.value
    conv.conv2d_batched(px, conv.LAPLACIAN, "approx_cuda")
    assert fused_conv2d.launches.value == before + 1


@pytest.mark.parametrize("name", sorted(mult.WIRINGS) + ["exact"])
def test_lut_matmul_exhaustive_n4(dev, name):
    """Every operand pair at width 4 through the decode design (the public
    call) and the tile design (forced)."""
    key = f"{name}@4"
    v = torch.arange(-8, 8, dtype=torch.int32, device=dev)
    t = device_table(key, dev)
    before = (lut_matmul.decode_launches.value, lut_matmul.launches.value)
    got = lut_matmul(v[:, None], v[None, :], t)
    tile = lm._launch(v[None, :, None], v[None, None, :], t, 4, design="tile")[0]
    assert (lut_matmul.decode_launches.value, lut_matmul.launches.value) == (
        before[0] + 1, before[1] + 1)
    np.testing.assert_array_equal(got.cpu().numpy(), lut_lib.build_lut(key))
    np.testing.assert_array_equal(tile.cpu().numpy(), lut_lib.build_lut(key))


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (1, 17, 33, 9), (3, 65, 9, 3),
                                   (2, 40, 100, 70)])
def test_lut_matmul_kernel_vs_plain(dev, shape):
    b, m, k, n = shape
    a = torch.from_numpy(RNG.integers(-128, 128, (b, m, k)).astype(np.int32)).to(dev)
    w = torch.from_numpy(RNG.integers(-128, 128, (b, k, n)).astype(np.int32)).to(dev)
    for key in ("proposed", "exact", "design_strollo2020@4"):
        t = device_table(key, dev)
        torch.testing.assert_close(lut_matmul(a, w, t), lut_matmul_plain(a, w, t),
                                   rtol=0, atol=0)


def test_lut_matmul_k_tail_masks_the_product(dev):
    """K=17 leaves a 1-element tail in the kernel's 16-wide slab: a zero
    operand there would read f(0,0) = 192 (proposed@8) into the sum."""
    assert lut_lib.f00("proposed") == 192
    a = RNG.integers(-128, 128, (5, 17)).astype(np.int32)
    w = RNG.integers(-128, 128, (17, 3)).astype(np.int32)
    table = lut_lib.build_lut("proposed").astype(np.int64)
    want = table[a[:, :, None] + 128, w[None, :, :] + 128].sum(axis=1)
    a_d, w_d = torch.from_numpy(a).to(dev), torch.from_numpy(w).to(dev)
    got = lut_matmul(a_d, w_d, device_table("proposed", dev))  # decode design
    np.testing.assert_array_equal(got.cpu().numpy(), want.astype(np.int32))
    tile = lm._launch(a_d[None], w_d[None], device_table("proposed", dev), 8,
                      design="tile")[0]
    np.testing.assert_array_equal(tile.cpu().numpy(), want.astype(np.int32))
    with pytest.raises(ValueError, match="lies on"):
        lut_matmul(torch.from_numpy(a).to(dev), torch.from_numpy(w).to(dev),
                   device_table("proposed", "cpu"))


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 13, 17), (3, 33, 65)])
@pytest.mark.parametrize("kh_kw", [(1, 1), (3, 3), (5, 5)])
def test_fused_conv_lut_kind_vs_plain(dev, shape, kh_kw):
    x = torch.from_numpy(RNG.integers(-128, 128, shape).astype(np.int32)).to(dev)
    kern = RNG.integers(-128, 128, kh_kw).astype(np.int32)
    taps = tuple(tuple(int(c) for c in row) for row in kern)
    for key in ("exact", "proposed", "csp_axc5@4"):
        before = fused_conv2d.lut_launches.value
        got = fused_conv2d(x, kern, key, kernel_kind="lut")
        assert fused_conv2d.lut_launches.value == before + 1
        torch.testing.assert_close(got, fused_conv2d_plain(x, taps, key, "lut"),
                                   rtol=0, atol=0)
    torch.testing.assert_close(
        fused_conv2d(x, kern, "proposed", kernel_kind="lut"),
        fused_conv2d(x, kern, "proposed", kernel_kind="closed_form"),
        rtol=0, atol=0)


def test_fused_conv_lut_kind_zero_border(dev):
    """Out-of-image taps read 0 and are looked up: f(0, c) != 0 under
    kernel="lut" for a CSP wiring, and the whole 16x16 table (256 columns
    of int16 in shared memory, above the 48 KiB default) still launches."""
    x = torch.zeros((1, 5, 7), dtype=torch.int32, device=dev)
    taps = tuple(tuple(int(c) for c in row) for row in conv.LAPLACIAN)
    got = fused_conv2d(x, conv.LAPLACIAN, "csp_axc1", kernel_kind="lut")
    torch.testing.assert_close(got, fused_conv2d_plain(x, taps, "csp_axc1", "lut"),
                               rtol=0, atol=0)
    assert (got != 0).all()
    big = np.arange(-128, 128, dtype=np.int32).reshape(16, 16)
    xs = torch.from_numpy(RNG.integers(-128, 128, (2, 40, 50)).astype(np.int32)).to(dev)
    torch.testing.assert_close(
        fused_conv2d(xs, big, "proposed", kernel_kind="lut"),
        fused_conv2d_plain(xs, tuple(tuple(int(c) for c in r) for r in big),
                           "proposed", "lut"), rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 3, 4, 4097, 65536])
def test_approx_mul_kernel_vs_plain(dev, n):
    a = torch.from_numpy(RNG.integers(-2**31, 2**31, n, dtype=np.int64)
                         .astype(np.int32)).to(dev)
    b = torch.from_numpy(RNG.integers(-2**31, 2**31, n, dtype=np.int64)
                         .astype(np.int32)).to(dev)
    before = approx_mul.launches.value
    got = approx_mul(a, b)
    assert approx_mul.launches.value == before + 1
    torch.testing.assert_close(got, approx_mul_plain(a, b), rtol=0, atol=0)
    # a view one element in: not 16-byte aligned, the scalar kernel runs
    torch.testing.assert_close(approx_mul(a[1:], b[1:]),
                               approx_product_i32(a[1:], b[1:]), rtol=0, atol=0)


def test_planned_service_on_the_card_matches_cpu(dev):
    imgs = mixed_shape_batch(6, shapes=((8, 8), (12, 10), (33, 47)), seed=2)
    outs = {}
    for device in ("cpu", "cuda"):
        svc = EdgeDetectService(PLAN, device=device, max_batch_size=2,
                                bucket_granularity=8, n_workers=2)
        try:
            outs[device] = svc.detect(imgs)
        finally:
            svc.close()
    for a, b in zip(outs["cpu"], outs["cuda"]):
        np.testing.assert_array_equal(a, b)


# -- the narrow design of the two contraction kernels -------------------------

NARROW_SHAPES = [(1, 1, 1, 1), (1, 4099, 9, 1), (1, 1027, 8, 1),
                 (2, 77, 5, 3), (3, 64, 16, 8), (1, 5001, 1, 8),
                 (2, 1030, 9, 1)]


def _both_designs(a, w, key=None, table=None):
    """(narrow, tile, plain twin of narrow) of one contraction, each design
    launched once (checked on its counter)."""
    if table is None:
        n_bits = mult.split_width(key)[1]
        launch = lambda d: am._launch(a, w, key, design=d)
        counters = (am.closed_form_matmul.narrow_launches,
                    am.closed_form_matmul.launches)
        cols = am.closed_form_columns(w, key)
    else:
        n_bits = lm.table_width(table.shape[0])
        launch = lambda d: lm._launch(a, w, table, n_bits, design=d)
        counters = (lm.lut_matmul.narrow_launches, lm.lut_matmul.launches)
        cols = lm.table_columns(w, table)
    out = {}
    for design, counter in zip(("narrow", "tile"), counters):
        before = counter.value
        out[design] = launch(design)
        assert counter.value == before + 1, design
    return out["narrow"], out["tile"], blocking.narrow_matmul_plain(a, cols, n_bits)


@pytest.mark.parametrize("shape", NARROW_SHAPES)
def test_narrow_kernels_vs_plain_and_tile(dev, shape):
    """M tails (M % 4 != 0), K = 1..16, N = 1 and 8, batches with a distinct
    b each (padded to M % 4 == 0 and cropped), operands anywhere in int32."""
    b, m, k, n = shape
    a = torch.from_numpy(RNG.integers(-2**31, 2**31, (b, m, k), dtype=np.int64)
                         .astype(np.int32)).to(dev)
    w = torch.from_numpy(RNG.integers(-40, 40, (b, k, n)).astype(np.int32)).to(dev)
    for key in ("proposed@8", "csp_axc1@6", "design_strollo2020@4"):
        nar, tile, plain = _both_designs(a, w, key=key)
        torch.testing.assert_close(nar, plain, rtol=0, atol=0)
        torch.testing.assert_close(nar, tile, rtol=0, atol=0)
    for key in ("exact", "proposed", "csp_axc5@3"):
        nar, tile, plain = _both_designs(a, w, table=device_table(key, dev))
        torch.testing.assert_close(nar, plain, rtol=0, atol=0)
        torch.testing.assert_close(nar, tile, rtol=0, atol=0)


def test_narrow_kernels_take_an_unaligned_view(dev):
    """A view with a storage offset of 4 bytes: the wrapper copies it to an
    aligned buffer before the 16-byte copies of the narrow design."""
    m, k = 4099, 9
    base = torch.from_numpy(RNG.integers(-128, 128, 1 + m * k).astype(np.int32)).to(dev)
    a = base[1:].view(1, m, k)
    assert a.data_ptr() % 16
    w = torch.from_numpy(RNG.integers(-128, 128, (1, k, 1)).astype(np.int32)).to(dev)
    nar, tile, plain = _both_designs(a, w, key="proposed@8")
    torch.testing.assert_close(nar, plain, rtol=0, atol=0)
    torch.testing.assert_close(nar, tile, rtol=0, atol=0)
    nar, tile, _ = _both_designs(a, w, table=device_table("exact", dev))
    torch.testing.assert_close(nar, tile, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(mult.WIRINGS) + ["exact"])
def test_narrow_exhaustive_n4_per_coefficient(dev, name):
    """Every operand pair at width 4 through the narrow design, as a
    (16 x 1) @ (1 x 1) contraction per coefficient."""
    key = f"{name}@4"
    want = lut_lib.build_lut(key)
    v = torch.arange(-8, 8, dtype=torch.int32, device=dev)
    t = device_table(key, dev)
    before = (closed_form_matmul.narrow_launches.value,
              lut_matmul.narrow_launches.value)
    for j, c in enumerate(range(-8, 8)):
        w = torch.full((1, 1), c, dtype=torch.int32, device=dev)
        np.testing.assert_array_equal(lut_matmul(v[:, None], w, t)[:, 0].cpu().numpy(),
                                      want[:, j])
        if name != "exact":
            np.testing.assert_array_equal(
                closed_form_matmul(v[:, None], w, key)[:, 0].cpu().numpy(), want[:, j])
    assert lut_matmul.narrow_launches.value == before[1] + 16
    assert closed_form_matmul.narrow_launches.value == before[0] + (
        0 if name == "exact" else 16)


def test_narrow_served_shapes_scaled_down(dev):
    """The planned path's tap groups and the im2col conv at 2 x 33 x 47
    through the substrates, against the CPU."""
    imgs = mixed_shape_batch(2, shapes=((33, 47),), seed=4)
    x = torch.from_numpy(np.stack(imgs))
    lap = conv.LAPLACIAN.reshape(-1)
    for spec, taps in (("approx_cuda:exact", (4,)),
                       ("approx_cuda:csp_axc1@6", (0, 1, 2, 3, 5, 6, 7, 8)),
                       ("approx_cuda", tuple(range(9)))):
        s = sub.get_substrate(spec)
        px = conv.to_signed_pixels(x, s.meta.width)
        patches = conv._im2col(px, 3, 3, taps)
        coeffs = torch.from_numpy(lap[list(taps)].reshape(len(taps), 1))
        spec_c = sub.ContractionSpec(conv._CONV_DIMS)
        before = (closed_form_matmul.narrow_launches.value,
                  lut_matmul.narrow_launches.value)
        got = s.dot_general(patches.to(dev), coeffs.to(dev), spec_c)
        assert (closed_form_matmul.narrow_launches.value
                + lut_matmul.narrow_launches.value) == sum(before) + 1
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      s.dot_general(patches, coeffs, spec_c).numpy())


def test_planned_service_launches_only_the_narrow_design(dev):
    imgs = mixed_shape_batch(4, shapes=((16, 16), (33, 47)), seed=5)
    counters = (closed_form_matmul.launches, closed_form_matmul.narrow_launches,
                lut_matmul.launches, lut_matmul.narrow_launches)
    svc = EdgeDetectService(PLAN, max_batch_size=2, bucket_granularity=8,
                            n_workers=2)
    try:
        svc.detect(imgs[:1])
        torch.cuda.synchronize()
        before = [c.value for c in counters]
        svc.detect(imgs)
        torch.cuda.synchronize()
    finally:
        svc.close()
    tile_cf, narrow_cf, tile_lut, narrow_lut = (
        c.value - b for c, b in zip(counters, before))
    assert tile_cf == tile_lut == 0
    assert narrow_cf > 0 and narrow_lut > 0


# -- the stencil design of the fused conv --------------------------------------

STENCIL_SHAPES = [(1, 1, 1), (1, 13, 17), (2, 33, 64), (3, 70, 129),
                  (1, 97, 256), (2, 65, 1924)]


def _conv_taps(kern) -> tuple:
    return tuple(tuple(int(c) for c in row) for row in np.asarray(kern))


def _stencil_and_plain(x, kern, key, kind):
    """(stencil launch, its plain twin, the generic plain version) of one
    conv; the launch is checked on its counters and synchronised."""
    key = mult.canonical_key(key)
    taps = _conv_taps(kern)
    counters = (fused_conv2d.stencil_launches,
                fused_conv2d.lut_launches if kind == "lut" else fused_conv2d.launches)
    before = [c.value for c in counters]
    got = fused_conv2d(x, kern, key, kernel_kind=kind)
    torch.cuda.synchronize()
    assert [c.value for c in counters] == [b + 1 for b in before], (key, kind)
    slots, cols = fused_conv_columns(taps, key, kind, x.device)
    twin = stencil_conv_plain(x, slots, cols, mult.split_width(key)[1],
                              len(taps), len(taps[0]))
    return got, twin, fused_conv2d_plain(x, taps, key, kind)


@pytest.mark.parametrize("shape", STENCIL_SHAPES)
@pytest.mark.parametrize("kh_kw", [(1, 1), (2, 3), (3, 3), (5, 5)])
def test_stencil_vs_plain_both_kinds(dev, shape, kh_kw):
    """B = 1, H no multiple of a strip, W % 4 != 0 (scalar path) and W % 8
    == 4 (a half-empty last chunk), pixels anywhere in int32; both kinds,
    each against the stencil twin and the generic plain version."""
    x = torch.from_numpy(RNG.integers(-2**31, 2**31, shape, dtype=np.int64)
                         .astype(np.int32)).to(dev)
    kern = RNG.integers(-300, 300, kh_kw).astype(np.int32)
    for key in ("proposed", "csp_axc1@6", "design_strollo2020@4", "exact"):
        for kind in (("lut",) if key == "exact" else ("closed_form", "lut")):
            got, twin, plain = _stencil_and_plain(x, kern, key, kind)
            torch.testing.assert_close(got, twin, rtol=0, atol=0)
            torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_stencil_takes_an_unaligned_view(dev):
    """A view with a storage offset of 4 bytes is copied to an aligned
    buffer before the 16-byte loads; the result equals the aligned one."""
    b, h, w = 2, 41, 64
    base = torch.from_numpy(RNG.integers(-128, 128, 1 + b * h * w)
                            .astype(np.int32)).to(dev)
    x = base[1:].view(b, h, w)
    assert x.data_ptr() % 16
    for key, kind in (("proposed", "closed_form"), ("exact", "lut")):
        got, twin, plain = _stencil_and_plain(x, conv.LAPLACIAN, key, kind)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
        torch.testing.assert_close(got, twin, rtol=0, atol=0)
        torch.testing.assert_close(
            got, fused_conv2d(x.contiguous().clone(), conv.LAPLACIAN, key,
                              kernel_kind=kind), rtol=0, atol=0)


def test_stencil_zero_border_on_the_card(dev):
    """f(0, c) != 0: a zero batch answers the sum over the taps of f(0, c)
    everywhere, in both kinds."""
    x = torch.zeros((2, 9, 20), dtype=torch.int32, device=dev)
    for kind in ("closed_form", "lut"):
        got, twin, plain = _stencil_and_plain(x, conv.LAPLACIAN, "proposed", kind)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
        assert (got != 0).all()


def test_stencil_columns_on_the_card_equal_the_cpu(dev):
    """The closed-form kind's columns, evaluated on the card by the column
    kernel, equal the closed form evaluated on the CPU and the table's
    columns, for every wiring at widths 4 and 8."""
    taps = _conv_taps(RNG.integers(-128, 128, (3, 3)))
    for name in sorted(mult.WIRINGS):
        for n in (4, 8):
            key = mult.canonical_key(f"{name}@{n}")
            s_card, c_card = fused_conv_columns(taps, key, "closed_form", dev)
            torch.cuda.synchronize()
            s_cpu, c_cpu = fused_conv_columns(taps, key, "closed_form", "cpu")
            np.testing.assert_array_equal(s_card, s_cpu)
            assert torch.equal(c_card.cpu(), c_cpu), key
            assert torch.equal(c_card, fused_conv_columns(taps, key, "lut", dev)[1])


def test_generic_design_at_width_12_and_beyond_the_limit(dev):
    """Width 12 and kernels beyond 5 x 5 take the tiled design in both
    kinds (the generic design, which took them before, launches 0 times);
    the private design= runs every design at one shape, and all agree."""
    x = torch.from_numpy(RNG.integers(-2048, 2048, (2, 37, 70)).astype(np.int32)).to(dev)
    big = RNG.integers(-100, 100, (7, 7)).astype(np.int32)
    cases = (("proposed@12", conv.LAPLACIAN, "closed_form"),
             ("proposed", big, "closed_form"), ("exact", big, "lut"))
    for key, kern, kind in cases:
        key = mult.canonical_key(key)
        counters = (fused_conv2d.stencil_launches, fused_conv2d.tiled_launches,
                    fused_conv2d.generic_launches,
                    fused_conv2d.lut_launches if kind == "lut" else fused_conv2d.launches)
        before = [c.value for c in counters]
        got = fused_conv2d(x, kern, key, kernel_kind=kind)
        torch.cuda.synchronize()
        assert [c.value - b for c, b in zip(counters, before)] == [0, 1, 0, 1], key
        torch.testing.assert_close(
            got, fused_conv2d_plain(x, _conv_taps(kern), key, kind), rtol=0, atol=0)
        generic = fc._launch(x, _conv_taps(kern), key, kind, design="generic")
        torch.cuda.synchronize()
        torch.testing.assert_close(got, generic, rtol=0, atol=0)
    for key, kind in (("proposed", "closed_form"), ("exact", "lut")):
        taps = _conv_taps(conv.LAPLACIAN)
        stencil = fc._launch(x, taps, key, kind, design="stencil")
        tiled = fc._launch(x, taps, key, kind, design="tiled")
        generic = fc._launch(x, taps, key, kind, design="generic")
        torch.cuda.synchronize()
        torch.testing.assert_close(stencil, generic, rtol=0, atol=0)
        torch.testing.assert_close(tiled, generic, rtol=0, atol=0)
    with pytest.raises(ValueError, match="stencil design does not take"):
        fc._launch(x, _conv_taps(conv.LAPLACIAN), "proposed@12", "closed_form",
                   design="stencil")


# -- the tiled design of the fused conv ----------------------------------------

TILED_SHAPES = [(1, 1, 1), (1, 13, 17), (2, 33, 64), (3, 70, 129), (2, 65, 1924)]


def _tiled_and_twin(x, kern, key, kind, source=None):
    """(tiled launch, its plain twin on the same product data, the plain
    version) of one conv; the launch is checked on its counters (forced
    sources through the private launch) and synchronised."""
    key = mult.canonical_key(key)
    taps = _conv_taps(kern)
    counters = (fused_conv2d.tiled_launches, fused_conv2d.stencil_launches,
                fused_conv2d.generic_launches)
    before = [c.value for c in counters]
    got = (fused_conv2d(x, kern, key, kernel_kind=kind) if source is None
           else fc._launch(x, taps, key, kind, design="tiled", source=source))
    torch.cuda.synchronize()
    assert [c.value - b for c, b in zip(counters, before)] == [1, 0, 0], (key, kind)
    slots, prod, src = fc.tiled_products(taps, key, kind, x.device, source)
    twin = fc.tiled_conv_plain(x, slots, prod, mult.split_width(key)[1],
                               len(taps), len(taps[0]), src)
    return got, twin, fused_conv2d_plain(x, taps, key, kind)


@pytest.mark.parametrize("shape", TILED_SHAPES)
@pytest.mark.parametrize("width", [9, 12, 14, 16])
def test_tiled_widths_every_source(dev, shape, width):
    """The closed form at widths 9..16 under the Laplacian and a random 5 x 5
    kernel, pixels anywhere in int32: the public call and every product
    source forced, each against the twin on its data and the plain
    version."""
    key = f"proposed@{width}"
    x = torch.from_numpy(RNG.integers(-2**31, 2**31, shape, dtype=np.int64)
                         .astype(np.int32)).to(dev)
    k5 = RNG.integers(-3 << width, 3 << width, (5, 5)).astype(np.int32)
    for kern in (conv.LAPLACIAN, k5):
        got, twin, plain = _tiled_and_twin(x, kern, key, "closed_form")
        torch.testing.assert_close(got, twin, rtol=0, atol=0)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
        distinct = len(fc._wrapped_taps(_conv_taps(kern), width)[0])
        for source in ("columns32", "columns32_global", "bytes", "bytes_global"):
            if source == "columns32" and distinct * (4 << width) > 160 << 10:
                continue  # beyond shared memory: the launch is refused
            got_s, twin_s, _ = _tiled_and_twin(x, kern, key, "closed_form", source)
            torch.testing.assert_close(got_s, twin_s, rtol=0, atol=0)
            torch.testing.assert_close(got_s, plain, rtol=0, atol=0)


@pytest.mark.parametrize("shape", TILED_SHAPES)
@pytest.mark.parametrize("k", [(6, 6), (7, 7), (9, 9), (16, 16), (1, 7), (11, 2)])
def test_tiled_large_kernels_both_kinds(dev, shape, k):
    """Kernels beyond 5 x 5 at width 8 with as many distinct taps as they
    have, both kinds, against the twin, the plain version and the forced
    generic design."""
    x = torch.from_numpy(RNG.integers(-2**31, 2**31, shape, dtype=np.int64)
                         .astype(np.int32)).to(dev)
    kern = RNG.permutation(np.arange(-128, 128))[:k[0] * k[1]].reshape(k).astype(np.int32)
    for key in ("proposed", "csp_axc1@6", "exact"):
        for kind in (("lut",) if key == "exact" else ("closed_form", "lut")):
            got, twin, plain = _tiled_and_twin(x, kern, key, kind)
            torch.testing.assert_close(got, twin, rtol=0, atol=0)
            torch.testing.assert_close(got, plain, rtol=0, atol=0)
            generic = fc._launch(x, _conv_taps(kern), mult.canonical_key(key), kind,
                                 design="generic")
            torch.cuda.synchronize()
            torch.testing.assert_close(got, generic, rtol=0, atol=0)


def test_tiled_takes_an_unaligned_view_and_the_zero_border(dev):
    """A view with a storage offset of 4 bytes takes 4-byte copies; a zero
    batch answers the sum over the taps of f(0, c) everywhere."""
    b, h, w = 2, 41, 64
    base = torch.from_numpy(RNG.integers(-2048, 2048, 1 + b * h * w)
                            .astype(np.int32)).to(dev)
    x = base[1:].view(b, h, w)
    assert x.data_ptr() % 16
    k7 = RNG.integers(-100, 100, (7, 7)).astype(np.int32)
    for key, kern, kind in (("proposed@12", conv.LAPLACIAN, "closed_form"),
                            ("proposed@16", k7, "closed_form"), ("exact", k7, "lut")):
        got, twin, plain = _tiled_and_twin(x, kern, key, kind)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
        torch.testing.assert_close(
            got, fused_conv2d(x.contiguous().clone(), kern, key, kernel_kind=kind),
            rtol=0, atol=0)
        z = torch.zeros((2, 9, 20), dtype=torch.int32, device=dev)
        got, twin, plain = _tiled_and_twin(z, kern, key, kind)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
        if key != "exact":  # the exact product has f(0, c) = 0
            assert (got != 0).all()


def test_tiled_product_data_on_the_card_equals_the_cpu(dev):
    """The int32 columns (the column kernel) and the byte tables split from
    them equal those built on the CPU, for every wiring at widths 9, 12 and
    16."""
    taps = _conv_taps(RNG.integers(-2**15, 2**15, (3, 3)))
    for name in sorted(mult.WIRINGS):
        for n in (9, 12, 16):
            key = mult.canonical_key(f"{name}@{n}")
            for build_ in (fc.fused_conv_columns32, fc.fused_conv_byte_tables):
                s_card, p_card = build_(taps, key, dev)
                torch.cuda.synchronize()
                s_cpu, p_cpu = build_(taps, key, "cpu")
                np.testing.assert_array_equal(s_card, s_cpu)
                assert torch.equal(p_card.cpu(), p_cpu), (key, build_.__name__)


@pytest.mark.parametrize("spec", ["approx_cuda", "approx_cuda:exact"])
def test_uniform_service_launches_only_the_stencil_design(dev, spec):
    """The uniform paths' fused conv launches (proposed@8's closed-form kind,
    exact's LUT kind) are all stencil launches, and match the CPU."""
    imgs = mixed_shape_batch(4, shapes=((16, 16), (33, 47)), seed=6)
    kind_counter = fused_conv2d.lut_launches if spec.endswith("exact") \
        else fused_conv2d.launches
    outs = {}
    for device in ("cpu", "cuda"):
        svc = EdgeDetectService(spec, device=device, max_batch_size=2,
                                bucket_granularity=8, n_workers=2)
        try:
            svc.detect(imgs[:1])
            if device == "cuda":
                torch.cuda.synchronize()
            before = (kind_counter.value, fused_conv2d.stencil_launches.value)
            outs[device] = svc.detect(imgs)
            if device == "cuda":
                torch.cuda.synchronize()
            launched = (kind_counter.value - before[0],
                        fused_conv2d.stencil_launches.value - before[1])
        finally:
            svc.close()
    assert launched[0] > 0 and launched[0] == launched[1]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the LM path: the tile designs at minitron-8b's dense shapes
# ---------------------------------------------------------------------------

#: (K, N) of minitron-8b's dense layers: attn.wq/wo, attn.wk/wv, ffn.wg/wi,
#: ffn.wo
LM_SHAPES = [(4096, 4096), (4096, 1024), (4096, 16384), (16384, 4096)]


@pytest.mark.parametrize("kn", LM_SHAPES, ids=[f"{k}x{n}" for k, n in LM_SHAPES])
def test_tile_designs_at_the_lm_shapes(dev, kn):
    """A decode step's (8 × K) @ (K × N) at int8 operand codes: both tile
    kernels (forced: the shape takes the decode and tensor designs) against
    their plain versions, every product and sum exact."""
    k, n = kn
    a = torch.from_numpy(RNG.integers(-127, 128, (1, 8, k)).astype(np.int8)).to(dev)
    w = torch.from_numpy(RNG.integers(-127, 128, (1, k, n)).astype(np.int8)).to(dev)
    before = (closed_form_matmul.launches.value, lut_matmul.launches.value)
    got = am._launch(a, w, "proposed@8", design="tile")
    torch.testing.assert_close(got, closed_form_matmul_plain(
        a.to(torch.int32), w.to(torch.int32), "proposed@8"), rtol=0, atol=0)
    t = device_table("exact", dev)
    got = lm._launch(a, w, t, 8, design="tile")
    want = lut_matmul_plain(a.to(torch.int32), w.to(torch.int32), t)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, torch.matmul(
        a.double(), w.double()).to(torch.int32), rtol=0, atol=0)
    assert (closed_form_matmul.launches.value, lut_matmul.launches.value) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("spec", ["int8", "approx_bitexact:proposed@8",
                                  "approx_cuda:proposed@8", "approx_cuda:exact",
                                  "approx_cuda:csp_axc1@6"])
def test_dense_on_the_card_equals_the_cpu(dev, spec):
    """The same float32 activations and weights: the same quantization codes
    on both devices, so the same integers and the same float32 outputs."""
    from repro_torch.models import common as cm
    from repro_torch.models import registry as reg

    cfg = reg.get_config("minitron-8b", dot_plan=spec, dtype=torch.float32)
    x = torch.from_numpy(RNG.normal(size=(2, 8, 64)).astype(np.float32))
    w = torch.from_numpy((RNG.normal(size=(64, 128)) / 8).astype(np.float32))
    want = cm.dense(cfg, x, w, site="wq")
    got = cm.dense(cfg, x.to(dev), w.to(dev), site="wq")
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_serving_engine_on_the_card(dev):
    """minitron-8b at a small width on the card, two workers on their own
    streams: every request served, only decode launches (7 per layer-step),
    and the first wave of worker 0 identical to a one-worker run."""
    from repro_torch.models import registry as reg
    from repro_torch.serving import Request, ServingEngine

    bundle = reg.get_bundle("minitron-8b", n_layers=2, d_model=256, d_ff=512,
                            vocab=512, n_heads=4, n_kv_heads=2)
    params = bundle.init_params(torch.Generator(dev).manual_seed(0), dev)
    prompts = [list(map(int, RNG.integers(1, 512, 4))) for _ in range(8)]

    def serve(order, workers):
        eng = ServingEngine(bundle, params, batch_size=4, max_len=32,
                            substrate="approx_cuda:proposed@8")
        reqs = [Request(prompt=prompts[i], max_tokens=4) for i in order]
        counters = (closed_form_matmul.decode_launches, closed_form_matmul.launches,
                    closed_form_matmul.narrow_launches)
        before = [c.value for c in counters]
        eng.generate(reqs, workers=workers)
        torch.cuda.synchronize()
        steps = eng.metrics.batches_flushed
        assert eng.metrics.requests_served == 8
        assert eng.metrics.requests_failed == 0
        assert [c.value - b for c, b in zip(counters, before)] == [
            7 * 2 * steps, 0, 0]
        return {i: r.output for i, r in zip(order, reqs)}

    two = serve(range(8), 2)
    one = serve([0, 2, 4, 6, 1, 3, 5, 7], 1)
    assert all(one[i] == two[i] for i in (0, 2, 4, 6))


# ---------------------------------------------------------------------------
# the decode and tensor designs: few rows against the whole product table,
# and the exact product on the INT8 tensor cores
# ---------------------------------------------------------------------------

def _codes(shape, lo=-128, hi=128):
    return torch.from_numpy(RNG.integers(lo, hi, shape).astype(np.int8))


def _launched(counter, fn):
    """fn(), checking that it launched ``counter``'s design exactly once."""
    before = counter.value
    out = fn()
    assert counter.value == before + 1
    return out


@pytest.mark.parametrize("m", range(1, 17))
def test_decode_and_tensor_designs_vs_plain_and_tile(dev, m):
    """M = 1..16 at ragged K and N (not multiples of the kernels' 128-column
    groups or 32-row steps), batched with a distinct b per batch: the decode
    design of both kernels and the tensor design against their plain twins
    and the tile design, every integer equal."""
    bsz, k, n = 1 + m % 2, 250 + 7 * m, 130 + 13 * m
    a, w = _codes((bsz, m, k)).to(dev), _codes((bsz, k, n)).to(dev)
    for key in ("proposed@8", "csp_axc1@6", "design_strollo2020@4"):
        n_bits = mult.split_width(key)[1]
        dec = _launched(closed_form_matmul.decode_launches,
                        lambda: closed_form_matmul(a, w, key))
        plain = blocking.decode_matmul_plain(
            a, w, am.closed_form_table16(key, dev), n_bits)
        tile = am._launch(a, w, key, design="tile")
        torch.testing.assert_close(dec, plain, rtol=0, atol=0)
        torch.testing.assert_close(dec, tile, rtol=0, atol=0)
    for key in ("proposed", "csp_axc5@5", "exact@6"):
        t = device_table(key, dev)
        n_bits = lm.table_width(t.shape[0])
        dec = _launched(lut_matmul.decode_launches, lambda: lut_matmul(a, w, t))
        torch.testing.assert_close(
            dec, blocking.decode_matmul_plain(a, w, lm.table16(t), n_bits),
            rtol=0, atol=0)
        torch.testing.assert_close(
            dec, lm._launch(a, w, t, n_bits, design="tile"), rtol=0, atol=0)
    t = device_table("exact", dev)
    ten = _launched(lut_matmul.tensor_launches, lambda: lut_matmul(a, w, t))
    torch.testing.assert_close(ten, blocking.tensor_matmul_plain(a.cpu(), w.cpu()).to(dev),
                               rtol=0, atol=0)
    torch.testing.assert_close(ten, lm._launch(a, w, t, 8, design="tile"),
                               rtol=0, atol=0)
    torch.testing.assert_close(ten, lm._launch(a, w, t, 8, design="decode"),
                               rtol=0, atol=0)


def test_decode_and_tensor_take_int32_operands_that_wrap(dev):
    """int32 operands anywhere in int32 are narrowed to their low 8 bits,
    the same wrap as the table index: the same integers as the tile design
    and as the plain versions on the CPU."""
    a = torch.from_numpy(RNG.integers(-2**31, 2**31, (1, 8, 300), dtype=np.int64)
                         .astype(np.int32))
    w = torch.from_numpy(RNG.integers(-2**31, 2**31, (1, 300, 200), dtype=np.int64)
                         .astype(np.int32))
    for key in ("proposed@8", "csp_axc1@6"):
        got = _launched(closed_form_matmul.decode_launches,
                        lambda: closed_form_matmul(a.to(dev), w.to(dev), key))
        torch.testing.assert_close(got.cpu(), closed_form_matmul(a, w, key),
                                   rtol=0, atol=0)
    for key, counter in (("exact", lut_matmul.tensor_launches),
                         ("proposed", lut_matmul.decode_launches)):
        got = _launched(counter, lambda: lut_matmul(a.to(dev), w.to(dev),
                                                    device_table(key, dev)))
        torch.testing.assert_close(
            got.cpu(), lut_matmul(a, w, device_table(key, "cpu")), rtol=0, atol=0)


def test_decode_and_tensor_take_an_unaligned_view(dev):
    """Views with a storage offset of 1 byte (no 16- or 4-byte loads) and N,
    K that are no multiples of 16 or 4: the kernels read byte by byte and
    give the same integers."""
    m, k, n = 8, 1029, 301
    abase = _codes(1 + m * k).to(dev)
    wbase = _codes(1 + k * n).to(dev)
    a, w = abase[1:].view(1, m, k), wbase[1:].view(1, k, n)
    assert a.data_ptr() % 4 and w.data_ptr() % 4
    want = blocking.tensor_matmul_plain(a.cpu(), w.cpu()).to(dev)
    t = device_table("exact", dev)
    for design in ("tensor", "decode", "tile"):
        torch.testing.assert_close(lm._launch(a, w, t, 8, design=design), want,
                                   rtol=0, atol=0)
    dec = am._launch(a, w, "proposed@8", design="decode")
    torch.testing.assert_close(dec, am._launch(a, w, "proposed@8", design="tile"),
                               rtol=0, atol=0)
    n16 = _codes(1 + k * 320).to(dev)[1:].view(1, k, 320)  # N % 16 == 0, unaligned
    torch.testing.assert_close(lm._launch(a, n16, t, 8, design="tensor"),
                               blocking.tensor_matmul_plain(a.cpu(), n16.cpu()).to(dev),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(mult.WIRINGS) + ["exact"])
def test_decode_exhaustive_n4_per_coefficient(dev, name):
    """Every operand pair at width 4 through the decode design, one
    (16 x 17) @ (17 x 16) contraction per coefficient c (K = 17 is not
    narrow): row x of A is x at column 0 and 0 elsewhere, and B is c at row
    0 and 0 elsewhere, so out[x, j] = f(x, c) + 16 f(0, 0) for every j."""
    key = f"{name}@4"
    lut = lut_lib.build_lut(key).astype(np.int64)
    t = device_table(key, dev)
    v = torch.arange(-8, 8, dtype=torch.int32, device=dev)
    a = torch.zeros((16, 17), dtype=torch.int32, device=dev)
    a[:, 0] = v
    for j, c in enumerate(range(-8, 8)):
        w = torch.zeros((17, 16), dtype=torch.int32, device=dev)
        w[0] = c
        want = np.repeat((lut[:, j] + 16 * lut[8, 8])[:, None], 16, axis=1)
        got = _launched(lut_matmul.decode_launches, lambda: lut_matmul(a, w, t))
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        if name != "exact":
            got = _launched(closed_form_matmul.decode_launches,
                            lambda: closed_form_matmul(a, w, key))
            np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("kn", LM_SHAPES, ids=[f"{k}x{n}" for k, n in LM_SHAPES])
def test_decode_and_tensor_at_the_lm_shapes_scaled_down(dev, kn):
    """minitron-8b's dense shapes with K and N cut by 8, M = 8: the decode
    design against the tile design and its plain twin, the tensor design
    against the tile design and torch._int_mm (M zero-padded to 17)."""
    k, n = kn[0] // 8, kn[1] // 8
    a, w = _codes((1, 8, k), -127).to(dev), _codes((1, k, n), -127).to(dev)
    dec = _launched(closed_form_matmul.decode_launches,
                    lambda: closed_form_matmul(a, w, "proposed@8"))
    torch.testing.assert_close(dec, am._launch(a, w, "proposed@8", design="tile"),
                               rtol=0, atol=0)
    torch.testing.assert_close(dec, blocking.decode_matmul_plain(
        a, w, am.closed_form_table16("proposed@8", dev), 8), rtol=0, atol=0)
    t = device_table("exact", dev)
    ten = _launched(lut_matmul.tensor_launches, lambda: lut_matmul(a, w, t))
    torch.testing.assert_close(ten, lm._launch(a, w, t, 8, design="tile"),
                               rtol=0, atol=0)
    a17 = torch.nn.functional.pad(a[0], (0, 0, 0, 9))
    torch.testing.assert_close(ten[0], torch._int_mm(a17, w[0])[:8], rtol=0, atol=0)


def test_closed_form_table_on_the_card_equals_the_cpu(dev):
    for key in ("proposed@8", "csp_axc1@6", "design_strollo2020@4"):
        torch.testing.assert_close(am.closed_form_table16(key, dev).cpu(),
                                   am.closed_form_table16(key, "cpu"), rtol=0, atol=0)


def test_forced_design_on_a_shape_it_cannot_take_raises(dev):
    """No fallback: the wrappers refuse a forced design the shape or table
    does not fit before any launch, and the C entry points refuse such a
    launch themselves (cudaErrorInvalidValue, 1)."""
    from repro_torch.kernels import build

    a17, w = _codes((1, 17, 64)).to(dev), _codes((1, 64, 64)).to(dev)
    with pytest.raises(ValueError, match="decode design does not take"):
        am._launch(a17, w, "proposed@8", design="decode")
    with pytest.raises(ValueError, match="tensor design does not take"):
        lm._launch(a17, w, device_table("exact", dev), 8, design="tensor")
    a8 = _codes((1, 8, 64)).to(dev)
    with pytest.raises(ValueError, match="tensor design does not take"):
        lm._launch(a8, w, device_table("proposed", dev), 8, design="tensor")
    with pytest.raises(ValueError, match="decode design does not take"):
        am._launch(a8, w, "proposed@12", design="decode")
    out = torch.empty((1, 17, 64), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    fn = build.load_function("lut_matmul", "lut_matmul_tensor_launch",
                             lm._TENSOR_ARGTYPES)
    assert fn(a17.data_ptr(), w.data_ptr(), out.data_ptr(), 1, 17, 64, 64, stream) == 1
    assert fn(a8.data_ptr(), w.data_ptr(), out.data_ptr(), 1, 8, 131072, 64,
              stream) == 1
    table = am.closed_form_table16("proposed@8", dev)
    fn = build.load_function("approx_matmul", "approx_matmul_decode_launch",
                             am._DECODE_ARGTYPES)
    assert fn(a17.data_ptr(), w.data_ptr(), table.data_ptr(), out.data_ptr(),
              1, 17, 64, 64, 8, stream) == 1
    assert fn(a8.data_ptr(), w.data_ptr(), table.data_ptr() + 2, out.data_ptr(),
              1, 8, 64, 64, 8, stream) != 0  # a misaligned table
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the rows design: many rows as an exact int8 GEMM plus bit-monomial int8
# GEMMs on the INT8 tensor cores
# ---------------------------------------------------------------------------

#: (B, M, K, N): ragged K (no multiple of 32 or 16), odd N, a K tail inside
#: a 32-row chunk (48), 16-byte rows (the cp.async path), several M tiles
ROWS_SHAPES = [(1, 17, 33, 9), (2, 33, 45, 17), (1, 40, 48, 32),
               (2, 130, 100, 70), (1, 256, 512, 384), (3, 300, 64, 129)]


def _rows_check(a, w, key=None, table=None):
    """The public call (it must take the rows design) against the plain
    twin, the tile design and the tile design's plain version."""
    if table is None:
        n_bits = mult.split_width(key)[1]
        got = _launched(closed_form_matmul.rows_launches,
                        lambda: closed_form_matmul(a, w, key))
        plain = blocking.rows_matmul_plain(a, w, am.rows_decomposition(key), n_bits)
        tile = am._launch(a, w, key, design="tile")
    else:
        n_bits = lm.table_width(table.shape[0])
        got = _launched(lut_matmul.rows_launches, lambda: lut_matmul(a, w, table))
        plain = blocking.rows_matmul_plain(a, w, lm.rows_decomposition(table),
                                           n_bits)
        tile = lm._launch(a, w, table, n_bits, design="tile")
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    torch.testing.assert_close(got, tile, rtol=0, atol=0)
    return got


@pytest.mark.parametrize("shape", ROWS_SHAPES)
def test_rows_design_vs_plain_and_tile(dev, shape):
    """Ragged M, K and N, batched with a distinct weight per batch, int8
    codes: the rows design of both kernels against its plain twin and the
    tile design, every integer equal."""
    bsz, m, k, n = shape
    a, w = _codes((bsz, m, k)).to(dev), _codes((bsz, k, n)).to(dev)
    for key in ("proposed@8", "csp_axc1@6", "design_strollo2020@4"):
        _rows_check(a, w, key=key)
    for key in ("proposed", "exact", "csp_axc5@5", "exact@6"):
        _rows_check(a, w, table=device_table(key, dev))


@pytest.mark.parametrize("width", range(3, 9))
@pytest.mark.parametrize("name", sorted(mult.WIRINGS))
def test_rows_every_wiring_and_width(dev, name, width):
    """Every wiring at widths 3..8 at one shape of 16-byte rows, operands
    anywhere in int32 (each wraps to its low n bits, the codes' too)."""
    key = f"{name}@{width}"
    a = torch.from_numpy(RNG.integers(-2**31, 2**31, (1, 70, 96), dtype=np.int64)
                         .astype(np.int32)).to(dev)
    w = torch.from_numpy(RNG.integers(-2**31, 2**31, (1, 96, 80), dtype=np.int64)
                         .astype(np.int32)).to(dev)
    got = _rows_check(a, w, key=key)
    torch.testing.assert_close(got.cpu(), closed_form_matmul(a.cpu(), w.cpu(), key),
                               rtol=0, atol=0)
    _rows_check(a, w, table=device_table(key, dev))


def test_rows_flushes_and_wraps(dev):
    """K = 2^18 rows: beyond one block's k range at every plane count (the
    mma sums flushed into wrapping int32 adds), and the int32 sums wrap
    (every code -128 or -127 in the first 3/4: products near 2^14)."""
    k, hot = 1 << 18, 3 << 16
    a = _codes((1, 17, k))
    w = _codes((1, k, 16))
    a[:, :, :hot] = -128
    w[:, :hot] = torch.from_numpy(RNG.integers(-128, -126, (hot, 16)).astype(np.int8))
    a, w = a.to(dev), w.to(dev)
    for key in ("proposed@8", "design_akbari2017@8"):
        _rows_check(a, w, key=key)
    exact = lut_matmul(a, w, device_table("exact", dev))
    want = torch.matmul(a.double(), w.double()).to(torch.int64)
    assert (want.abs() > 2**31).any()  # the sums wrap
    torch.testing.assert_close(exact, want.to(torch.int32), rtol=0, atol=0)


@pytest.mark.parametrize("mkn", [(17, 512, 256), (256, 1024, 512), (256, 4096, 1024)])
def test_rows_exact_equals_int_mm(dev, mkn):
    m, k, n = mkn
    a, w = _codes((m, k)).to(dev), _codes((k, n)).to(dev)
    t = device_table("exact", dev)
    got = _launched(lut_matmul.rows_launches, lambda: lut_matmul(a, w, t))
    torch.testing.assert_close(got, torch._int_mm(a, w), rtol=0, atol=0)


def test_rows_two_int8_planes(dev):
    """design_akbari2017@8's factors reach -768..512: each such factor is
    two int8 planes (a scale-256 one among them)."""
    d = am.rows_decomposition("design_akbari2017@8")
    assert 256 in d.scales and d.planes <= 32
    a, w = _codes((2, 64, 160)).to(dev), _codes((2, 160, 96)).to(dev)
    _rows_check(a, w, key="design_akbari2017@8")
    _rows_check(a, w, table=device_table("design_akbari2017@8", dev))


def test_rows_k_padding_adds_no_f00(dev):
    """Zero operands: every real k row gives f(0,0) once (K = 45, in a
    chunk of 32 rows and a split of K), no zero-filled row gives any."""
    a = torch.zeros((1, 20, 45), dtype=torch.int8, device=dev)
    w = torch.zeros((1, 45, 30), dtype=torch.int8, device=dev)
    got = _launched(closed_form_matmul.rows_launches,
                    lambda: closed_form_matmul(a, w, "proposed@8"))
    assert (got == 45 * 192).all()


def test_rows_takes_an_unaligned_view(dev):
    """Views with a storage offset of 1 byte (no 16-byte copies): byte
    loads, the same integers."""
    m, k, n = 40, 1029, 301
    a = _codes(1 + m * k).to(dev)[1:].view(1, m, k)
    w = _codes(1 + k * n).to(dev)[1:].view(1, k, n)
    assert a.data_ptr() % 16 and w.data_ptr() % 16
    _rows_check(a, w, key="proposed@8")
    _rows_check(a, w, table=device_table("exact", dev))


def test_rows_forced_where_it_cannot_take_raises(dev):
    """No fallback: the rows design refuses few rows, widths beyond 8 and a
    table beyond its planes, and its C entry point refuses a bad contract."""
    from repro_torch.kernels import build

    a8, w = _codes((1, 8, 64)).to(dev), _codes((1, 64, 64)).to(dev)
    a17 = _codes((1, 17, 64)).to(dev)
    with pytest.raises(ValueError, match="rows design does not take"):
        am._launch(a8, w, "proposed@8", design="rows")
    with pytest.raises(ValueError, match="rows design does not take"):
        am._launch(a17, w, "proposed@12", design="rows")
    noise = torch.from_numpy(RNG.integers(-2**20, 2**20, 1 << 16)
                             .astype(np.int32)).to(dev)
    assert lm.rows_decomposition(noise) is None
    with pytest.raises(ValueError, match="rows design does not take"):
        lm._launch(a17, w, noise, 8, design="rows")
    before = lut_matmul.gather_launches.value
    torch.testing.assert_close(lut_matmul(a17, w, noise),
                               lut_matmul_plain(a17.cpu(), w.cpu(), noise.cpu()).to(dev),
                               rtol=0, atol=0)
    assert lut_matmul.gather_launches.value == before + 1  # the gather design
    planes = am._rows_planes("proposed@8", dev)
    out = torch.empty((1, 17, 64), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    fn = build.load_function("approx_matmul", "approx_matmul_rows_launch",
                             am._ROWS_ARGTYPES)
    assert fn(a17.data_ptr(), w.data_ptr(), planes.data_ptr(), out.data_ptr(),
              1, 17, 64, 64, 12, 19, 192, stream) == 1  # width 12
    assert fn(a17.data_ptr(), w.data_ptr(), planes.data_ptr(), out.data_ptr(),
              1, 17, 64, 64, 8, 33, 192, stream) == 1  # 33 planes
    assert fn(a17.data_ptr(), w.data_ptr(), planes.data_ptr() + 2, out.data_ptr(),
              1, 17, 64, 64, 8, 19, 192, stream) != 0  # misaligned planes
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# training: the straight-through contraction, a TrainLoop step, checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moment", [False, True])
@pytest.mark.parametrize("spec", ["approx_cuda:proposed@8", "approx_cuda:exact",
                                  "approx_cuda:csp_axc1@6"])
def test_ste_on_the_card_equals_the_cpu(dev, spec, moment):
    """The forward bit for bit (the same codes, the kernels against their
    plain versions); the float32 backward within 1e-5 (its matmuls sum in
    another order on the card)."""
    from repro_torch.train import QATPolicy, qat

    x = RNG.normal(size=(2, 24, 64)).astype(np.float32)
    w = (RNG.normal(size=(64, 96)) / 8).astype(np.float32)
    g = RNG.normal(size=(2, 24, 96)).astype(np.float32)
    cspec = sub.ContractionSpec.matmul(quant=sub.QuantPolicy())

    def run(device):
        xt = torch.from_numpy(x).to(device).requires_grad_(True)
        wt = torch.from_numpy(w).to(device).requires_grad_(True)
        out = qat.qat_dot_general(xt, wt, spec, cspec,
                                  QATPolicy(moment_correction=moment))
        dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(g).to(device))
        return [t.cpu() for t in (out, dx, dw)]

    before = closed_form_matmul.rows_launches.value + lut_matmul.rows_launches.value
    got, want = run(dev), run("cpu")
    assert (closed_form_matmul.rows_launches.value
            + lut_matmul.rows_launches.value) == before + 1
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_training_step_on_the_card_kernels_equal_the_table(dev, tmp_path):
    """Two QAT TrainLoop steps at a small width: on approx_cuda (the rows
    design at M = 64, forward and recompute) the losses and every updated
    parameter equal, bit for bit, those of approx_lut (plain gathers, the
    same integers) on the card."""
    from repro_torch.data import SyntheticLMStream
    from repro_torch.models import convert
    from repro_torch.models import registry as reg
    from repro_torch.optim import adamw
    from repro_torch.train import QATPolicy, TrainLoop, TrainLoopConfig

    bundle = reg.get_bundle("minitron-8b", n_layers=2, d_model=256, d_ff=512,
                            vocab=512, n_heads=4, n_kv_heads=2)

    def train(spec):
        loop = TrainLoop(bundle.loss_fn, adamw(), TrainLoopConfig(
            total_steps=2, ckpt_every=100, ckpt_dir=str(tmp_path), lr=1e-3,
            qat=QATPolicy(), plan=spec), layout=bundle.layout)
        params, opt, start = loop.init_or_restore(
            lambda: bundle.init_params(torch.Generator(dev).manual_seed(0), dev))
        before = closed_form_matmul.rows_launches.value
        loop.run(params, opt, SyntheticLMStream(vocab=512, batch=4, seq_len=16,
                                                seed=0), start)
        torch.cuda.synchronize()
        return (loop.metrics["losses"],
                closed_form_matmul.rows_launches.value - before,
                {k: t.cpu() for k, t in convert.named_leaves(params).items()})

    losses_k, launched, pk = train("approx_cuda:proposed@8")
    losses_t, none, pt = train("approx_lut:proposed@8")
    assert (launched, none) == (2 * 2 * 7 * 2, 0)
    assert losses_k == losses_t
    for k in pk:
        assert torch.equal(pk[k], pt[k]), k


def test_checkpoint_round_trip_through_the_card(dev, tmp_path):
    from repro_torch.checkpoint import CheckpointManager, load_checkpoint

    tree = {"a": torch.randn((3, 4), device=dev),
            "nest": {"b": torch.randn((5,), device=dev).to(torch.bfloat16)},
            "lst": [torch.arange(3, device=dev, dtype=torch.int32)]}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save_async(4, tree)
    want = {"a": tree["a"].clone(), "b": tree["nest"]["b"].clone()}
    tree["a"].add_(1.0)  # in place, as a training step: the saved copy holds
    tree["nest"]["b"].add_(1.0)
    mgr.wait()
    out, step, _ = load_checkpoint(str(tmp_path), tree)
    assert step == 4 and out["a"].device.type == "cuda"
    assert out["nest"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["a"], want["a"])
    assert torch.equal(out["nest"]["b"].view(torch.int16), want["b"].view(torch.int16))
    assert torch.equal(out["lst"][0], tree["lst"][0])
    cpu, _, _ = load_checkpoint(str(tmp_path), tree, device="cpu")
    assert cpu["a"].device.type == "cpu"


# ---------------------------------------------------------------------------
# the meter and the autotuner on the card, against the CPU
# ---------------------------------------------------------------------------


def test_meter_on_the_card_equals_the_cpu(dev):
    """Counts, MACs, energy and the probe's moments of the served planned
    path and of a quantized contraction: the same on the card (the kernels)
    as on the CPU (their plain versions)."""
    from repro_torch.data import image_batch
    from repro_torch.obs.meter import ContractionMeter, telemetry_scope

    imgs = torch.from_numpy(image_batch(4, 64, 64, seed=2))
    x = torch.from_numpy(RNG.normal(size=(40, 64)).astype(np.float32))
    w = torch.from_numpy(RNG.normal(size=(64, 24)).astype(np.float32))
    qc = sub.ContractionSpec.matmul(quant=sub.QuantPolicy(), site="dense")

    def run(device):
        m = ContractionMeter(error_probe=True, seed=4)
        with telemetry_scope(m):
            maps = conv.edge_detect_planned(imgs.to(device), PLAN)
            fused = conv.edge_detect_batched(imgs.to(device), "approx_cuda:csp_axc1@6")
            out = sub.get_substrate("approx_cuda").dot_general(
                x.to(device), w.to(device), qc)
        return [t.cpu() for t in (maps, fused, out)], m

    got, mc = run(dev)
    want, mh = run("cpu")
    for u, v in zip(got, want):
        assert torch.equal(u, v)
    assert mc.registry.to_json() == mh.registry.to_json()
    assert mc.probe_moments() == mh.probe_moments()


def test_autotune_edge_on_the_card_equals_the_cpu(dev):
    from repro_torch.launch import autotune as at

    kw = dict(n_images=2, size=(64, 64), wirings=("proposed",), widths=(6, 7, 8))
    got, want = at.autotune_edge(device=dev, **kw), at.autotune_edge(device="cpu", **kw)
    assert got["site_macs"] == want["site_macs"]
    assert got["plan"].to_dict() == want["plan"].to_dict()
    assert [(h["pattern"], h["spec"], h["pdp_fj"]) for h in got["history"]] == \
        [(h["pattern"], h["spec"], h["pdp_fj"]) for h in want["history"]]
    for g, h in zip(got["history"], want["history"]):
        assert g["score"] == pytest.approx(h["score"], abs=1e-3)
    assert got["tuned"]["psnr_db"] == pytest.approx(want["tuned"]["psnr_db"],
                                                    abs=1e-3)


_DRIVERS = ["table2_compressors", "table3_compressor4", "table4_errors",
            "table5_hardware", "fig9_edge", "fig10_tradeoff"]


@pytest.mark.parametrize("name", _DRIVERS)
def test_paper_driver_on_the_card_equals_the_cpu(dev, name, monkeypatch):
    """``benchmarks/torch_<name>.py`` prints the same values on the card as
    on the CPU (whose values equal the JAX driver's); only the timings and
    the fused conv row's device label differ. Fig. 9's alias rows and its
    fused conv row launch the kernels."""
    import contextlib
    import importlib.util
    import io
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(root))
    spec = importlib.util.spec_from_file_location(
        f"_card_drv_{name}", root / "benchmarks" / f"torch_{name}.py")
    drv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drv)
    before = fused_conv2d.launches.value
    with contextlib.redirect_stdout(io.StringIO()):
        got = drv.run(device="cuda")
        launched = fused_conv2d.launches.value - before
        want = drv.run(device="cpu")
    values = lambda rows: {n: v for n, _, v in rows if n != "fig9/cuda_fused_conv"}
    assert values(got) == values(want)
    if name == "fig9_edge":
        assert ("fig9/cuda_fused_conv", "device=cuda") in {(n, v) for n, _, v in got}
        assert launched > 0


# ---------------------------------------------------------------------------
# the MoE, vlm and encdec families: their dense shapes and the MoE block
# ---------------------------------------------------------------------------

#: the (K, N) pairs the new families add: llama4-maverick, kimi-k2,
#: paligemma-3b, whisper-large-v3 (attention, shared expert or FFN)
FAMILY_SHAPES = [(5120, 5120), (5120, 1024), (5120, 8192), (8192, 5120),
                 (7168, 7168), (7168, 896), (7168, 2048), (2048, 7168),
                 (2048, 2048), (2048, 256), (2048, 16384), (16384, 2048),
                 (1280, 1280), (1280, 5120), (5120, 1280)]


@pytest.mark.parametrize("kn", FAMILY_SHAPES, ids=[f"{k}x{n}" for k, n in FAMILY_SHAPES])
def test_decode_and_rows_designs_at_the_family_shapes(dev, kn):
    """One call at each new (K, N): M = 8 on the decode design and M = 48
    on the rows design of ``approx_matmul`` (proposed@8), and of
    ``lut_matmul`` under ``exact`` (its tensor design at M = 8), each equal
    to its plain twin."""
    k, n = kn
    w = _codes((1, k, n)).to(dev)
    t16 = am.closed_form_table16("proposed@8", dev)
    a = _codes((1, 8, k)).to(dev)
    got = _launched(closed_form_matmul.decode_launches,
                    lambda: closed_form_matmul(a, w, "proposed@8"))
    torch.testing.assert_close(got, blocking.decode_matmul_plain(a, w, t16, 8),
                               rtol=0, atol=0)
    t = device_table("exact", dev)
    got = _launched(lut_matmul.tensor_launches, lambda: lut_matmul(a, w, t))
    torch.testing.assert_close(got, blocking.tensor_matmul_plain(a, w),
                               rtol=0, atol=0)
    a = _codes((1, 48, k)).to(dev)
    got = _launched(closed_form_matmul.rows_launches,
                    lambda: closed_form_matmul(a, w, "proposed@8"))
    torch.testing.assert_close(got, blocking.rows_matmul_plain(
        a, w, am.rows_decomposition("proposed@8"), 8), rtol=0, atol=0)
    got = _launched(lut_matmul.rows_launches, lambda: lut_matmul(a, w, t))
    torch.testing.assert_close(got, blocking.rows_matmul_plain(
        a, w, lm.rows_decomposition(t), 8), rtol=0, atol=0)


@pytest.mark.parametrize("spec", ["exact", "approx_cuda:proposed@8"])
def test_moe_block_on_the_card_equals_the_cpu(dev, spec):
    """The MoE block at float32 (llama4-maverick's layer at d 64, f 128, 8
    experts, top-2 with a forced overflow, a shared expert on ``spec``): the
    same routing on both devices, and outputs within 1e-4 (the float32
    router, expert and norm sums run in another order on the card; TF32
    off)."""
    from repro_torch.models import common as cm
    from repro_torch.models import registry as reg
    from repro_torch.nn import plan as tplan

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reg.get_config("llama4-maverick-400b-a17b", d_model=64, d_ff=128,
                         n_heads=4, n_kv_heads=2, n_experts=8, top_k=2,
                         capacity_factor=0.5, dtype=torch.float32, dot_plan=spec)
    p = cm.init_moe(torch.Generator().manual_seed(5), cfg)
    x = torch.from_numpy(RNG.normal(size=(2, 24, 64)).astype(np.float32))
    xn = cm.rms_norm(x, p.ln).reshape(-1, 64)
    _, (slot, _, keep, _) = cm._dispatch_local(cfg, xn, p.router)
    _, (slot_d, _, keep_d, _) = cm._dispatch_local(cfg, xn.to(dev), p.router.to(dev))
    assert torch.equal(slot_d.cpu(), slot) and torch.equal(keep_d.cpu(), keep)
    assert (~keep).any()
    with tplan.site_scope("layer.1"):
        want = cm.moe_block(cfg, p, x)
        got = cm.moe_block(cfg, p.to(dev), x.to(dev))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


# the recurrent families: their dense shapes and a decode step
# ---------------------------------------------------------------------------

#: the (K, N) pairs the recurrent families add: xlstm-125m's projections and
#: its mLSTM gates (N = 4), zamba2-1.2b's in_proj (N = 8352, no multiple of
#: the rows design's 128-wide tile), out_proj and its shared block's FFN
RECURRENT_SHAPES = [(768, 768), (768, 4), (2048, 8352), (4096, 2048),
                    (2048, 8192), (8192, 2048)]


@pytest.mark.parametrize("m", [8, 48, 512])
@pytest.mark.parametrize("kn", RECURRENT_SHAPES,
                         ids=[f"{k}x{n}" for k, n in RECURRENT_SHAPES])
def test_decode_and_rows_designs_at_the_recurrent_shapes(dev, kn, m):
    """``approx_matmul`` (proposed@8) at each new (K, N): M = 8 on the decode
    design (N = 4: its 32-bit weight loads), M = 48 and 512 on the rows
    design (N = 4: its byte-load path; N = 8352: a ragged last tile), each
    equal to its plain twin."""
    k, n = kn
    w = _codes((1, k, n)).to(dev)
    a = _codes((1, m, k)).to(dev)
    if m <= blocking.DECODE_MAX_M:
        got = _launched(closed_form_matmul.decode_launches,
                        lambda: closed_form_matmul(a, w, "proposed@8"))
        want = blocking.decode_matmul_plain(
            a, w, am.closed_form_table16("proposed@8", dev), 8)
    else:
        got = _launched(closed_form_matmul.rows_launches,
                        lambda: closed_form_matmul(a, w, "proposed@8"))
        want = blocking.rows_matmul_plain(a, w, am.rows_decomposition("proposed@8"), 8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-1.2b"])
def test_recurrent_step_and_prefill_on_the_card_equal_the_table(dev, arch):
    """A reduced model (d_model 64; zamba: 6 layers, the shared block after
    the sixth) on the card: a decode step (logits and every state tensor)
    and a 2 × 16 prefill under ``approx_cuda:proposed@8`` bit for bit the
    same on ``approx_lut:proposed@8``."""
    import dataclasses

    from repro_torch.checkpoint.ckpt import tree_leaves
    from repro_torch.models import registry as reg

    small = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512)
    cfg = reg.get_config(arch, n_layers=6 if arch.startswith("zamba") else 2,
                         ssm_state=8 if arch.startswith("zamba") else 0, **small)
    params = reg.build_bundle(cfg).init_params(torch.Generator(dev).manual_seed(0), dev)
    tok = torch.from_numpy(RNG.integers(0, 512, (4, 16))).to(dev)

    def run(spec):
        b = reg.build_bundle(dataclasses.replace(cfg, dot_plan=spec))
        st = b.init_decode_state(4, 8, dev)
        logits, st = b.decode_step(params, st, {"token": tok[:, :1], "cache_len": 0})
        return [logits, b.prefill(params, {"tokens": tok})] + [
            t for _, t in tree_leaves(st)]

    for got, want in zip(run("approx_cuda:proposed@8"), run("approx_lut:proposed@8")):
        assert got.dtype == want.dtype and torch.equal(got, want)


# ---------------------------------------------------------------------------
# MoE and recurrent training on the card, against the table substrate
# ---------------------------------------------------------------------------


def _train_on_the_card(dev, tmp_path, bundle, spec, steps=2):
    """``steps`` QAT TrainLoop steps under ``spec`` with the launcher's
    optimizer (Adafactor on repro's stacked tree for MoE configs, else
    AdamW) → (losses, rows launches of both kernels, params on the CPU)."""
    from repro_torch.data import SyntheticLMStream
    from repro_torch.models import convert
    from repro_torch.optim import adafactor, adamw
    from repro_torch.train import QATPolicy, TrainLoop, TrainLoopConfig

    optimizer = adafactor(bundle.layout) if bundle.cfg.n_experts else adamw()
    loop = TrainLoop(bundle.loss_fn, optimizer, TrainLoopConfig(
        total_steps=steps, ckpt_every=100, ckpt_dir=str(tmp_path), lr=1e-3,
        qat=QATPolicy(), plan=spec), layout=bundle.layout)
    params, opt, start = loop.init_or_restore(
        lambda: bundle.init_params(torch.Generator(dev).manual_seed(0), dev))
    before = (closed_form_matmul.rows_launches.value, lut_matmul.rows_launches.value)
    loop.run(params, opt, SyntheticLMStream(vocab=bundle.cfg.vocab, batch=4,
                                            seq_len=16, seed=0), start)
    torch.cuda.synchronize()
    launched = (closed_form_matmul.rows_launches.value - before[0],
                lut_matmul.rows_launches.value - before[1])
    return (loop.metrics["losses"], launched,
            {k: t.cpu() for k, t in convert.named_leaves(params).items()})


@pytest.mark.parametrize("arch,over", [
    ("llama4-maverick-400b-a17b", dict(n_layers=4, n_experts=4)),
    ("kimi-k2-1t-a32b", dict(n_layers=2, n_experts=16, top_k=8))],
    ids=["maverick-top1", "kimi-k2-top8"])
def test_moe_training_on_the_card_kernels_equal_the_table(dev, tmp_path, arch, over):
    """Two QAT steps of an MoE config with Adafactor on repro's stacked tree
    (d_model 256; the rows design at M = 64, forward and recompute): the
    losses and every updated parameter bit for bit those of approx_lut on
    the card. kimi-k2 at top-8 gathers each token 8 times in the dispatch,
    whose backward sums them."""
    from repro_torch.models import registry as reg

    bundle = reg.get_bundle(arch, d_model=256, d_ff=512, vocab=512, n_heads=4,
                            n_kv_heads=2, **over)
    losses_k, launched, pk = _train_on_the_card(dev, tmp_path / "k", bundle,
                                                "approx_cuda:proposed@8")
    losses_t, none, pt = _train_on_the_card(dev, tmp_path / "t", bundle,
                                            "approx_lut:proposed@8")
    assert launched == (2 * 2 * 7 * bundle.cfg.n_layers, 0) and none == (0, 0)
    assert losses_k == losses_t and all(np.isfinite(losses_k))
    for k in pk:
        assert torch.equal(pk[k], pt[k]), k


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-1.2b"])
def test_recurrent_training_on_the_card_kernels_equal_the_table(dev, tmp_path, arch):
    """Two QAT steps with AdamW through the scans, each layer (and zamba's
    shared block) recomputed in the backward: the losses and every updated
    parameter bit for bit those of approx_lut on the card."""
    from repro_torch.models import registry as reg
    from repro_torch.models import zamba

    zam = arch.startswith("zamba")
    bundle = reg.get_bundle(arch, n_layers=6 if zam else 2, d_model=64, n_heads=4,
                            n_kv_heads=4, d_ff=128, vocab=512,
                            **(dict(ssm_state=8, shared_attn_every=3) if zam else {}))
    losses_k, launched, pk = _train_on_the_card(dev, tmp_path / "k", bundle,
                                                "approx_cuda:proposed@8")
    losses_t, none, pt = _train_on_the_card(dev, tmp_path / "t", bundle,
                                            "approx_lut:proposed@8")
    per_pass = (2 * 6 + 7 * len(zamba._shared_positions(bundle.cfg)) if zam
                else 7 + 5)
    assert launched == (2 * 2 * per_pass, 0) and none == (0, 0)
    assert losses_k == losses_t and all(np.isfinite(losses_k))
    for k in pk:
        assert torch.equal(pk[k], pt[k]), k


# ---------------------------------------------------------------------------
# the wide and gather designs: what the tile designs took before them
# ---------------------------------------------------------------------------

#: (B, M, K, N): a single product, ragged M, K and N, a decode step's few
#: rows, several 128-row tiles, a K tail inside a 32-row chunk
FALLBACK_SHAPES = [(1, 1, 1, 1), (2, 33, 70, 17), (1, 8, 300, 200),
                   (1, 130, 64, 129), (3, 17, 33, 9), (1, 256, 512, 384)]
WIDE_KEYS = ("proposed@9", "proposed@12", "proposed@16", "design_akbari2017@16",
             "design_strollo2020@13", "trunc_exact_csp@11")


def _fallback_tables(dev) -> dict:
    """Tables only the gather design takes: beyond int16 (width 8: two
    windows; widths 7 and 4: whole), and an int16 one beyond the rows
    planes."""
    rng = np.random.default_rng(28)
    tables = {"noise": rng.integers(-2**20, 2**20, 1 << 16),
              "int16": rng.integers(-2**15, 2**15, 1 << 16),
              "int32@7": rng.integers(-2**31, 2**31, 1 << 14, dtype=np.int64),
              "int32@4": rng.integers(-2**31, 2**31, 1 << 8, dtype=np.int64)}
    return {k: torch.from_numpy(v.astype(np.int32)).to(dev) for k, v in tables.items()}


@pytest.mark.parametrize("shape", FALLBACK_SHAPES)
def test_wide_design_vs_plain_and_tile(dev, shape):
    """Operands anywhere in int32 (they wrap to the width): the public call
    takes the wide design, equal to its plain twin, the plain closed form
    and the tile design, every integer."""
    bsz, m, k, n = shape
    a = torch.from_numpy(RNG.integers(-2**31, 2**31, (bsz, m, k), dtype=np.int64)
                         .astype(np.int32)).to(dev)
    w = torch.from_numpy(RNG.integers(-2**31, 2**31, (bsz, k, n), dtype=np.int64)
                         .astype(np.int32)).to(dev)
    for key in WIDE_KEYS:
        n_bits = mult.split_width(key)[1]
        got = _launched(closed_form_matmul.wide_launches,
                        lambda: closed_form_matmul(a, w, key))
        torch.testing.assert_close(got, blocking.wide_matmul_plain(
            a, w, am.wide_decomposition(key), n_bits), rtol=0, atol=0)
        torch.testing.assert_close(got, closed_form_matmul_plain(a, w, key),
                                   rtol=0, atol=0)
        torch.testing.assert_close(got, am._launch(a, w, key, design="tile"),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("shape", FALLBACK_SHAPES)
def test_gather_design_vs_plain_and_tile(dev, shape):
    """int8 codes against every fallback table: the gather design (public
    where it is the design the call takes, forced where the decode design
    takes the int16 table) equal to its plain version and the tile
    design."""
    bsz, m, k, n = shape
    a, w = _codes((bsz, m, k)).to(dev), _codes((bsz, k, n)).to(dev)
    for name, t in _fallback_tables(dev).items():
        n_bits = lm.table_width(t.numel())
        served = blocking.resolve_design(None, blocking.eligible_designs(
            m, k, n, n_bits, lm.table_checks(t)), "lut_matmul", "")
        assert served == "gather" or (name == "int16" and served in ("decode", "narrow"))
        run = (lambda: lut_matmul(a, w, t)) if served == "gather" else (
            lambda: lm._launch(a, w, t, n_bits, design="gather"))
        got = _launched(lut_matmul.gather_launches, run)
        torch.testing.assert_close(got, lut_matmul_plain(a.int(), w.int(), t),
                                   rtol=0, atol=0)
        torch.testing.assert_close(got, lm._launch(a, w, t, n_bits, design="tile"),
                                   rtol=0, atol=0)


def test_narrow_n_under_a_wide_table_keeps_the_tile_design(dev):
    """Narrow N at many rows under a table beyond int16 (the edge shapes):
    the dispatch keeps the tile design, where the gather design is slower;
    both equal the plain version."""
    t = _fallback_tables(dev)["noise"]
    a, w = _codes((1, 4097, 9)).to(dev), _codes((1, 9, 1)).to(dev)
    assert not blocking.gather_design(4097, 9, 1, 8)
    got = _launched(lut_matmul.launches, lambda: lut_matmul(a, w, t))
    torch.testing.assert_close(got, lut_matmul_plain(a.int(), w.int(), t),
                               rtol=0, atol=0)
    torch.testing.assert_close(got, lm._launch(a, w, t, 8, design="gather"),
                               rtol=0, atol=0)


def test_wide_and_gather_entry_points_refuse_a_bad_contract(dev):
    """No fallback: the wide design refuses widths up to 8, and both C entry
    points refuse a contract they cannot keep."""
    from repro_torch.kernels import build

    a, w = _codes((1, 17, 64)).to(dev).int(), _codes((1, 64, 64)).to(dev).int()
    with pytest.raises(ValueError, match="wide design does not take"):
        am._launch(a, w, "proposed@8", design="wide")
    out = torch.empty((1, 17, 64), dtype=torch.int32, device=dev)
    need = blocking.wide_scratch_bytes(1, 17, 64, 64)
    scratch = torch.empty(need + 16, dtype=torch.uint8, device=dev)
    params = am._wide_params("proposed@12")
    stream = torch.cuda.current_stream().cuda_stream
    wide = build.load_function("approx_matmul", "approx_matmul_wide_launch",
                               am._WIDE_ARGTYPES)
    args = (a.data_ptr(), w.data_ptr(), out.data_ptr())
    assert wide(*args, scratch.data_ptr(), need - 1, 1, 17, 64, 64, 12,
                params.ctypes.data, 0, stream) == 1  # scratch too small
    assert wide(*args, scratch.data_ptr() + 8, need, 1, 17, 64, 64, 12,
                params.ctypes.data, 0, stream) != 0  # misaligned scratch
    assert wide(*args, scratch.data_ptr(), need, 1, 17, 64, 64, 8,
                params.ctypes.data, 0, stream) == 1  # width 8
    bad = params.copy()
    bad[0] = 65  # planes beyond the kernel's 64
    assert wide(*args, scratch.data_ptr(), need, 1, 17, 64, 64, 12,
                bad.ctypes.data, 0, stream) == 1
    gather = build.load_function("lut_matmul", "lut_matmul_gather_launch",
                                 lm._GATHER_ARGTYPES)
    t = device_table("proposed", dev)
    a8, w8 = _codes((1, 17, 64)).to(dev), _codes((1, 64, 64)).to(dev)
    assert gather(a8.data_ptr(), w8.data_ptr(), t.data_ptr(), 3, out.data_ptr(),
                  1, 17, 64, 64, 8, stream) == 1  # 3-byte entries
    assert gather(a8.data_ptr(), w8.data_ptr(), t.data_ptr() + 4, 4, out.data_ptr(),
                  1, 17, 64, 64, 8, stream) != 0  # misaligned table
    torch.cuda.synchronize()
