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
    v = torch.arange(-8, 8, dtype=torch.int32, device=dev)
    before = closed_form_matmul.launches.value
    got = closed_form_matmul(v[:, None], v[None, :], f"{name}@4").cpu().numpy()
    assert closed_form_matmul.launches.value == before + 1
    np.testing.assert_array_equal(got, lut_lib.build_lut(f"{name}@4"))


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
    key = f"{name}@4"
    v = torch.arange(-8, 8, dtype=torch.int32, device=dev)
    before = lut_matmul.launches.value
    got = lut_matmul(v[:, None], v[None, :], device_table(key, dev))
    assert lut_matmul.launches.value == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), lut_lib.build_lut(key))


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
    got = lut_matmul(torch.from_numpy(a).to(dev), torch.from_numpy(w).to(dev),
                     device_table("proposed", dev))
    np.testing.assert_array_equal(got.cpu().numpy(), want.astype(np.int32))
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
    """The generic design keeps the closed form at width 12 and kernels
    beyond 5 x 5, in both kinds; the private design= runs either design at
    one shape, and both agree."""
    x = torch.from_numpy(RNG.integers(-2048, 2048, (2, 37, 70)).astype(np.int32)).to(dev)
    big = RNG.integers(-100, 100, (7, 7)).astype(np.int32)
    cases = (("proposed@12", conv.LAPLACIAN, "closed_form"),
             ("proposed", big, "closed_form"), ("exact", big, "lut"))
    for key, kern, kind in cases:
        key = mult.canonical_key(key)
        counter = fused_conv2d.lut_launches if kind == "lut" else fused_conv2d.launches
        before = (fused_conv2d.stencil_launches.value, counter.value)
        got = fused_conv2d(x, kern, key, kernel_kind=kind)
        torch.cuda.synchronize()
        assert (fused_conv2d.stencil_launches.value, counter.value) == (
            before[0], before[1] + 1), key
        torch.testing.assert_close(
            got, fused_conv2d_plain(x, _conv_taps(kern), key, kind), rtol=0, atol=0)
    for key, kind in (("proposed", "closed_form"), ("exact", "lut")):
        taps = _conv_taps(conv.LAPLACIAN)
        stencil = fc._launch(x, taps, key, kind, design="stencil")
        generic = fc._launch(x, taps, key, kind, design="generic")
        torch.cuda.synchronize()
        torch.testing.assert_close(stencil, generic, rtol=0, atol=0)
    with pytest.raises(ValueError, match="stencil design does not take"):
        fc._launch(x, _conv_taps(conv.LAPLACIAN), "proposed@12", "closed_form",
                   design="stencil")


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
    kernels against their plain versions, every product and sum exact."""
    k, n = kn
    a = torch.from_numpy(RNG.integers(-127, 128, (1, 8, k)).astype(np.int8)).to(dev)
    w = torch.from_numpy(RNG.integers(-127, 128, (1, k, n)).astype(np.int8)).to(dev)
    before = (closed_form_matmul.launches.value, lut_matmul.launches.value)
    got = closed_form_matmul(a, w, "proposed")
    torch.testing.assert_close(got, closed_form_matmul_plain(
        a.to(torch.int32), w.to(torch.int32), "proposed"), rtol=0, atol=0)
    t = device_table("exact", dev)
    got = lut_matmul(a, w, t)
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
    streams: every request served, only tile launches (7 per layer-step),
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
        before = (closed_form_matmul.launches.value,
                  closed_form_matmul.narrow_launches.value)
        eng.generate(reqs, workers=workers)
        torch.cuda.synchronize()
        steps = eng.metrics.batches_flushed
        assert eng.metrics.requests_served == 8
        assert eng.metrics.requests_failed == 0
        assert closed_form_matmul.launches.value - before[0] == 7 * 2 * steps
        assert closed_form_matmul.narrow_launches.value == before[1]
        return {i: r.output for i, r in zip(order, reqs)}

    two = serve(range(8), 2)
    one = serve([0, 2, 4, 6, 1, 3, 5, 7], 1)
    assert all(one[i] == two[i] for i in (0, 2, 4, 6))
