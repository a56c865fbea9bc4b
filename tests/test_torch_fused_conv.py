"""Parity of the port's fused conv (``repro_torch.kernels.fused_conv``, CPU
tensors → its plain version) with ``repro``'s Pallas kernel (interpret mode
off-TPU) and with its scalar oracle, mirroring ``tests/test_fused_conv.py``:
wirings at N=4, widths 3..8, ragged shapes, 1×1/2×3/5×5 kernels, NHWC, and
the zero border that must still be multiplied (f(0, c) ≠ 0), in both
product kinds (closed form and LUT, ``kernel_kind=``). Where the Pallas
kernel's interpret mode would dominate the run time, the reference side is
``repro``'s product table gathered in numpy (``_lut_conv``)."""
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.core import multiplier as jm
from repro.kernels.fused_conv.ops import fused_conv2d as j_fused
from repro.kernels.fused_conv.ref import laplacian_conv_ref as j_laplacian_ref
from repro.nn import conv as jconv
from repro.nn import substrate as jsub
from repro_torch.kernels.fused_conv import ops as fc_ops
from repro_torch.kernels.fused_conv.ops import fused_conv2d, fused_conv2d_plain
from repro_torch.kernels.fused_conv.ref import fused_conv_ref, laplacian_conv_ref
from repro_torch.nn import conv
from repro_torch.nn import substrate as sub

RNG = np.random.default_rng(66)


def _img(h, w, lo=-128, hi=128):
    return RNG.integers(lo, hi, (h, w)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _lut_conv(imgs, kern, key):
    """'same' conv gathered from ``repro``'s product table for ``key`` — the
    reference's scalar model at numpy speed (out-of-range operands wrap)."""
    table = jlut.build_lut(key)
    n = table.shape[0].bit_length() - 1
    off, mask = 1 << (n - 1), (1 << n) - 1
    kh, kw = kern.shape
    _, h, w = imgs.shape
    x = np.pad(imgs, ((0, 0), (kh // 2, kh // 2), (kw // 2, kw // 2)))
    out = np.zeros(imgs.shape, np.int64)
    for di in range(kh):
        for dj in range(kw):
            xi = (x[:, di:di + h, dj:dj + w] + off) & mask
            out += table[xi, (int(kern[di, dj]) + off) & mask]
    return out.astype(np.int32)


@pytest.mark.parametrize("name", sorted(jm.WIRINGS))
def test_fused_conv_wirings_n4(name):
    """Every wiring at N=4 (the Laplacian's center 8 wraps to −8)."""
    imgs = np.stack([_img(13, 17, lo=-8, hi=8) for _ in range(2)])
    want = _lut_conv(imgs, jconv.LAPLACIAN, f"{name}@4")
    got = fused_conv2d(_t(imgs), conv.LAPLACIAN, f"{name}@4").numpy()
    np.testing.assert_array_equal(got, want, err_msg=name)
    s = sub.get_substrate(f"approx_cuda:{name}@4")
    im2col = conv.conv2d_batched(_t(imgs), conv.LAPLACIAN, s, fused=False)
    np.testing.assert_array_equal(im2col.numpy(), want, err_msg=name)


@pytest.mark.parametrize("width", [3, 4, 5, 6, 7, 8])
def test_fused_conv_widths(width):
    imgs = _img(11, 19, lo=-(1 << (width - 1)), hi=1 << (width - 1))[None]
    want = _lut_conv(imgs, jconv.LAPLACIAN, f"proposed@{width}")
    s = sub.get_substrate(f"approx_cuda:proposed@{width}")
    got = conv.conv2d_batched(_t(imgs), conv.LAPLACIAN, s, fused=True).numpy()
    np.testing.assert_array_equal(got, want, err_msg=f"width={width}")


@pytest.mark.parametrize("shape", [(1, 1), (3, 3), (5, 9), (13, 17),
                                   (20, 7), (33, 65)])
def test_fused_conv_ragged_shapes(shape):
    imgs = _img(*shape)[None]
    want = _lut_conv(imgs, jconv.LAPLACIAN, "proposed")
    np.testing.assert_array_equal(
        fused_conv2d(_t(imgs), conv.LAPLACIAN, "proposed").numpy(), want)
    np.testing.assert_array_equal(
        fused_conv_ref(_t(imgs), conv.LAPLACIAN, "proposed").numpy(), want)


@pytest.mark.parametrize("shape", [(1, 1), (9, 13)])
def test_laplacian_conv_ref_matches_repro(shape):
    """The single-image Laplacian oracle through the paper's multiplier, the
    zero border multiplied: ``repro``'s integers, and the batched oracle's."""
    img = _img(*shape)
    want = np.asarray(j_laplacian_ref(img))
    got = laplacian_conv_ref(_t(img))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        fused_conv_ref(_t(img)[None], conv.LAPLACIAN, "proposed")[0].numpy(), want)


@pytest.mark.parametrize("kern", [np.ones((1, 1), np.int32),
                                  RNG.integers(-4, 5, (2, 3)).astype(np.int32),
                                  RNG.integers(-4, 5, (5, 5)).astype(np.int32)])
def test_fused_conv_kernel_shapes(kern):
    """Odd, even and 1×1 kernel dims all contract the same taps."""
    imgs = _img(10, 14)[None]
    want = _lut_conv(imgs, kern, "proposed")
    got = fused_conv2d(_t(imgs), _t(kern), "proposed").numpy()
    np.testing.assert_array_equal(got, want, err_msg=str(kern.shape))


def test_fused_conv_zero_border_is_multiplied():
    """An all-zero image still answers Σ f(0, c) at every pixel (the
    compensation constant fires on zero operands), border included."""
    imgs = np.zeros((1, 6, 7), np.int32)
    want = np.asarray(j_fused(imgs, jconv.LAPLACIAN, "proposed"))
    got = fused_conv2d(_t(imgs), conv.LAPLACIAN, "proposed").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _lut_conv(imgs, jconv.LAPLACIAN, "proposed"))
    assert (got != 0).all()


def test_fused_conv_nhwc():
    imgs = RNG.integers(-32, 32, (2, 9, 11, 3)).astype(np.int32)
    js = jsub.get_substrate("approx_pallas:proposed@4")
    want = np.asarray(jconv.conv2d_batched(imgs, jconv.LAPLACIAN, js, fused=True))
    s = sub.get_substrate("approx_cuda:proposed@4")
    got = conv.conv2d_batched(_t(imgs), conv.LAPLACIAN, s).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", ["numpy", "list", "tensor"])
def test_fused_path_keeps_taps_on_host(form, monkeypatch):
    """The fused kernel takes its taps by value: ``conv2d_batched`` must not
    build a device copy of the kernel (on the card that copy blocks the
    stream) — only the im2col path does."""
    kern = {"numpy": conv.LAPLACIAN, "list": conv.LAPLACIAN.tolist(),
            "tensor": _t(conv.LAPLACIAN)}[form]
    imgs = RNG.integers(0, 128, (2, 10, 13)).astype(np.int32)
    want = _lut_conv(imgs, conv.LAPLACIAN, "proposed")
    s = sub.get_substrate("approx_cuda")
    im2col = conv.conv2d_batched(_t(imgs), kern, s, fused=False).numpy()

    def no_copy(*_):
        raise AssertionError("fused path built a device kernel tensor")

    monkeypatch.setattr(conv, "_kernel_tensor", no_copy)
    np.testing.assert_array_equal(conv.conv2d_batched(_t(imgs), kern, s).numpy(),
                                  want)
    np.testing.assert_array_equal(im2col, want)


def test_plain_version_is_what_cpu_tensors_run():
    imgs = _t(_img(9, 12)[None])
    taps = tuple(tuple(int(c) for c in row) for row in conv.LAPLACIAN)
    np.testing.assert_array_equal(
        fused_conv2d(imgs, conv.LAPLACIAN, "csp_axc1@4").numpy(),
        fused_conv2d_plain(imgs, taps, "design_esposito2018@4").numpy())
    before = fused_conv2d.launches.value
    fused_conv2d(imgs, conv.LAPLACIAN)
    assert fused_conv2d.launches.value == before  # no kernel launch on CPU


def test_fused_conv_rejects_other_devices_and_shapes():
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_conv2d(torch.empty((1, 4, 4), dtype=torch.int32, device="meta"),
                     conv.LAPLACIAN)
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        fused_conv2d(torch.zeros((4, 4), dtype=torch.int32), conv.LAPLACIAN)
    with pytest.raises(ValueError, match="fused=True"):
        conv.conv2d_batched(torch.zeros((1, 4, 4), dtype=torch.int32),
                            conv.LAPLACIAN, "approx_bitexact", fused=True)


# -- the LUT kind -------------------------------------------------------------

#: a 4×4 kernel holding every signed 4-bit tap value once
TAPS_N4 = np.arange(-8, 8, dtype=np.int32).reshape(4, 4)


@pytest.mark.parametrize("name", sorted(jm.WIRINGS) + ["exact"])
def test_lut_kind_exhaustive_n4_matches_pallas(name):
    """Every pixel value × every tap value at N=4 (the image holds all 16
    values, the kernel all 16 taps), against the reference's LUT kind."""
    key = f"{name}@4"
    imgs = np.stack([RNG.permutation(np.tile(np.arange(-8, 8), 12)).reshape(12, 16)
                     .astype(np.int32) for _ in range(2)])
    want = np.asarray(j_fused(imgs, TAPS_N4, key, kernel_kind="lut"))
    got = fused_conv2d(_t(imgs), TAPS_N4, key, kernel_kind="lut").numpy()
    np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(got, _lut_conv(imgs, TAPS_N4, key))


@pytest.mark.parametrize("shape", [(1, 1), (5, 9), (20, 7), (33, 65)])
@pytest.mark.parametrize("key", ["exact", "csp_axc3@6"])
def test_lut_kind_ragged_shapes(shape, key):
    hi = 1 << (jm.split_width(key)[1] - 1)
    imgs = _img(*shape, lo=-hi, hi=hi)[None]
    want = np.asarray(j_fused(imgs, jconv.LAPLACIAN, key, kernel_kind="lut"))
    got = fused_conv2d(_t(imgs), conv.LAPLACIAN, key, kernel_kind="lut")
    np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{key} {shape}")


def test_lut_kind_proposed8_equals_closed_form_kind():
    imgs = np.stack([_img(17, 23) for _ in range(3)])
    lut = fused_conv2d(_t(imgs), conv.LAPLACIAN, "proposed", kernel_kind="lut")
    cf = fused_conv2d(_t(imgs), conv.LAPLACIAN, "proposed",
                      kernel_kind="closed_form")
    np.testing.assert_array_equal(lut.numpy(), cf.numpy())
    np.testing.assert_array_equal(
        lut.numpy(), np.asarray(j_fused(imgs, jconv.LAPLACIAN, "proposed",
                                        kernel_kind="lut")))


def test_lut_kind_zero_border_is_looked_up():
    """Out-of-image taps read 0 and are looked up: f(0, c) ≠ 0 for a CSP
    wiring, so a zero image answers Σ f(0, c); ``exact`` would hide this
    (f(0, c) = 0 there)."""
    imgs = np.zeros((1, 5, 6), np.int32)
    got = fused_conv2d(_t(imgs), conv.LAPLACIAN, "csp_axc1",
                       kernel_kind="lut").numpy()
    want = np.asarray(j_fused(imgs, jconv.LAPLACIAN, "csp_axc1",
                              kernel_kind="lut"))
    np.testing.assert_array_equal(got, want)
    assert (got != 0).all()
    assert (fused_conv2d(_t(imgs), conv.LAPLACIAN, "exact").numpy() == 0).all()


def test_lut_kind_operand_order_pixel_first():
    """The pixel is the first operand and the tap the second; the CSP
    multipliers are not symmetric, so swapping them changes the map."""
    imgs = _img(9, 10)[None]
    kern = RNG.integers(-128, 128, (3, 3)).astype(np.int32)
    got = fused_conv2d(_t(imgs), kern, "proposed", kernel_kind="lut").numpy()
    np.testing.assert_array_equal(got, _lut_conv(imgs, kern, "proposed"))
    table = jlut.build_lut("proposed")
    assert (table != table.T).any()


def test_kernel_kinds_resolve_like_reference():
    assert fc_ops.KERNEL_KINDS == ("auto", "closed_form", "lut")
    assert fc_ops.resolve_kind("exact@4", "auto") == "lut"
    assert fc_ops.resolve_kind("csp_axc1@4", "auto") == "closed_form"
    assert fc_ops.resolve_kind("proposed", "lut") == "lut"
    with pytest.raises(ValueError):
        fused_conv2d(torch.zeros((1, 4, 4), dtype=torch.int32), conv.LAPLACIAN,
                     "exact", kernel_kind="closed_form")
    with pytest.raises(ValueError, match="unknown fused-conv kernel kind"):
        fused_conv2d(torch.zeros((1, 4, 4), dtype=torch.int32), conv.LAPLACIAN,
                     kernel_kind="tiled")


def test_lut_columns_built_once_per_taps():
    """The LUT kind's per-tap columns: one int16 column per distinct wrapped
    tap value, the same tensor on every call (kept on the device, never
    uploaded per batch), each tap pointing at its own column."""
    taps = tuple(tuple(int(c) for c in row) for row in conv.LAPLACIAN)
    slots, cols = fc_ops.fused_conv_columns(taps, "proposed", "lut", "cpu")
    again = fc_ops.fused_conv_columns(taps, "proposed", "lut", "cpu")[1]
    assert again is cols and cols.dtype == torch.int16 and cols.shape == (2, 256)
    table = jlut.build_lut("proposed")
    for t, c in enumerate(c for row in taps for c in row):
        np.testing.assert_array_equal(cols[slots[t]].numpy(), table[:, c + 128])
    before = (fused_conv2d.launches.value, fused_conv2d.lut_launches.value)
    fused_conv2d(_t(_img(4, 5)[None]), conv.LAPLACIAN, "exact")
    assert (fused_conv2d.launches.value,
            fused_conv2d.lut_launches.value) == before  # no launch on CPU
