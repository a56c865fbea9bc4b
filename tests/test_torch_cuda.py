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
from repro_torch.kernels.approx_matmul.ops import (closed_form_matmul,
                                                   closed_form_matmul_plain)
from repro_torch.kernels.fused_conv.ops import fused_conv2d, fused_conv2d_plain
from repro_torch.nn import conv
from repro_torch.serving import EdgeDetectService

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
