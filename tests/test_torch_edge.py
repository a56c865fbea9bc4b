"""The ported main path against ``repro``: procedural images, the batched
Laplacian edge detection on every ported spec at widths 4 and 8 (the
``exact`` wiring under the kernel backend included, which runs the fused
conv's LUT kind), PSNR, and the port's ``EdgeDetectService(device="cpu")``
against the JAX service at 1/2/4 workers (byte-identical maps, the same
metric family names, poison isolation), on a spec and on a per-site plan."""
import numpy as np
import pytest
import torch

from repro.data import images as jimages
from repro.nn import conv as jconv
from repro.serving import EdgeDetectService as JService
from repro_torch.data import images as timages
from repro_torch.nn import conv
from repro_torch.serving import EdgeDetectService

#: port spec → reference spec, at widths 8 and 4 (exact has no width)
SPECS = {
    "exact": "exact",
    "approx_bitexact": "approx_bitexact",
    "approx_lut": "approx_lut",
    "approx_cuda": "approx_pallas",
    "approx_bitexact:design_du2022@4": "approx_bitexact:design_du2022@4",
    "approx_lut:csp_axc1@4": "approx_lut:csp_axc1@4",
    "approx_cuda:proposed@4": "approx_pallas:proposed@4",
    "approx_pallas:design_strollo2020@4": "approx_pallas:design_strollo2020@4",
    "approx_cuda:exact": "approx_pallas:exact",
    "approx_cuda:exact@5": "approx_pallas:exact@5",
    "int8": "int8",
}
SMALL_SHAPES = ((8, 8), (12, 10), (16, 16), (9, 21))


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("kern", [jconv.LAPLACIAN.astype(np.float32),
                                  np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
                                  np.linspace(-1, 1, 25, dtype=np.float32).reshape(5, 5)])
def test_conv2d_float_matches_repro(kern):
    """The float 'same' oracle, odd, even and 5×5 kernels: the same taps in
    the same order, bit for bit."""
    x = np.random.default_rng(5).normal(size=(11, 14)).astype(np.float32)
    want = np.asarray(jconv.conv2d_float(x, kern))
    got = conv.conv2d_float(_t(x), _t(kern))
    assert got.dtype == torch.float32 and got.shape == (11, 14)
    np.testing.assert_array_equal(got.numpy(), want)


def test_procedural_images_identical():
    np.testing.assert_array_equal(timages.image_batch(3, 20, 24, seed=4),
                                  jimages.image_batch(3, 20, 24, seed=4))
    np.testing.assert_array_equal(timages.image_batch(2, 16, 16, noise=3.0),
                                  jimages.image_batch(2, 16, 16, noise=3.0))
    for a, b in zip(timages.mixed_shape_batch(7, seed=1, noise=2.0),
                    jimages.mixed_shape_batch(7, seed=1, noise=2.0)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(timages.photo_like(30, 40, seed=9),
                                  jimages.photo_like(30, 40, seed=9))
    np.testing.assert_array_equal(timages.test_image(24, 32),
                                  jimages.test_image(24, 32))


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_edge_detect_batched_image_batch(spec):
    imgs = timages.image_batch(3, 20, 24, seed=1)
    want = np.asarray(jconv.edge_detect_batched(imgs, SPECS[spec]))
    got = conv.edge_detect_batched(_t(imgs), spec).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want, err_msg=spec)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_edge_detect_batched_mixed_shapes(spec):
    for img in timages.mixed_shape_batch(4, shapes=SMALL_SHAPES, seed=3):
        want = np.asarray(jconv.edge_detect_batched(img[None], SPECS[spec]))[0]
        got = conv.edge_detect_batched(_t(img)[None], spec)[0].numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{spec} {img.shape}")


@pytest.mark.parametrize("mult_name", ["proposed", "csp_axc3@4"])
def test_single_image_edge_detect_and_psnr(mult_name):
    img = timages.photo_like(18, 22, seed=5)
    want = np.asarray(jconv.edge_detect(img, mult_name))
    got = conv.edge_detect(_t(img), mult_name).numpy()
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jconv.edge_detect(img, "exact"))
    assert conv.psnr(ref, got) == pytest.approx(jconv.psnr(ref, want), abs=1e-4)
    assert conv.psnr(got, got) == float("inf") == jconv.psnr(want, want)


def _serve(service_cls, spec, imgs, n_workers, **kw):
    svc = service_cls(spec, max_batch_size=2, max_wait_s=1e-3,
                      bucket_granularity=8, n_workers=n_workers, **kw)
    try:
        return svc, svc.detect(imgs)
    finally:
        svc.close()


@pytest.mark.parametrize("n_workers", [1, 2, 4])
def test_service_matches_jax_service(n_workers):
    imgs = timages.mixed_shape_batch(6, shapes=SMALL_SHAPES, seed=2)
    jsvc, want = _serve(JService, "approx_pallas", imgs, n_workers)
    tsvc, got = _serve(EdgeDetectService, "approx_cuda", imgs, n_workers,
                       device="cpu")
    for w, g in zip(want, got):
        assert g.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, np.asarray(w))
    assert tsvc.compiled_shapes == jsvc.compiled_shapes
    assert [f.name for f in tsvc.metrics.registry.families()] == \
        [f.name for f in jsvc.metrics.registry.families()]
    tstats, jstats = tsvc.stats(), jsvc.stats()
    for key in ("requests_served", "requests_failed", "compiled_calls"):
        assert tstats[key] == jstats[key], key


def test_service_poison_isolation_like_reference():
    """A payload that fails inside the dispatch fails only its own ticket,
    in both services."""
    imgs = timages.mixed_shape_batch(3, shapes=((8, 8),), seed=6)
    poison = np.full((8, 8), None, dtype=object)
    for cls, spec, kw in ((JService, "exact", {}),
                          (EdgeDetectService, "exact", {"device": "cpu"})):
        svc = cls(spec, max_batch_size=4, max_wait_s=60.0, start=False, **kw)
        tickets = svc.batcher.submit_many([imgs[0], poison, imgs[1], imgs[2]])
        svc.batcher.flush()
        svc.close()
        with pytest.raises(TypeError):
            tickets[1].result(timeout=0)
        for t in (tickets[0], tickets[2], tickets[3]):
            assert t.result(timeout=0).shape == (8, 8)
        assert svc.metrics.worker_errors == 1
        assert svc.metrics.requests_served == 3


def test_service_latency_emulation_and_bad_inputs():
    imgs = timages.image_batch(3, 16, 16)
    svc, outs = _serve(EdgeDetectService, "approx_cuda", list(imgs), 2,
                       device="cpu", device_latency_s=0.01)
    np.testing.assert_array_equal(
        np.stack(outs), conv.edge_detect_batched(_t(imgs), "approx_cuda").numpy())
    svc = EdgeDetectService("exact", device="cpu", start=False)
    with pytest.raises(ValueError, match="uint8"):
        svc.submit(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="single"):
        svc.submit(np.zeros((2, 4, 4), np.uint8))
    with pytest.raises(ValueError, match="bucket_granularity"):
        EdgeDetectService("exact", device="cpu", bucket_granularity=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EdgeDetectService("exact", device="cpu", partitioning=object())
    # a plan dict serves like the JAX service's, under emulated latency too
    plan = {"default": "approx_cuda:proposed@8", "rules": [
        {"site": "conv.edge.center", "spec": "approx_cuda:exact"},
        {"site": "conv.edge.ring", "spec": "approx_cuda:csp_axc1@6"}]}
    jplan = {"default": "approx_pallas:proposed@8", "rules": [
        {"site": "conv.edge.center", "spec": "approx_pallas:exact"},
        {"site": "conv.edge.ring", "spec": "approx_pallas:csp_axc1@6"}]}
    jsvc, want = _serve(JService, jplan, list(imgs), 2)
    tsvc, got = _serve(EdgeDetectService, plan, list(imgs), 2, device="cpu",
                       device_latency_s=0.01)
    assert tsvc.spec == "plan(approx_cuda:proposed@8+2 rules)"
    assert jsvc.spec == "plan(approx_pallas:proposed@8+2 rules)"
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))
