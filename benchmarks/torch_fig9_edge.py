"""Paper Fig. 9 on the PyTorch port: edge-detection PSNR per multiplier
design, every image on ``device``.

    PYTHONPATH=src python benchmarks/torch_fig9_edge.py [--device cpu]

The same sweeps as ``benchmarks/fig9_edge.py``, through the port's batched
pipeline (``repro_torch.nn.conv.edge_detect_batched``): every wiring of
``core.multiplier.ALL_MULTIPLIERS`` through the LUT substrate, an 8-image
batch timed on every registered backend (``approx_pallas`` is the alias of
``approx_cuda`` and is swept once, under ``approx_cuda``), the width sweep
(its ``approx_pallas:*`` specs resolve through the alias onto
``approx_cuda``: on the card the CUDA kernels), and one call of the fused
conv (``kernels/fused_conv``). The PSNR values equal the JAX driver's; only
the timings, and the backend label of the alias, differ.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import multiplier as mult
from repro_torch.data import image_batch, photo_like, test_image
from repro_torch.kernels.fused_conv.ops import fused_conv2d
from repro_torch.nn import conv
from repro_torch.nn import substrate as sub

WIDTH_SPECS = ("approx_lut:proposed@4", "approx_lut:proposed",
               "approx_bitexact:proposed@16",
               "approx_pallas:proposed@4", "approx_pallas:csp_axc1@4",
               "approx_pallas:design_strollo2020")


def _timed(fn, device):
    """(result, µs) of one call, the device drained on both sides."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e6


def run(substrates=None, device="cuda") -> list:
    device = torch.device(device)
    rows = []
    designs = [n for n in mult.default_width_names() if n != "exact"]
    for img_name, img in (("testcard", test_image(96, 96)),
                          ("photo", photo_like(128, 128))):
        batch = torch.from_numpy(img[None]).to(device)
        ref = conv.edge_detect_batched(batch, "exact")[0]
        print(f"\n== Fig 9: edge detection PSNR vs exact ({img_name}) ==")
        for name in designs:
            s = sub.get_substrate("approx_lut", mult_name=name)
            out, us = _timed(lambda: conv.edge_detect_batched(batch, s)[0],
                             device)
            p = conv.psnr(ref, out)
            print(f"{name:>22s} PSNR={p:6.2f} dB")
            rows.append((f"fig9/{img_name}/{name}", us, f"psnr={p:.2f}dB"))

    # batched pipeline (8 images) across every registered backend
    imgs = torch.from_numpy(image_batch(8, 64, 64)).to(device)
    specs = (list(substrates) if substrates else
             [n for n in sub.list_substrates() if n != "approx_pallas"])
    print("\n== Fig 9: batched edge detection (8x64x64) per substrate ==")
    for spec in specs:
        s = sub.get_substrate(spec)
        _, us = _timed(lambda: conv.edge_detect_batched(imgs, s), device)
        print(f"{spec:>16s}: {us:10.0f} us/batch")
        rows.append((f"fig9/batched8/{s.meta.label}", us, "imgs=8x64x64"))

    # width sweep: the proposed wiring at 4/8/16-bit operand width (the
    # response is rescaled to the 8-bit range, so PSNR is comparable), plus
    # the approx_pallas (= approx_cuda) wirings at widths 4 and 8
    img = torch.from_numpy(photo_like(128, 128)[None]).to(device)
    ref = conv.edge_detect_batched(img, "exact")[0]
    print("\n== Fig 9+: operand-width sweep (incl. approx_cuda wirings) ==")
    for spec in WIDTH_SPECS:
        out, us = _timed(lambda: conv.edge_detect_batched(img, spec)[0], device)
        p = conv.psnr(ref, out)
        print(f"{spec:>28s} PSNR={p:6.2f} dB")
        rows.append((f"fig9/width/{spec}", us, f"psnr={p:.2f}dB"))

    # the fused conv kernel (in-kernel im2col); the plain version on the CPU
    px = torch.from_numpy((np.asarray(test_image(96, 96), np.int32) >> 1)[None]
                          ).to(device)
    _, us = _timed(lambda: fused_conv2d(px, conv.LAPLACIAN, "proposed"), device)
    rows.append(("fig9/cuda_fused_conv", us, f"device={device.type}"))
    print(f"fused_conv ({device.type}): {us:.0f} us")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args().device)
