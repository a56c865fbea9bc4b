"""The paper's application (§4) on the PyTorch port: Laplacian edge detection
through the approximate multiplier — batched substrate pipeline, the CUDA
kernel path, and the PSNR table.

Run: PYTHONPATH=src python examples/torch_edge_detection.py [--device cpu]

The counterpart of ``examples/edge_detection.py``, every image on
``--device`` (the card unless ``--device cpu``; no card raises). Its three
hard asserts are the reference's: the batched pipeline equals the
single-image loop; the ``approx_pallas`` spec, which resolves to
``approx_cuda`` (on the card the fused conv kernel), equals the core model;
and ``fused_conv2d`` equals ``conv2d_int`` under the bit-exact scalar.
Run as a script, its last line is a JSON object of its PSNRs.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.data import image_batch, photo_like, test_image
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_conv.ops import fused_conv2d
from repro_torch.nn import conv
from repro_torch.nn import substrate as sub

PSNR_DESIGNS = ("proposed", "design_du2022", "design_strollo2020",
                "design_esposito2018")


def ascii_render(img: np.ndarray, width: int = 48) -> str:
    h, w = img.shape
    step = max(1, w // width)
    chars = " .:-=+*#%@"
    rows = []
    for y in range(0, h, step * 2):
        row = "".join(chars[min(9, int(img[y, x]) * 10 // 256)]
                      for x in range(0, w, step))
        rows.append(row)
    return "\n".join(rows)


def main(device="cuda") -> dict:
    """Run the example; returns its maps and PSNRs (numpy / floats)."""
    device = resolve_device(str(device))
    img = test_image(96, 96)
    print("input image:")
    print(ascii_render(img))

    t_img = torch.from_numpy(img).to(device)
    exact = conv.edge_detect(t_img, "exact").cpu().numpy()
    approx = conv.edge_detect(t_img, "proposed").cpu().numpy()
    psnr_approx = conv.psnr(exact, approx)
    print("\nexact-multiplier edge map:")
    print(ascii_render(exact))
    print("\nproposed approximate-multiplier edge map "
          f"(PSNR {psnr_approx:.2f} dB):")
    print(ascii_render(approx))

    # batched pipeline: a whole image batch through one substrate contraction,
    # per-image bit-identical to the single-image reference path above
    imgs = torch.from_numpy(image_batch(8, 96, 96)).to(device)
    batched = conv.edge_detect_batched(imgs, "approx_bitexact:proposed")
    singles = torch.stack([conv.edge_detect(im, "proposed") for im in imgs])
    assert torch.equal(batched, singles), "batched pipeline must match the loop"
    print(f"\nbatched edge detection ({imgs.shape[0]} images) == single-image loop: OK")

    # approx_pallas resolves to approx_cuda: on the card the fused conv kernel
    kernel = conv.edge_detect_batched(imgs[:2], "approx_pallas")
    assert torch.equal(kernel, singles[:2]), "approx_cuda substrate must match"
    print("approx_pallas (= approx_cuda) substrate output == core model: OK")

    # fused conv kernel (im2col inside the kernel) agrees with the core model
    px = torch.from_numpy(np.asarray(img, np.int32) >> 1).to(device)
    fused = fused_conv2d(px[None], conv.LAPLACIAN, "proposed")[0]
    ref = conv.conv2d_int(px, conv.LAPLACIAN,
                          sub.get_substrate("approx_bitexact").scalar)
    assert torch.equal(fused, ref), "fused kernel must match the core model"
    print(f"fused_conv kernel output ({device.type}) == core model: OK")

    print("\nPSNR across designs (photo-statistics image, LUT substrate):")
    photo = torch.from_numpy(photo_like(128, 128)[None]).to(device)
    ref = conv.edge_detect_batched(photo, "exact")[0]
    table = {}
    for name in PSNR_DESIGNS:
        s = sub.get_substrate("approx_lut", mult_name=name)
        out = conv.edge_detect_batched(photo, s)[0]
        table[name] = conv.psnr(ref, out)
        print(f"  {name:>22s}: {table[name]:6.2f} dB")
    return {"exact": exact, "approx": approx, "psnr_approx_db": psnr_approx,
            "batched": batched.cpu().numpy(), "fused": fused.cpu().numpy(),
            "psnr_db": table}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the "
                         "kernels' plain versions)")
    res = main(ap.parse_args().device)
    print(json.dumps({"psnr_approx_db": float(res["psnr_approx_db"]),
                      "psnr_db": {k: float(v) for k, v in res["psnr_db"].items()}}))
