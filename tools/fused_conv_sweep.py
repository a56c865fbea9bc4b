#!/usr/bin/env python
"""Sweep the stencil design's block shape on a CUDA card.

    python3 tools/fused_conv_sweep.py [--shape B H W] [--iters N]

Builds ``src/repro_torch/csrc/fused_conv.cu`` once per block shape (outputs
per thread ``ST_V``, rows per strip ``ST_ROWS``, strips per block ``ST_TY``,
rows in flight ``ST_AHEAD``; ``-D`` overrides of the source's defaults, one
``nvcc`` per variant, all started together) into
``build/fused_conv_sweep/``, holds each variant's stencil kernel exactly
against ``stencil_conv_plain`` at the served shape (8 full-HD photo-like
frames, the 3×3 Laplacian, proposed@8 and ``exact``), then times every
variant in turns with CUDA events, as ``chip_smoke.py`` does, beside a
device-to-device copy of the same bytes. The default variant also runs on
uniformly random pixels and on a constant image (shared-memory bank
conflicts of the column gathers depend on the pixels) and with a 3-column
kernel (the integer work grows with the distinct taps). Prints the card
(``nvidia-smi``) and one JSON line per variant, registers from ``-Xptxas
-v`` included. Needs CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.data import photo_like  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.fused_conv import ops as fc  # noqa: E402
from repro_torch.nn import conv  # noqa: E402

#: (ST_V, ST_ROWS, ST_TY, ST_AHEAD); the first is the source's default
VARIANTS = [(8, 32, 2, 2), (4, 16, 4, 2), (4, 16, 4, 1), (8, 16, 2, 2),
            (8, 16, 4, 2), (8, 24, 2, 2), (8, 32, 1, 2), (8, 32, 2, 1),
            (8, 64, 1, 2), (8, 8, 4, 2)]
SLEEP_CYCLES = 20_000_000


def time_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def stencil_registers(ptxas_log: str) -> dict:
    """{"KHxKW": registers} of the stencil kernel's instantiations, from
    ``-Xptxas -v`` output."""
    regs, entry = {}, None
    for ln in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry and "stencil" in entry:
            kh, kw = re.search(r"ILi(\d)ELi(\d)E", entry).groups()
            regs[f"{kh}x{kw}"] = int(m.group(1))
    return regs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, default=(8, 1088, 1920))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_conv_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out_dir = ROOT / "build" / "fused_conv_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "fused_conv.cu"
    procs = {}
    for v in VARIANTS:
        name = "v{}_rows{}_ty{}_ahead{}".format(*v)
        defs = [f"-D{k}={x}" for k, x in
                zip(("ST_V", "ST_ROWS", "ST_TY", "ST_AHEAD"), v)]
        log = open(out_dir / f"{name}.log", "w")
        procs[name] = (v, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *defs, "-o",
             str(out_dir / f"lib{name}.so"), str(src)],
            stdout=log, stderr=subprocess.STDOUT))
    for name, (_, p) in procs.items():
        if p.wait() != 0:
            print((out_dir / f"{name}.log").read_text(), file=sys.stderr)
            return 1

    dev = torch.device("cuda")
    b, h, w = args.shape
    frames = np.stack([np.pad(photo_like(min(h, 1080), w, seed=i),
                              ((0, max(0, h - 1080)), (0, 0)))
                       for i in range(b)])
    images = {"photo": conv.to_signed_pixels(torch.from_numpy(frames).to(dev), 8),
              "random": torch.from_numpy(np.random.default_rng(0).integers(
                  -128, 128, (b, h, w)).astype(np.int32)).to(dev),
              "constant": torch.full((b, h, w), 37, dtype=torch.int32, device=dev)}
    binomial = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]])  # 3 distinct taps
    # (image, kernel, key, kind) per case; the default variant also runs the
    # cases after the first two: other pixel data, and one more column
    cases = {"laplacian,proposed": ("photo", conv.LAPLACIAN, "proposed", "closed_form"),
             "laplacian,exact": ("photo", conv.LAPLACIAN, "exact", "lut"),
             "laplacian,proposed,random": ("random", conv.LAPLACIAN, "proposed",
                                           "closed_form"),
             "laplacian,proposed,constant": ("constant", conv.LAPLACIAN,
                                             "proposed", "closed_form"),
             "binomial,proposed": ("photo", binomial, "proposed", "closed_form")}
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = {}
    for i, (name, (v, _)) in enumerate(procs.items()):
        fn = getattr(ctypes.CDLL(str(out_dir / f"lib{name}.so")),
                     "fused_conv2d_stencil_launch")
        fn.argtypes = list(fc._LUT_ARGTYPES)
        fn.restype = ctypes.c_int
        own = list(cases.items()) if i == 0 else list(cases.items())[:2]
        for case, (img, kern, key, kind) in own:
            x = images[img]
            taps = tuple(tuple(int(c) for c in row) for row in kern)
            slots, cols = fc.fused_conv_columns(taps, key, kind, dev)
            out = torch.empty_like(x)

            def call(fn=fn, x=x, out=out, slots=slots, cols=cols, name=name):
                build.check(fn(x.data_ptr(), out.data_ptr(), b, h, w,
                               slots.ctypes.data, 3, 3, cols.data_ptr(),
                               cols.shape[0], 8, stream), name)

            call()
            torch.cuda.synchronize()
            if not torch.equal(out, fc.stencil_conv_plain(x, slots, cols, 8, 3, 3)):
                print(f"{name} {case}: differs from stencil_conv_plain",
                      file=sys.stderr)
                return 1
            calls[(name, case)] = call
    ms = {k: [] for k in calls}
    copy_ms = []
    x, out = images["photo"], torch.empty_like(images["photo"])
    for _ in range(2):  # in turns, twice
        for k, call in calls.items():
            ms[k].append(time_ms(call, args.iters))
        copy_ms.append(time_ms(lambda: out.copy_(x), args.iters))
    bound = 4 * (2 * b * h * w + 9) / 3.35e12 * 1e3
    for name, (v, _) in procs.items():
        regs = stencil_registers((out_dir / f"{name}.log").read_text())
        print(json.dumps({
            "variant": dict(zip(("ST_V", "ST_ROWS", "ST_TY", "ST_AHEAD"), v)),
            "ms": {case: t for (n, case), t in ms.items() if n == name},
            "bound_ms": bound, "copy_ms": copy_ms, "card": card,
            "registers_3x3": regs.get("3x3"),
            "registers_max": max(regs.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
