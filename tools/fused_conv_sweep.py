#!/usr/bin/env python
"""Sweep the fused conv's stencil and tiled designs on a CUDA card.

    python3 tools/fused_conv_sweep.py [--shape B H W] [--iters N]
                                      [--only stencil|tiled]

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
-v`` included.

The tiled design (``csrc/conv_tiles.cuh``) is swept the same way over its
tile shape (output columns ``TL_TW``, rows a thread ``TL_R``), each variant
held exactly to ``tiled_conv_plain`` and timed at the convs its paths run
(the Laplacian at widths 12 and 16, a random 7×7 kernel under proposed@8 and
``exact``), on photo-like frames and on uniform random codes. The default
variant also times every product source (``TILED_SOURCES``: int32 columns
in shared or global memory, byte tables in shared or global memory) at
widths 9..16 and tap counts 2 and 49, which sets ``tiled_source``'s
thresholds. Needs CUDA and nvcc.
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
#: (TL_TW, TL_R) of the tiled design; the first is the source's default
TILED_VARIANTS = [(128, 16), (128, 8), (64, 16), (128, 32), (64, 32), (32, 16)]
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


def tiled_registers(ptxas_log: str) -> dict:
    """{"DC=k,src=s": registers} of the tiled kernel's instantiations (DC
    kernel rows a chunk, product source s)."""
    regs, entry = {}, None
    for ln in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry and "tiled" in entry:
            dc, src = re.search(r"ILi(\d+)ELi(\d)E", entry).groups()
            regs[f"DC={dc},src={src}"] = int(m.group(1))
    return regs


def build_variants(out_dir: Path, variants: dict) -> bool:
    """One nvcc per variant (name -> -D flags), all started together."""
    procs = {}
    for name, defs in variants.items():
        log = open(out_dir / f"{name}.log", "w")
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *defs, "-o",
             str(out_dir / f"lib{name}.so"), str(build.CSRC / "fused_conv.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    ok = True
    for name, p in procs.items():
        if p.wait() != 0:
            print((out_dir / f"{name}.log").read_text(), file=sys.stderr)
            ok = False
    return ok


def tiled_sweep(args, card: str, frames: np.ndarray, out_dir: Path) -> int:
    """Build, check and time every tiled variant, then every product source
    on the default one; one JSON line per variant and per source case."""
    names = {"tl_tw{}_r{}".format(*v): v for v in TILED_VARIANTS}
    if not build_variants(out_dir, {n: [f"-DTL_TW={v[0]}", f"-DTL_R={v[1]}"]
                                    for n, v in names.items()}):
        return 1
    dev = torch.device("cuda")
    b, h, w = args.shape
    rng = np.random.default_rng(0)
    k7 = rng.integers(-100, 100, (7, 7)).astype(np.int32)
    u8 = torch.from_numpy(frames).to(dev)

    cache = {}

    def pixels(data: str, n: int) -> torch.Tensor:
        if (data, n) not in cache:
            cache[data, n] = conv.to_signed_pixels(u8, n) if data == "photo" else \
                torch.from_numpy(rng.integers(-(1 << (n - 1)), 1 << (n - 1), (b, h, w))
                                 .astype(np.int32)).to(dev)
        return cache[data, n]

    # (key, kernel, kind, source or None: tiled_source's) per case
    cases = {"laplacian,proposed@12": ("proposed@12", conv.LAPLACIAN, "closed_form", None),
             "laplacian,proposed@16": ("proposed@16", conv.LAPLACIAN, "closed_form", None),
             "7x7,proposed": ("proposed", k7, "closed_form", None),
             "7x7,exact": ("exact", k7, "lut", None)}
    sources = {}  # the default variant only: every source at widths 9..16
    for n in (9, 12, 14, 16):
        for kname, kern in (("laplacian", conv.LAPLACIAN), ("7x7", k7 << max(0, n - 8))):
            for src in fc.TILED_SOURCES:
                if src == "columns16":
                    continue
                taps = tuple(tuple(int(c) for c in row) for row in kern)
                d = len(fc._wrapped_taps(taps, n)[0])
                if src == "columns32" and d * (4 << n) > 160 << 10:
                    continue  # beyond shared memory: refused
                sources[f"{kname},proposed@{n},{src}"] = (f"proposed@{n}", kern,
                                                          "closed_form", src)
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = {}
    for i, name in enumerate(names):
        fn = getattr(ctypes.CDLL(str(out_dir / f"lib{name}.so")),
                     "fused_conv2d_tiled_launch")
        fn.argtypes = list(fc._TILED_ARGTYPES)
        fn.restype = ctypes.c_int
        own = {**cases, **(sources if i == 0 else {})}
        for case, (key, kern, kind, source) in own.items():
            key = fc.mult.canonical_key(key)
            n = fc.mult.split_width(key)[1]
            taps = tuple(tuple(int(c) for c in row) for row in kern)
            kh, kw = len(taps), len(taps[0])
            slots, prod, src = fc.tiled_products(taps, key, kind, dev, source)
            for data in ("photo", "random"):
                x = pixels(data, n)
                out = torch.empty_like(x)

                def call(fn=fn, x=x, out=out, slots=slots, prod=prod, src=src,
                         n=n, kh=kh, kw=kw, name=name):
                    build.check(fn(x.data_ptr(), out.data_ptr(), b, h, w,
                                   slots.ctypes.data, kh, kw, prod.data_ptr(),
                                   prod.shape[0], n, fc.TILED_SOURCES[src],
                                   stream), name)

                call()
                torch.cuda.synchronize()
                if not torch.equal(out, fc.tiled_conv_plain(x, slots, prod, n, kh, kw,
                                                            src)):
                    print(f"{name} {case} {data}: differs from tiled_conv_plain",
                          file=sys.stderr)
                    return 1
                calls[(name, f"{case},{data}")] = call
    ms = {k: [] for k in calls}
    for _ in range(2):  # in turns, twice
        for k, call in calls.items():
            ms[k].append(time_ms(call, args.iters))
    bound = 4 * (2 * b * h * w + 9) / 3.35e12 * 1e3
    for i, (name, v) in enumerate(names.items()):
        print(json.dumps({
            "tiled_variant": dict(zip(("TL_TW", "TL_R"), v)),
            "ms": {case: t for (n_, case), t in ms.items()
                   if n_ == name and case.rsplit(",", 1)[0] in cases},
            "bytes_bound_ms_3x3": bound, "card": card,
            "registers": tiled_registers((out_dir / f"{name}.log").read_text())}),
              flush=True)
        if i == 0:
            print(json.dumps({"tiled_sources": {
                case: t for (n_, case), t in ms.items()
                if n_ == name and case.rsplit(",", 1)[0] in sources},
                "card": card}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, default=(8, 1088, 1920))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("stencil", "tiled"), default=None)
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
    b, h, w = args.shape
    frames = np.stack([np.pad(photo_like(min(h, 1080), w, seed=i),
                              ((0, max(0, h - 1080)), (0, 0)))
                       for i in range(b)])
    if args.only != "stencil":
        rc = tiled_sweep(args, card, frames, out_dir)
        if rc or args.only == "tiled":
            return rc
    procs = {}
    for v in VARIANTS:
        procs["v{}_rows{}_ty{}_ahead{}".format(*v)] = (v, [
            f"-D{k}={x}" for k, x in zip(("ST_V", "ST_ROWS", "ST_TY", "ST_AHEAD"), v)])
    if not build_variants(out_dir, {n: d for n, (_, d) in procs.items()}):
        return 1

    dev = torch.device("cuda")
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
