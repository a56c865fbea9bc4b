#!/usr/bin/env python
"""Time the rows design of both contraction kernels on a CUDA card.

    python3 tools/rows_sweep.py [--m M] [--keys proposed@8,...] [--iters N]
                                [--tile]

At minitron-8b's four dense shapes, (M × 4096) @ (4096 × {4096, 1024,
16384}) and (M × 16384) @ (16384 × 4096) at M = 256 by default, on seeded
int8 codes: ``approx_matmul``'s rows design under each wiring of
``--keys`` and ``lut_matmul``'s under ``exact``, each held exactly against
its plain twin first (``exact`` also against ``torch._int_mm``), then
timed with CUDA events (the stream held asleep while the host enqueues)
beside ``torch._int_mm`` and, with ``--tile``, the tile design. Prints the
card (``nvidia-smi``) and one JSON line per shape and key with the planes
R, the times and the share of the tensor-core bound ((R + 1)·2·M·K·N int8
operations at 1979 TOP/s against the bytes at 3.35 TB/s). Needs CUDA and
nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import multiplier as mult  # noqa: E402
from repro_torch.kernels import blocking  # noqa: E402
from repro_torch.kernels.approx_matmul import ops as am  # noqa: E402
from repro_torch.kernels.lut_matmul import ops as lm  # noqa: E402

SHAPES = [(4096, 4096), (4096, 1024), (4096, 16384), (16384, 4096)]
SLEEP_CYCLES = 20_000_000
INT8_TC_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12


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


def bound_ms(m: int, k: int, n: int, planes: int) -> float:
    ops = (planes + 1) * 2 * m * k * n
    return 1e3 * max(ops / INT8_TC_OPS_PER_S, (m * k + k * n + 4 * m * n)
                     / HBM_BYTES_PER_S)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--m", type=int, default=256)
    p.add_argument("--keys", default="proposed@8,csp_axc1@6,design_akbari2017@8")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--tile", action="store_true",
                   help="also time the tile design (seconds per shape)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("rows_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    t_exact = lm.device_table("exact", dev)
    m = args.m
    for k, n in SHAPES:
        a = torch.from_numpy(rng.integers(-127, 128, (1, m, k)).astype(np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-127, 128, (1, k, n)).astype(np.int8)).to(dev)
        runs = [(key, lambda key=key: am._launch(a, w, key, design="rows"),
                 lambda key=key: am._launch(a, w, key, design="tile"),
                 am.rows_decomposition(key)) for key in args.keys.split(",")]
        runs.append(("lut:exact", lambda: lm._launch(a, w, t_exact, 8, design="rows"),
                     lambda: lm._launch(a, w, t_exact, 8, design="tile"),
                     lm.rows_decomposition(t_exact)))
        int_mm = time_ms(lambda: torch._int_mm(a[0], w[0]), args.iters)
        for key, rows, tile, d in runs:
            n_bits = mult.split_width(key.split(":")[-1])[1]
            want = blocking.rows_matmul_plain(a, w, d, n_bits)
            got = rows()
            err = int((got.long() - want.long()).abs().max())
            if key == "lut:exact":
                err = max(err, int((got[0].long() - torch._int_mm(a[0], w[0]).long())
                                   .abs().max()))
            ms = time_ms(rows, args.iters)
            row = {"m": m, "k": k, "n": n, "key": key, "planes": d.planes,
                   "max_abs_err": err, "rows_ms": ms, "int_mm_ms": int_mm,
                   "bound_ms": bound_ms(m, k, n, d.planes),
                   "share_of_bound": bound_ms(m, k, n, d.planes) / ms}
            if args.tile:
                row["tile_ms"] = time_ms(tile, 2)
            print(json.dumps(row), flush=True)
            if err:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
