#!/usr/bin/env python
"""Time ``lut_matmul``'s gather design against its tile design on a CUDA card.

    python3 tools/gather_sweep.py [--iters N]

For each shape of the sweep (the edge contraction (4,194,304 × 9) @ (9 × N)
and narrow-N contractions at K = 64, 512 and 4096) and each of two tables
that only these two designs take (a ±2^20 table, beyond int16: two int32
windows at width 8; an int16 table beyond the rows design's 32 planes),
both designs run through ``lut_matmul``'s private ``_launch(...,
design=...)`` on uniform random int8 codes, are held bit for bit to each
other, and are timed with CUDA events (the stream held asleep while the
host enqueues), as ``chip_smoke.py`` times them. M shrinks as N grows, so
that every output array stays near 2^26 entries. Prints the card
(``nvidia-smi``), one JSON line per shape and table with the design that
``blocking.gather_design`` picks there, and last the shapes where the
picked design is slower than the other (the thresholds' misses). Needs
CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import blocking  # noqa: E402
from repro_torch.kernels.lut_matmul import ops as lm  # noqa: E402

SLEEP_CYCLES = 20_000_000
NS = (1, 2, 4, 8, 16, 32, 64, 128)
KS = (9, 64, 512, 4096)
MAX_OUT = 1 << 26


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


def rows_for(k: int, n: int) -> int:
    """M of the sweep at (K, N): the edge's 4,194,304 rows at K = 9, 2^20
    at K = 64, 2^17 at K = 512, 256 at K = 4096, cut so that M·N ≤ 2^26."""
    m = {9: 1 << 22, 64: 1 << 20, 512: 1 << 17, 4096: 256}[k]
    return max(16, min(m, MAX_OUT // n))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gather_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(28)
    tables = {"noise": torch.randint(-2**20, 2**20, (1 << 16,), generator=gen,
                                     device=dev, dtype=torch.int32),
              "int16": torch.randint(-2**15, 2**15, (1 << 16,), generator=gen,
                                     device=dev, dtype=torch.int32)}
    for name, t in tables.items():
        if lm.rows_decomposition(t) is not None:
            print(f"gather_sweep: the {name} table takes the rows design",
                  file=sys.stderr)
            return 1
    misses = []
    for k in KS:
        for n in NS:
            m = rows_for(k, n)
            a = torch.randint(-128, 128, (1, m, k), generator=gen, device=dev,
                              dtype=torch.int8)
            b = torch.randint(-128, 128, (1, k, n), generator=gen, device=dev,
                              dtype=torch.int8)
            for name, t in tables.items():
                ms, outs = {}, {}
                for design in ("gather", "tile"):
                    def run(design=design):
                        return lm._launch(a, b, t, 8, design=design)
                    outs[design] = run()
                    ms[design] = time_ms(run, args.iters)
                equal = torch.equal(outs["gather"], outs["tile"])
                del outs
                if not equal:
                    print(f"gather_sweep: gather and tile differ at ({m} x {k}) "
                          f"@ ({k} x {n}), {name}", file=sys.stderr)
                    return 1
                served = blocking.resolve_design(None, blocking.eligible_designs(
                    m, k, n, 8, lm.table_checks(t)), "lut_matmul", "")
                other = "tile" if served == "gather" else "gather"
                if served in ms and ms[served] > ms[other]:
                    misses.append({"shape": [1, m, k, n], "table": name,
                                   "served": served,
                                   "served_over_other": ms[served] / ms[other]})
                print(json.dumps({"shape": [1, m, k, n], "table": name,
                                  "entry_bytes": lm.gather_table(t).element_size(),
                                  "gather_ms": ms["gather"], "tile_ms": ms["tile"],
                                  "tile_over_gather": ms["tile"] / ms["gather"],
                                  "served": served, "card": card}), flush=True)
            del a, b
            torch.cuda.empty_cache()
    print(json.dumps({"misses": misses, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
