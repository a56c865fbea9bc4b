"""Paper Table 2 on the PyTorch port: A+B+C+1 compressor truth-table
statistics (P_E, E_mean), with the packed evaluation timed on ``device``.

    PYTHONPATH=src python benchmarks/torch_table2_compressors.py [--device cpu]

The values equal ``benchmarks/table2_compressors.py``'s; only the timings
differ.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import compressors as comp


def _us_per_call(fn, device, iters: int = 20) -> float:
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def run(device="cuda") -> list:
    device = torch.device(device)
    rows = []
    print("\n== Table 2: sign-focused A+B+C+1 compressors ==")
    print(f"{'design':>22s} {'P_E':>8s} {'paper':>8s} {'E_mean':>8s} {'paper':>8s}")
    for name, c in comp.ALL_3INPUT.items():
        pe, em = c.error_probability(), c.mean_error()
        ppe, pem = comp.PAPER_TABLE2_STATS.get(name, (0.0, 0.0)) if \
            name != "exact3" else (0.0, 0.0)
        print(f"{name:>22s} {pe:8.4f} {ppe:8.4f} {em:+8.4f} {pem:+8.4f}")
        assert abs(pe - ppe) < 1e-9 and abs(em - pem) < 1e-9, name

        # throughput of the vectorized compressor evaluation
        idx = torch.from_numpy(
            np.random.default_rng(0).integers(0, 8, 1 << 16)).to(device)
        us = _us_per_call(lambda: c.apply_packed(idx), device)
        rows.append((f"table2/{name}", us, f"PE={pe:.4f};Emean={em:+.4f}"))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args().device)
