"""Paper Table 3 on the PyTorch port: the proposed A+B+C+D+1 compressor's
truth table and statistics, with the packed evaluation timed on ``device``.

    PYTHONPATH=src python benchmarks/torch_table3_compressor4.py [--device cpu]

The values equal ``benchmarks/table3_compressor4.py``'s; only the timing
differs.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import compressors as comp


def run(device="cuda") -> list:
    device = torch.device(device)
    c = comp.PROPOSED4
    print("\n== Table 3: proposed A+B+C+D+1 (reconstruction) ==")
    print("A B C D | exact approx ED   P(combo)")
    probs = c.input_probs()
    for idx in range(16):
        bits = [(idx >> k) & 1 for k in (3, 2, 1, 0)]
        print(f"{bits[0]} {bits[1]} {bits[2]} {bits[3]} |   {c.exact[idx]}     "
              f"{c.values[idx]}    {c.errors[idx]:+d}   {probs[idx]:.4f}")
    pe, em = c.error_probability(), c.mean_error()
    print(f"P_E = {pe:.4f} (58/256), E_mean = {em:+.4f} (+7/256)")
    assert abs(pe - 58 / 256) < 1e-12 and abs(em - 7 / 256) < 1e-12

    idx = torch.from_numpy(
        np.random.default_rng(0).integers(0, 16, 1 << 16)).to(device)
    c.apply_packed(idx)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        c.apply_packed(idx)
    if device.type == "cuda":
        torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / 20 * 1e6
    return [("table3/proposed4", us, f"PE={pe:.4f};Emean={em:+.4f}")]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args().device)
