"""Paper Fig. 10 on the PyTorch port: PDP vs MRED trade-off scatter data,
the MRED products computed on ``device``.

    PYTHONPATH=src python benchmarks/torch_fig10_tradeoff.py [--device cpu]

The values equal ``benchmarks/fig10_tradeoff.py``'s; only the timings
differ.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core import energy, metrics
from repro_torch.core import multiplier as m


def run(device="cuda") -> list:
    rows = []
    print("\n== Fig 10: PDP (fJ) vs MRED (%) trade-off ==")
    print(f"{'design':>22s} {'PDP':>8s} {'MRED%':>7s}")
    pts = []
    for name in energy.PAPER_TABLE5:
        if name == "exact":
            continue
        t0 = time.perf_counter()
        pdp = energy.estimate(name)["pdp"]
        mred = metrics.evaluate(m.ALL_MULTIPLIERS[name], name,
                                device=device).mred * 100
        us = (time.perf_counter() - t0) * 1e6
        pts.append((name, pdp, mred))
        print(f"{name:>22s} {pdp:8.1f} {mred:7.2f}")
        rows.append((f"fig10/{name}", us, f"pdp={pdp:.1f};mred={mred:.2f}"))
    pareto = [p for p in pts
              if not any(q[1] < p[1] and q[2] < p[2] for q in pts)]
    on_pareto = any(p[0] == "proposed" for p in pareto)
    print(f"proposed on Pareto front: {on_pareto} "
          f"(paper: lowest PDP and lowest MRED)")
    rows.append(("fig10/pareto", 0.0, f"proposed_on_front={on_pareto}"))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args().device)
