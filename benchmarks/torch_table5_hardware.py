"""Paper Table 5 on the PyTorch port: area / power / delay / PDP from the
unit-gate analytical model (``repro_torch.core.energy``).

    PYTHONPATH=src python benchmarks/torch_table5_hardware.py

Plain Python arithmetic: ``device`` is accepted for a uniform driver
signature and unused. The values equal ``benchmarks/table5_hardware.py``'s;
only the timings differ.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core import energy


def run(device="cuda") -> list:
    rows = []
    print("\n== Table 5: hardware model (unit-gate, calibrated on exact row) ==")
    print(f"{'design':>22s} {'area':>8s} {'paper':>8s} {'power':>7s} {'paper':>7s} "
          f"{'delay':>6s} {'paper':>6s} {'PDP':>7s} {'paper':>7s}")
    for name, paper in energy.PAPER_TABLE5.items():
        t0 = time.perf_counter()
        e = energy.estimate(name)
        us = (time.perf_counter() - t0) * 1e6
        print(f"{name:>22s} {e['area']:8.1f} {paper['area']:8.1f} "
              f"{e['power']:7.1f} {paper['power']:7.1f} "
              f"{e['delay']:6.2f} {paper['delay']:6.2f} "
              f"{e['pdp']:7.1f} {paper['pdp']:7.1f}")
        rows.append((f"table5/{name}", us,
                     f"power={e['power']:.1f}uW;pdp={e['pdp']:.1f}fJ"))
    s = energy.savings_vs("proposed", "design_du2022")
    print(f"proposed vs [2]: power -{s['power']:.2f}% (paper -14.39%), "
          f"delay -{s['delay']:.2f}% (paper -17.3%), "
          f"PDP -{s['pdp']:.2f}% (paper -29.21%)")
    sx = energy.savings_vs("proposed", "exact")
    print(f"proposed vs exact: power -{sx['power']:.2f}%, PDP -{sx['pdp']:.2f}%")
    rows.append(("table5/savings_vs_du2022", 0.0,
                 f"power={s['power']:.2f}%;pdp={s['pdp']:.2f}%"))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args().device)
