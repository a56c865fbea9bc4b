"""Quickstart on the PyTorch port: the paper's approximate multiplier in 60
seconds.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--plan path.json]
     [--device cpu]

The counterpart of ``examples/quickstart.py``, its six steps on ``--device``
(the card unless ``--device cpu``; no card raises). ``--plan`` loads a
per-site substrate plan (a plan JSON or a bundle dir — e.g. one written by
``python -m repro_torch.launch.autotune``, or by ``repro``'s, whose files
load unchanged) for the final mixed-substrate edge-detection step; without
it a small hand-written mixed plan demonstrates the same API. Run as a
script, its last line is a JSON object of the plan and its PSNR.
"""
import argparse
import json
import pathlib

import numpy as np
import torch

from repro_torch.core import energy, lut, metrics
from repro_torch.core import multiplier as m
from repro_torch.device import resolve_device
from repro_torch.nn import approx_dot


def main(plan_path=None, device="cuda") -> dict:
    """Run the six steps; returns each step's value."""
    device = resolve_device(str(device))
    # 1. multiply two signed 8-bit numbers with the paper's multiplier
    a = torch.tensor(-97, dtype=torch.int32, device=device)
    b = torch.tensor(45, dtype=torch.int32, device=device)
    product = int(m.approx_multiply(a, b))
    print(f"exact   {int(a)} x {int(b)} = {int(a) * int(b)}")
    print(f"approx  {int(a)} x {int(b)} = {product}")

    # 2. its exhaustive error metrics (paper Table 4)
    rep = metrics.evaluate(m.approx_multiply, "proposed", device=device)
    print(f"\n{rep.row()}")
    print("paper:   ER=98.04%  NMED=0.682%  MRED=26.29%")

    # 3. hardware savings vs the best existing design (paper Table 5)
    s = energy.savings_vs("proposed", "design_du2022")
    print(f"\npower saving vs [2]: {s['power']:.1f}% (paper 14.39%), "
          f"PDP: {s['pdp']:.1f}% (paper 29.21%)")

    # 4. use it as a neural-net matmul execution mode
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32)).to(device)
    w = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32)).to(device)
    y_exact = approx_dot.approx_dot(x, w, mode="exact")
    y_approx = approx_dot.approx_dot(x, w, mode="approx_bitexact")
    rel = float(torch.linalg.norm(y_approx - y_exact) / torch.linalg.norm(y_exact))
    print(f"\napprox_dot relative error vs float matmul: {rel:.4f}")

    # 5. the deployment LUT artifact
    table = lut.build_lut("proposed")
    print(f"\n256x256 product LUT built; f(0,0) = {table[128, 128]} "
          "(the compensation constant fires on zero operands — true to the netlist)")

    # 6. per-site substrate plans: mixed-substrate edge detection
    from repro_torch.data import test_image
    from repro_torch.nn import conv
    from repro_torch.nn.plan import SubstratePlan, load_plan

    if plan_path:
        p = pathlib.Path(plan_path)
        if p.is_dir():
            from repro_torch.checkpoint import load_plan_bundle
            plan, _, _ = load_plan_bundle(str(p))
        else:
            plan = load_plan(str(p))
    else:  # cheaper center tap, full-width smoothing ring
        plan = SubstratePlan(
            default="approx_bitexact:proposed@8",
            rules=(("conv.edge.center", "approx_bitexact:proposed@6"),))
    img = torch.from_numpy(test_image(96, 96)[None]).to(device)
    ref = conv.edge_detect_batched(img, "exact")
    planned = conv.edge_detect_planned(img, plan)
    planned_db = conv.psnr(ref, planned)
    print(f"\nplanned edge detection under {plan.label}: "
          f"PSNR={planned_db:.2f} dB vs exact")
    for pattern, spec in plan.rules:
        print(f"  {pattern} -> {spec}")
    return {"product": product, "report": rep, "savings": s,
            "approx_dot_rel": rel, "f00": int(table[128, 128]),
            "plan": plan, "planned": planned.cpu().numpy(),
            "planned_psnr_db": planned_db}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="substrate plan JSON or bundle dir for step 6")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the "
                         "kernels' plain versions)")
    args = ap.parse_args()
    res = main(plan_path=args.plan, device=args.device)
    print(json.dumps({"plan": res["plan"].label,
                      "planned_psnr_db": float(res["planned_psnr_db"])}))
