"""Plan-vs-uniform energy/quality table for autotuned substrate plans, on
the PyTorch port.

The counterpart of ``benchmarks/autotune_plan.py``, built on
``repro_torch.launch.autotune``. Evaluates a per-site
:class:`repro_torch.nn.plan.SubstratePlan` against the uniform
``proposed@8`` baseline on the edge-detection workload, every image on
``device`` (the card unless the caller asks for the CPU; no card raises):
estimated PDP energy (MACs × unit-gate PDP, ``obs.meter`` pricing), PSNR vs
the exact multiplier, and the time of one planned pipeline call (the device
drained on both sides).

``run(plan=...)`` evaluates a given plan (a plan JSON file or a plan-bundle
directory, the port's or ``repro``'s); without one it runs the greedy
autotuner search first and evaluates its winner. Results land in
``BENCH_torch_autotune.json`` at the repo root (the reference's
``BENCH_autotune.json`` is left alone). The PSNR and PDP figures equal the
reference's; only the times differ.

Standalone: ``python -m benchmarks.torch_autotune_plan [--plan PATH]
[--device cpu]``.
"""
from __future__ import annotations

import json
import pathlib
import time

import torch

from repro_torch.data import image_batch
from repro_torch.device import card_name, resolve_device
from repro_torch.launch import autotune
from repro_torch.nn import conv
from repro_torch.nn import plan as plan_mod

_REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
DEFAULT_JSON = _REPO_ROOT / "BENCH_torch_autotune.json"

BASELINE = "approx_bitexact:proposed@8"
WIRINGS = ("proposed", "design_du2022")
WIDTHS = (6, 7, 8)


def _load_plan(path) -> plan_mod.SubstratePlan:
    p = pathlib.Path(path)
    if p.is_dir():
        from repro_torch import checkpoint as ckpt

        plan, _, _ = ckpt.load_plan_bundle(str(p))
        return plan
    return plan_mod.load_plan(str(p))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(plan=None, json_path=DEFAULT_JSON, device="cuda") -> list:
    device = resolve_device(str(device))
    rows = []
    imgs = torch.from_numpy(image_batch(6, 64, 64)).to(device)
    ref = conv.edge_detect_batched(imgs, "exact")

    search = None
    if plan is not None:
        tuned, source = _load_plan(plan), str(plan)
    else:
        _sync(device)
        t0 = time.perf_counter()
        res = autotune.autotune_edge(images=imgs, wirings=WIRINGS,
                                     widths=WIDTHS, baseline=BASELINE,
                                     device=device)
        _sync(device)
        search_us = (time.perf_counter() - t0) * 1e6
        tuned, source = res["plan"], "greedy search"
        search = {"budget_scored_db": res["budget_scored_db"],
                  "accepted_moves": len(res["history"]) - 1,
                  "rolled_back": res["rolled_back"]}
        rows.append(("autotune/search", search_us,
                     f"moves={search['accepted_moves']}"))

    print(f"\n== Autotune: plan vs uniform {BASELINE} ({source}) ==")
    print(f"{'variant':>10s} {'psnr_db':>8s} {'pdp_fj':>12s} {'us':>10s}")
    records = {}
    for name, p in (("uniform", plan_mod.SubstratePlan.uniform(BASELINE)),
                    ("plan", tuned)):
        site_macs = autotune.measure_site_macs(
            lambda pp: conv.edge_detect_planned(imgs, pp), p)
        pdp = autotune.plan_pdp_fj(site_macs, p)
        conv.edge_detect_planned(imgs, p)  # warm (the card's tables built)
        _sync(device)
        t0 = time.perf_counter()
        out = conv.edge_detect_planned(imgs, p)
        _sync(device)
        us = (time.perf_counter() - t0) * 1e6
        db = conv.psnr(ref, out)
        print(f"{name:>10s} {db:8.2f} {pdp:12.1f} {us:10.0f}")
        records[name] = {"plan": p.to_dict(), "psnr_db": db, "pdp_fj": pdp,
                         "us_per_batch": us, "site_macs": site_macs}
        rows.append((f"autotune/{name}", us,
                     f"psnr={db:.2f}dB,pdp={pdp:.0f}fJ"))
    saved = 1 - records["plan"]["pdp_fj"] / records["uniform"]["pdp_fj"]
    print(f"energy saved by plan: {100 * saved:.1f}% "
          f"(dPSNR {records['plan']['psnr_db'] - records['uniform']['psnr_db']:+.2f} dB)")

    if json_path:
        payload = {"workload": "edge", "images": "6x64x64",
                   "baseline_spec": BASELINE, "plan_source": source,
                   "backend": device.type,
                   "card": card_name() if device.type == "cuda" else None,
                   "search": search, "energy_saved_frac": saved,
                   **records}
        pathlib.Path(json_path).write_text(
            json.dumps(payload, indent=1) + "\n")
        print(f"[bench autotune] wrote {json_path}")
    return rows


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="plan JSON or plan-bundle dir to evaluate "
                         "(default: run the greedy search first)")
    ap.add_argument("--json", default=str(DEFAULT_JSON), dest="json_path",
                    help="output path for BENCH_torch_autotune.json "
                         "('' disables)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the "
                         "kernels' plain versions)")
    args = ap.parse_args()
    run(plan=args.plan, json_path=args.json_path or None, device=args.device)
