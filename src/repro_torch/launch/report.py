"""Render the dry-run / roofline / hillclimb markdown tables from their
results JSONs.

Counterpart of ``repro.launch.report``, reading the same rows. The port's
dry-run rows carry ``step_s`` (the counted step's seconds) where
``repro``'s carry ``compile_s``; the column shows whichever the row has.
"""
from __future__ import annotations

import argparse
import json


def _rows(path):
    with open(path) as f:
        return [x for x in json.load(f) if x.get("ok")]


def roofline_table(path="results_roofline.json"):
    out = ["| arch | shape | t_compute s | t_memory s | t_collective s | "
           "bottleneck | useful | roofline frac |",
           "|---|---|---|---|---|---|---|---|"]
    for x in sorted(_rows(path), key=lambda x: (x["arch"], x["shape"])):
        out.append(
            f"| {x['arch']} | {x['shape']} | {x['t_compute']:.3g} | "
            f"{x['t_memory']:.3g} | {x['t_collective']:.3g} | "
            f"{x['bottleneck']} | {x['useful_ratio']:.3f} | "
            f"{x['roofline_fraction']:.4f} |")
    return "\n".join(out)


def dryrun_table(path="results_dryrun.json"):
    out = ["| arch | shape | mesh | HBM args GB/dev | HBM temp GB/dev | "
           "collectives (counts) | step s |",
           "|---|---|---|---|---|---|---|"]
    for x in sorted(_rows(path), key=lambda x: (x["arch"], x["shape"], x["mesh"])):
        mem = x.get("memory", {})
        args = (mem.get("argument_size_in_bytes") or 0) / 2**30
        temp = (mem.get("temp_size_in_bytes") or 0) / 2**30
        counts = x.get("collective_counts", {})
        cstr = " ".join(f"{k.split('-')[-1]}:{v}" for k, v in counts.items() if v)
        secs = x.get("step_s", x.get("compile_s"))
        out.append(f"| {x['arch']} | {x['shape']} | {x['mesh']} | "
                   f"{args:.2f} | {temp:.2f} | {cstr} | {secs} |")
    return "\n".join(out)


def hillclimb_table(path="results_hillclimb.json"):
    out = ["| cell | variant | t_compute s | t_memory s | t_collective s | "
           "bottleneck | roofline frac |",
           "|---|---|---|---|---|---|---|"]
    for x in _rows(path):
        out.append(f"| {x['arch']}×{x['shape']} | {x['variant']} | "
                   f"{x['t_compute']:.3g} | {x['t_memory']:.3g} | "
                   f"{x['t_collective']:.3g} | {x['bottleneck']} | "
                   f"{x['roofline_fraction']:.4f} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--which", choices=["roofline", "dryrun", "hillclimb"],
                    required=True)
    ap.add_argument("--path", default=None,
                    help="results JSON (default: results_<which>.json)")
    args = ap.parse_args(argv)
    fn = {"roofline": roofline_table, "dryrun": dryrun_table,
          "hillclimb": hillclimb_table}[args.which]
    print(fn(args.path) if args.path else fn())


if __name__ == "__main__":
    main()
