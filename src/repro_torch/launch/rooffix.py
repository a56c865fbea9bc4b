"""Layer-differenced roofline: a cell's counts from one repeating unit.

Counterpart of ``repro.launch.rooffix``. ``repro`` needs it because XLA's
``cost_analysis`` counts a ``while``-loop body once whatever its trip
count: it lowers each cell at L0 = 0 layers (embedding and loss only) and
L1 = one unit (the layer pattern's period) with the scans unrolled and
takes

  corrected(metric) = m(L0) + (n_layers / period) · (m(L1) − m(L0)).

The port counts eagerly, so every iteration of every loop is counted and
the full-depth dry run is exact already. Here the difference is the fast
path: two shallow steps in place of the full depth. The flops grow by
the same amount with every unit from L0 on, but the first unit (fed by the
embedding) moves other bytes and collectives than a later one (on the test
configs of ``tests/test_torch_dryrun.py``, a few hundred bytes to tens of
kB). From two units on every unit adds the same, so the unit is
differenced between L2 and L3 = two and three units,

  corrected(metric) = m(L2) + (n_layers / period − 2) · (m(L3) − m(L2)),

which equals the full-depth count wherever ``n_layers`` is a whole number
of units (``tests/test_torch_dryrun.py`` holds the two equal). xlstm and
zamba run whole, as in ``repro``, and so does a model of fewer than four
units. The argument bytes are differenced
the same way. The temp bytes are a peak, not a sum; the same
difference gives what each unit adds to it (the activations a layer saves
for its backward). That is exact where the peak falls at the same place
in the step at every depth, as on the test configs, and otherwise an
estimate.

Usage::

  python -m repro_torch.launch.rooffix --raw results_dryrun.json \\
      --out results_roofline.json      # the dry run's 16 x 16 cells
  python -m repro_torch.launch.rooffix --all --both-meshes \\
      [--only-arch A] --out results_roofline.json   # every cell, counted here
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline
from repro_torch.models import lm
from repro_torch.models import registry as reg

COST_ATTN_CHUNK = 2048
COST_LOSS_CHUNK = 2048
_LINEAR = ("flops", "bytes", "coll", "argument")


def _metrics_for(cfg, shape, mesh, **kw) -> dict:
    """Count one config at one shape on ``mesh``: flops, bytes, collective
    bytes (and by kind), temp and argument bytes of rank 0."""
    cell = dryrun.count_step(cfg, shape, mesh, **kw)
    c = cell.counts
    return {"flops": c["flops"], "bytes": c["bytes"], "coll": c["coll"],
            "coll_by": dict(c["coll_by"]),
            "coll_counts": dict(c["coll_counts"]), "temp": c["temp"],
            "argument": float(cell.argument_bytes)}


def corrected_cell(arch: str, shape_name: str, dot_mode: str = "exact", *,
                   multi_pod: bool = False, fsdp: bool = True,
                   cache_shard: str = "auto", accum: int = 1,
                   **overrides) -> dict:
    """A cell's per-device counts on the production mesh, from L2 and L3
    (or the whole model for xlstm / zamba and below four units). ``overrides`` reach the
    config (``attn_chunk`` and ``loss_chunk`` default to 2048, ``repro``'s
    cost chunks). The train step is the whole batch's (``accum`` 1), as
    ``repro`` corrects it: :func:`repro_torch.launch.dryrun.lower_cell`
    microbatches. ``shape_name`` may also be a ``ShapeSpec`` of its own."""
    shape = (reg.SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    overrides = dict(overrides)
    overrides.setdefault("attn_chunk", COST_ATTN_CHUNK)
    overrides.setdefault("loss_chunk", COST_LOSS_CHUNK)
    base_cfg = reg.get_config(arch, dot_plan=dot_mode, **overrides)
    with dryrun._world(512 if multi_pod else 256):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        kw = dict(fsdp=fsdp, cache_shard=cache_shard, accum=accum)
        params = sum(p.numel() for p in reg.param_specs(
            reg.build_bundle(base_cfg)).parameters())
        if base_cfg.family in ("xlstm", "zamba"):
            out = _metrics_for(base_cfg, shape, mesh, **kw)
            out.update(method="full", params=params, accum=accum)
            return out
        period = lm.unit_period(base_cfg)
        if base_cfg.n_layers < 4 * period:    # as cheap to count whole
            out = _metrics_for(base_cfg, shape, mesh, **kw)
            out.update(method="full", params=params, accum=accum)
            return out
        m = []
        for units in (2, 3):
            over = {"n_layers": units * period}
            if base_cfg.family == "encdec":
                over["n_encoder_layers"] = units
            m.append(_metrics_for(reg.get_config(
                arch, dot_plan=dot_mode, **dict(overrides, **over)), shape,
                mesh, **kw))
    m2, m3 = m
    more = base_cfg.n_layers / period - 2
    out = {k: m2[k] + more * (m3[k] - m2[k]) for k in _LINEAR + ("temp",)}
    out["coll_by"] = {k: m2["coll_by"][k] + more * (m3["coll_by"][k]
                                                    - m2["coll_by"][k])
                      for k in m2["coll_by"]}
    out["coll_counts"] = {k: round(m2["coll_counts"][k] + more * (
        m3["coll_counts"][k] - m2["coll_counts"][k])) for k in m2["coll_counts"]}
    out["method"] = f"L2+{more:g}x(L3-L2), period={period}"
    out.update(params=params, accum=accum)
    return out


def row(arch: str, shape_name: str, corr: dict, n_devices: int) -> dict:
    """``repro``'s roofline row of a corrected cell."""
    cfg = reg.get_config(arch)
    n_active = corr["params"] - (cfg.param_count() - cfg.active_param_count())
    rf = roofline.Roofline(
        flops_per_device=corr["flops"], bytes_per_device=corr["bytes"],
        collective_bytes=corr["coll"], n_devices=n_devices,
        model_flops=roofline.model_flops_for(cfg, reg.SHAPES[shape_name],
                                             n_active=n_active))
    return dict(arch=arch, shape=shape_name, n_devices=n_devices,
                active_params=n_active, flops_per_device=corr["flops"],
                bytes_per_device=corr["bytes"],
                collective_bytes=corr["coll"],
                collective_breakdown=corr["coll_by"],
                correction=corr["method"], **rf.row())


def sweep_row(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """One cell of the sweep from :func:`corrected_cell`: ``repro``'s
    roofline row with the dry run's mesh, ``memory`` (rank 0's argument
    and temp bytes) and collective counts, ``step_s`` the seconds of its
    counted steps."""
    t0 = time.time()
    n = 512 if multi_pod else 256
    corr = corrected_cell(arch, shape_name, multi_pod=multi_pod)
    return dict(row(arch, shape_name, corr, n),
                mesh="2x16x16" if multi_pod else "16x16",
                memory=dict(argument_size_in_bytes=corr["argument"],
                            temp_size_in_bytes=corr["temp"]),
                collective_counts=corr["coll_counts"],
                step_s=round(time.time() - t0, 1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--raw", default="results_dryrun.json")
    ap.add_argument("--out", default="results_roofline.json")
    ap.add_argument("--only-arch", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape) of the dry run's sweep, "
                         "counted here from L2 and L3 (no --raw file)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = (dryrun.all_cells(False) + dryrun.all_cells(True)
                 if args.both_meshes else dryrun.all_cells(args.multi_pod))
        cells = [c for c in cells
                 if not args.only_arch or c[0] == args.only_arch]
        results = dryrun.run_cells(
            cells, args.out,
            lower=lambda arch, shape, multi_pod, **_: sweep_row(arch, shape,
                                                                multi_pod))
        print(f"\n{sum(1 for r in results if r.get('ok'))}/{len(results)} "
              "cells counted")
        return results

    with open(args.raw) as f:
        raw = [r for r in json.load(f) if r.get("ok") and r["mesh"] == "16x16"]
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"]) for r in results if r.get("ok")}

    for cell in raw:
        arch, shape_name = cell["arch"], cell["shape"]
        if args.only_arch and arch != args.only_arch:
            continue
        if (arch, shape_name) in done:
            continue
        print(f"[rooffix] {arch} × {shape_name} ...", flush=True)
        t0 = time.time()
        try:
            corr = corrected_cell(arch, shape_name,
                                  dot_mode=cell.get("dot_mode", "exact"))
            merged = dict(cell)
            merged.update(row(arch, shape_name, corr, cell["n_devices"]))
            merged.update(fix_s=round(time.time() - t0, 1), ok=True)
            print(f"  ok ({merged['fix_s']}s): bottleneck={merged['bottleneck']} "
                  f"useful={merged['useful_ratio']:.3f} "
                  f"rooffrac={merged['roofline_fraction']:.4f}", flush=True)
        except Exception as e:  # noqa: BLE001 — record failures, keep going
            merged = dict(arch=arch, shape=shape_name, ok=False,
                          error=f"{type(e).__name__}: {e}"[:2000],
                          traceback=traceback.format_exc()[-1500:])
            print(f"  FAIL: {merged['error'][:300]}", flush=True)
        results.append(merged)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    ok = sum(1 for r in results if r.get("ok"))
    print(f"\n{ok}/{len(results)} corrected")
    return results


if __name__ == "__main__":
    main()
