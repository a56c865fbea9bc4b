"""Benchmark harness of the PyTorch port — one module per paper table/figure.

The counterpart of ``benchmarks/run.py``, every bench on ``--device`` (the
card unless ``--device cpu``; no card raises before any bench runs).
Prints a ``name,us_per_call,derived`` CSV at the end (plus human-readable
tables as it goes). ``python -m benchmarks.torch_run [--only table4]
[--substrates exact,approx_cuda] [--plan PATH] [--device cpu]`` — the
substrate-sweep benches (fig9, kernel, serve_edge) default to their own
sets (every registered substrate, the ``approx_pallas`` alias once as
``approx_cuda``; serve_edge the reference's four and ``approx_cuda``).
``--sharded`` adds the kernel bench's sharded ``dot_general`` rows over
the ``("data", "model")`` mesh of the ranks ``torchrun`` starts (a world
of one without it; ``--backend gloo``, the default: ``nccl`` is refused
until a machine with a card a rank has run it): the other ranks take part in
those rows only, and rank 0 alone prints and writes.

Machine-readable artifacts: the ``kernel`` bench writes
``BENCH_torch_kernels.json``, the ``serve_edge`` bench
``BENCH_torch_serving.json``, the ``autotune`` bench
``BENCH_torch_autotune.json`` and the ``qat`` bench
``BENCH_torch_qat.json``, at the repo root unless ``--json-dir DIR`` puts
them in ``DIR``; the reference's ``BENCH_*.json`` are never written. A
bench that fails stops the run with its error (the reference runs the rest
and exits 1): no bench carries on past a kernel that did not build or
launch.
"""
from __future__ import annotations

import argparse
import pathlib

import torch.distributed as dist

from benchmarks import (
    torch_autotune_plan,
    torch_edge_serving,
    torch_fig9_edge,
    torch_fig10_tradeoff,
    torch_kernelbench,
    torch_qat_recovery,
    torch_table2_compressors,
    torch_table3_compressor4,
    torch_table4_errors,
    torch_table5_hardware,
)
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib

MODULES = {
    "table2": torch_table2_compressors,
    "table3": torch_table3_compressor4,
    "table4": torch_table4_errors,
    "table5": torch_table5_hardware,
    "fig9": torch_fig9_edge,
    "fig10": torch_fig10_tradeoff,
    "kernel": torch_kernelbench,
    "serve_edge": torch_edge_serving,
    "autotune": torch_autotune_plan,
    "qat": torch_qat_recovery,
}

# benches that sweep the ProductSubstrate registry (accept substrates=[...])
_SUBSTRATE_SWEEPS = ("fig9", "kernel", "serve_edge")
# benches that write a JSON artifact (json_path=...)
_JSON_BENCHES = ("kernel", "serve_edge", "autotune", "qat")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, choices=list(MODULES))
    ap.add_argument("--substrates", default=None,
                    help="CSV of substrate specs for the sweep benches "
                         "(default: each bench's own set)")
    ap.add_argument("--sharded", action="store_true",
                    help="add the kernel bench's sharded dot_general rows "
                         "(debug mesh of the ranks torchrun starts)")
    ap.add_argument("--backend", choices=mesh_lib.BACKENDS, default="gloo",
                    help="process-group backend under --sharded")
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="substrate-plan JSON or bundle dir for the "
                         "autotune bench (default: greedy search)")
    ap.add_argument("--json-dir", default=None, metavar="DIR",
                    help="write the benches' BENCH_torch_*.json into DIR "
                         "(default: the repo root)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    owns_group = args.sharded and not dist.is_initialized()
    if args.sharded:
        mesh_lib.init_ranks(args.backend)
    leader = not args.sharded or dist.get_rank() == 0
    substrates = args.substrates.split(",") if args.substrates else None
    json_dir = pathlib.Path(args.json_dir) if args.json_dir else None
    if json_dir is not None:
        json_dir.mkdir(parents=True, exist_ok=True)

    rows = []
    for name, mod in MODULES.items():
        if args.only and name != args.only:
            continue
        if not leader and name != "kernel":
            continue
        kwargs = {"device": device}
        if name == "kernel":
            kwargs.update(sharded=args.sharded, backend=args.backend)
        if name in _SUBSTRATE_SWEEPS:
            kwargs["substrates"] = substrates
        if name == "autotune":
            kwargs["plan"] = args.plan
        if name in _JSON_BENCHES and json_dir is not None:
            kwargs["json_path"] = json_dir / mod.DEFAULT_JSON.name
        rows.extend(mod.run(**kwargs))
    if owns_group:
        dist.destroy_process_group()
    if not leader:
        return rows

    print("\nname,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return rows


if __name__ == "__main__":
    main()
