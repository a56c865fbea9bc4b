"""Count the dry-run parity harness's cells with the port alone.

``tests/test_torch_dryrun_parity.py`` holds these cells (narrow widths,
one repeating unit, batch 8 × 64 on a 4 × 2 mesh) to ``repro``'s compiled
step on the CPU, where JAX runs. This script counts the same cells with
the port only (the harness's port side), on an 8-rank fake world, so that the counts can be read
under another torch release (the GPU machine's) and set beside the CPU's:
``DTensor``'s sharding rules differ between releases.

Usage::

  PYTHONPATH=src python tools/dryrun_cells.py [--out counts.json] [CELL ...]
"""
from __future__ import annotations

import argparse
import json
import logging
import time

import torch

from repro_torch.launch import dryrun
from repro_torch.launch import mesh as ml
from repro_torch.models import registry as reg

#: the harness's families (tests/test_torch_dryrun_parity.py FAMILIES)
FAMILIES = {
    "dense": ("minitron-8b", dict(n_layers=1, d_model=128, d_ff=256,
                                  vocab=512, n_heads=4, n_kv_heads=2)),
    "moe": ("llama4-maverick-400b-a17b", dict(
        n_layers=2, d_model=128, d_ff=128, vocab=512, n_heads=4,
        n_kv_heads=2, n_experts=16)),
    "xlstm": ("xlstm-125m", dict(n_layers=2, d_model=128, n_heads=4,
                                 n_kv_heads=4, vocab=512)),
    "zamba": ("zamba2-1.2b", dict(n_layers=2, d_model=128, d_ff=256,
                                  n_heads=4, n_kv_heads=4, vocab=512,
                                  ssm_state=16, shared_attn_every=2)),
    "encdec": ("whisper-large-v3", dict(n_layers=1, n_encoder_layers=1,
                                        d_model=128, d_ff=256, n_heads=4,
                                        n_kv_heads=4, vocab=512, n_frames=64)),
    "vlm": ("paligemma-3b", dict(n_layers=1, d_model=128, d_ff=256,
                                 vocab=512, n_heads=4, n_kv_heads=1,
                                 head_dim=32, n_patches=16)),
}
#: batch 8 × 64 positions, chunks of 64
BATCH, SEQ, CHUNK = 8, 64, 64
#: a cell is "kind:family[:variant]"; the variants: every parameter,
#: cache and activation float32, or one sequence of 256 positions (a
#: cache split along its positions, as long_500k's)
VARIANTS = {"f32": dict(f32=True), "long": dict(batch=1, seq=256)}
CELLS = ([f"train:{f}" for f in FAMILIES]
         + [f"{k}:{f}" for f in ("dense", "moe")
            for k in ("prefill", "decode")]
         + [f"decode:{f}:f32" for f in ("dense", "moe")]
         + ["decode:dense:long"])


def cell_spec(cell: str):
    """(kind, family, float32, batch, positions) of a cell."""
    kind, fam, *variant = cell.split(":")
    v = dict(dict(f32=False, batch=BATCH, seq=SEQ), **(
        VARIANTS[variant[0]] if variant else {}))
    return kind, fam, v["f32"], v["batch"], v["seq"]


def count(cell: str) -> dict:
    """Rank 0's counts of ``cell`` on a 4 × 2 mesh of an 8-rank fake world,
    and its flops on one ``meta`` device."""
    kind, fam, f32, batch, seq = cell_spec(cell)
    arch, over = FAMILIES[fam]
    cfg = reg.get_config(arch, attn_chunk=CHUNK, loss_chunk=CHUNK, **over,
                         **({"dtype": torch.float32} if f32 else {}))
    shape = reg.ShapeSpec("cell", kind, seq, batch)
    t0 = time.perf_counter()
    logging.disable(logging.WARNING)    # DTensor's notes on its own plans
    try:
        with dryrun.fake_world(8):
            c = dryrun.count_step(cfg, shape, ml.make_debug_mesh()).counts
        one = dryrun.count_step(cfg, shape, device="meta").counts
    finally:
        logging.disable(logging.NOTSET)
    return dict(cell=cell, torch=torch.__version__, flops=c["flops"],
                one_device_flops=one["flops"], bytes=c["bytes"],
                collective_bytes=c["coll_by"],
                collective_elements=c["coll_elems"], temp=c["temp"],
                seconds=round(time.perf_counter() - t0, 1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="*", default=CELLS)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    rows = []
    for cell in args.cells:
        try:
            rows.append(count(cell))
        except Exception as e:  # noqa: BLE001 — record it, count the rest
            rows.append(dict(cell=cell, torch=torch.__version__,
                             error=f"{type(e).__name__}: {e}"[:500]))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
