"""Perf hillclimbing driver over the dry run's counted roofline.

Counterpart of ``repro.launch.hillclimb``. For a chosen (arch × shape)
cell, counts named :data:`VARIANTS` — config knobs and/or logical-axis
rule overrides (``repro_torch.models.sharding.set_rules``) — through
:func:`repro_torch.launch.rooffix.corrected_cell` on the 16 × 16 mesh of a
256-rank fake world, and reports each variant's roofline terms::

  python -m repro_torch.launch.hillclimb --arch kimi-k2-1t-a32b \\
      --shape train_4k --variants base,remat_off --out results_hillclimb.json

``repro`` steers two knobs through the environment (``REPRO_NO_FSDP``,
``REPRO_CACHE_SHARD``) and forces 512 host devices before JAX starts; here
they are the ``fsdp`` and ``cache_shard`` arguments of the sharding rules
and the world is formed per cell, so importing this module or running a
variant touches no process-wide setting beyond the rules table, which is
restored after each variant.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.launch import roofline
from repro_torch.launch.rooffix import corrected_cell
from repro_torch.models import registry as reg
from repro_torch.models import sharding as sh

# variant -> (config overrides, logical-rule overrides); the keys "fsdp" and
# "cache_shard" are the sharding rules' arguments, not config fields
VARIANTS = {
    "base": ({}, {}),
    # activation-checkpoint policy: no remat (recompute flops vanish; peak
    # memory grows)
    "remat_off": ({"remat": False}, {}),
    # attention KV-chunk sizing: fewer, larger chunks
    "attn_chunk_4096": ({"attn_chunk": 4096}, {}),
    "attn_chunk_8192": ({"attn_chunk": 8192}, {}),
    # chunked-loss tile
    "loss_chunk_4096": ({"loss_chunk": 4096}, {}),
    # sequence parallelism: shard activation seq dim over the model axis
    "seq_shard": ({}, {"seq": "model"}),
    # expert capacity
    "moe_cap_1.0": ({"capacity_factor": 1.0}, {}),
    "moe_cap_2.0": ({"capacity_factor": 2.0}, {}),
    # embedding replicated (kills the vocab all-gather at the loss, pays
    # memory) — collective-term experiment
    "emb_replicated": ({}, {"vocab": None}),
    # decode: shard KV heads over model only (no seq shard of the cache)
    "kv_headshard": ({"cache_shard": "heads"}, {}),
    # long-decode base: 8192-wide chunks
    "long_base": ({"attn_chunk": 8192}, {}),
    "long_kvhead": ({"attn_chunk": 8192, "cache_shard": "heads"}, {}),
    # decode: TP-only weights (resident; no per-step FSDP gathers)
    "long_tponly": ({"attn_chunk": 8192, "fsdp": False}, {}),
    # decode: head-sharded KV cache (no seq shard -> no cache permutes)
    "long_heads": ({"attn_chunk": 8192, "cache_shard": "heads"}, {}),
    "attn_chunk_1024c": ({"attn_chunk": 1024}, {}),
    "attn_chunk_1024": ({"attn_chunk": 1024}, {}),
    # smaller chunks: the SSD intra-chunk quadratic work/memory is LINEAR
    # in the chunk size (B·S·c·H) — shrink it
    "attn_chunk_256": ({"attn_chunk": 256}, {}),
    "attn_chunk_128": ({"attn_chunk": 128}, {}),
    # paper's technique at scale: int8 matmuls + separable error correction
    "approx_stat": ({"dot_plan": "approx_stat"}, {}),
}


def corrected_with(arch: str, shape_name: str, overrides: dict, rules: dict):
    """Corrected per-device counts under a variant's settings."""
    overrides = dict(overrides)
    kw = {k: overrides.pop(k) for k in ("fsdp", "cache_shard")
          if k in overrides}
    dot_mode = overrides.pop("dot_plan", "exact")
    merged_rules = dict(sh.DEFAULT_RULES)
    merged_rules.update(rules)
    sh.set_rules(merged_rules)
    try:
        return corrected_cell(arch, shape_name, dot_mode, **kw, **overrides)
    finally:
        sh.set_rules(None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(reg.SHAPES))
    ap.add_argument("--variants", default="base")
    ap.add_argument("--out", default="results_hillclimb.json")
    args = ap.parse_args(argv)

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["variant"]) for r in results if r.get("ok")}

    cfg = reg.get_config(args.arch)
    shape = reg.SHAPES[args.shape]
    for v in args.variants.split(","):
        if (args.arch, args.shape, v) in done:
            print(f"[skip] {v}")
            continue
        overrides, rules = VARIANTS[v]
        print(f"[hillclimb] {args.arch} × {args.shape} × {v} ...", flush=True)
        t0 = time.time()
        try:
            m = corrected_with(args.arch, args.shape, overrides, rules)
            rf = roofline.Roofline(
                flops_per_device=m["flops"], bytes_per_device=m["bytes"],
                collective_bytes=m["coll"], n_devices=256,
                model_flops=roofline.model_flops_for(cfg, shape),
            )
            r = dict(arch=args.arch, shape=args.shape, variant=v, ok=True,
                     flops_per_device=m["flops"], bytes_per_device=m["bytes"],
                     collective_bytes=m["coll"], secs=round(time.time() - t0, 1),
                     **rf.row())
            print(f"  ok: comp={rf.t_compute:.3f}s mem={rf.t_memory:.3f}s "
                  f"coll={rf.t_collective:.3f}s bneck={rf.bottleneck} "
                  f"rooffrac={rf.roofline_fraction:.4f}", flush=True)
        except Exception as e:  # noqa: BLE001 — record failures, keep going
            r = dict(arch=args.arch, shape=args.shape, variant=v, ok=False,
                     error=f"{type(e).__name__}: {e}"[:2000],
                     traceback=traceback.format_exc()[-1500:])
            print(f"  FAIL: {r['error'][:300]}", flush=True)
        results.append(r)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    return results


if __name__ == "__main__":
    main()
