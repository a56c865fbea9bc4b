"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Counterpart of ``repro.launch.serve`` for every family (lm with its MoE
configs, vlm, encdec, and the recurrent xlstm and zamba): builds the config
(reduced with the ``--n-layers`` ... ``--n-experts`` ... ``--dot-plan``
overrides), draws
random parameters from a seeded ``torch.Generator`` on ``--device``
(``cuda`` unless ``--device cpu`` is given; no card raises), and serves
synthetic requests through :class:`~repro_torch.serving.ServingEngine`:

    python -m repro_torch.launch.serve --arch minitron-8b --n-layers 2 \\
        --requests 16 --batch 8 --workers 2
    python -m repro_torch.launch.serve --arch llama4-maverick-400b-a17b \\
        --n-layers 2
    python -m repro_torch.launch.serve --arch zamba2-1.2b --batch 8
    python -m repro_torch.launch.serve --arch minitron-8b --device cpu \\
        --n-layers 2 --d-model 32 --d-ff 64 --vocab 64 --n-heads 2 \\
        --n-kv-heads 2 --requests 3 --plan plan.json

``--plan`` takes a plan JSON file or a plan-bundle directory (as
``repro_torch.launch.train --qat-out`` writes it); a bundle that carries
params restores them into the model through ``bundle.layout``
(``repro``'s tree of the config's family). ``--metrics-out``
dumps the engine's metrics registry (Prometheus text for ``.prom``/``.txt``
paths, JSON otherwise) and ``--trace-out`` writes a Chrome/Perfetto trace of
the serving spans.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import load_plan_bundle, unflatten_into
from repro_torch.launch.train import (add_reduced_overrides, overrides_from,
                                      resolve_device)
from repro_torch.models import convert
from repro_torch.models import registry as reg
from repro_torch.nn import plan as plan_mod
from repro_torch.obs import Tracer, tracing_scope, write_chrome_trace, write_metrics
from repro_torch.serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=reg.list_archs())
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--workers", type=int, default=1,
                    help="concurrent decode loops (each with its own decode "
                         "state and CUDA stream; requests split round-robin)")
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="substrate plan: a plan JSON file or a plan-bundle "
                         "directory (see docs/plans.md). Serves the model "
                         "with per-site mixed substrates; a bundle that "
                         "carries params restores them too.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the "
                         "kernels' plain versions)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump serving metrics (.prom/.txt → Prometheus "
                         "text, else JSON)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace-event JSON of the "
                         "serving spans")
    add_reduced_overrides(ap)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reg.get_config(args.arch, **overrides_from(args))
    bundle = reg.build_bundle(cfg)
    params = bundle.init_params(
        torch.Generator(device=device).manual_seed(0), device)
    plan = None
    if args.plan:
        if os.path.isdir(args.plan):
            plan, flat, _ = load_plan_bundle(args.plan, device=device)
            if flat is not None:  # the bundle ships params: restore them
                template = bundle.layout.to_tree(
                    {k: t.to("meta") for k, t in
                     convert.named_leaves(params).items()})
                convert.assign_(params, bundle.layout.from_tree(
                    unflatten_into(template, flat, device)))
        else:
            plan = plan_mod.load_plan(args.plan)
        print(f"[serve] substrate plan: {plan.label}")
    engine = ServingEngine(bundle, params, batch_size=args.batch,
                           max_len=args.max_len, substrate=plan, device=device)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=list(rng.integers(1, cfg.vocab, size=4)),
                    max_tokens=args.max_tokens,
                    temperature=0.0 if i % 2 == 0 else 0.8)
            for i in range(args.requests)]
    tracer = Tracer() if args.trace_out else None
    t0 = time.perf_counter()
    with tracing_scope(tracer):
        out = engine.generate(reqs, workers=args.workers)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in out)
    for i, r in enumerate(out):
        print(f"req{i}: prompt={[int(t) for t in r.prompt]} -> {r.output}")
    print(f"[serve] {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / max(dt, 1e-9):.1f} tok/s) on {device}")
    if args.metrics_out:
        p = write_metrics(engine.metrics.registry, args.metrics_out)
        print(f"[serve] metrics -> {p}")
    if args.trace_out:
        p = write_chrome_trace(tracer, args.trace_out)
        print(f"[serve] trace -> {p} ({len(tracer.events())} events)")
    return out


if __name__ == "__main__":
    main()
