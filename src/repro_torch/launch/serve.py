"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Counterpart of ``repro.launch.serve``: builds the config (reduced with the
``--n-layers`` ... ``--dot-plan`` overrides), draws random parameters from a
seeded ``torch.Generator`` on ``--device`` (``cuda`` unless ``--device cpu``
is given; no card raises), and serves synthetic requests through
:class:`~repro_torch.serving.ServingEngine`:

    python -m repro_torch.launch.serve --arch minitron-8b --n-layers 2 \\
        --requests 16 --batch 8 --workers 2
    python -m repro_torch.launch.serve --arch minitron-8b --device cpu \\
        --n-layers 2 --d-model 32 --d-ff 64 --vocab 64 --n-heads 2 \\
        --n-kv-heads 2 --requests 3 --plan plan.json

``--plan`` takes a plan JSON file (a plan-bundle directory raises until the
checkpoint module is ported, ROADMAP.md queue 1 item 8). ``--metrics-out``
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

from repro_torch.models import registry as reg
from repro_torch.nn import plan as plan_mod
from repro_torch.obs import Tracer, tracing_scope, write_chrome_trace, write_metrics
from repro_torch.serving import Request, ServingEngine


# Private copies of repro.launch.train's parse_plan_arg, add_reduced_overrides
# and overrides_from, until the training launcher is ported (queue 1 item 10).
def _parse_plan_arg(arg: str) -> plan_mod.SubstratePlan:
    """CLI plan argument: a spec string, inline plan JSON, or a JSON path."""
    arg = arg.strip()
    if arg.startswith("{"):
        return plan_mod.SubstratePlan.from_json(arg)
    if arg.endswith(".json"):
        return plan_mod.load_plan(arg)
    return plan_mod.as_plan(arg)


def _add_reduced_overrides(ap: argparse.ArgumentParser):
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--d-ff", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--n-heads", type=int, default=None)
    ap.add_argument("--n-kv-heads", type=int, default=None)
    ap.add_argument("--dot-mode", default=None,
                    help="uniform substrate spec, e.g. 'exact', 'int8', or "
                         "'approx_cuda:proposed@6' (any registered "
                         "backend:mult@width)")
    ap.add_argument("--dot-plan", default=None,
                    help="site-addressed substrate plan: a spec string, "
                         "inline plan JSON, or path to a plan .json")


def _overrides_from(args) -> dict:
    keys = {"n_layers": args.n_layers, "d_model": args.d_model,
            "d_ff": args.d_ff, "vocab": args.vocab, "n_heads": args.n_heads,
            "n_kv_heads": args.n_kv_heads}
    out = {k: v for k, v in keys.items() if v is not None}
    # --dot-plan (site-addressed) wins over --dot-mode (uniform shorthand);
    # both land in cfg.dot_plan
    if args.dot_plan:
        out["dot_plan"] = _parse_plan_arg(args.dot_plan)
    elif args.dot_mode:
        out["dot_plan"] = plan_mod.SubstratePlan.uniform(
            plan_mod._check_spec(args.dot_mode))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=reg.list_archs())
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--workers", type=int, default=1,
                    help="concurrent decode loops (each with its own KV "
                         "caches and CUDA stream; requests split round-robin)")
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="substrate plan JSON file (see docs/plans.md); "
                         "serves the model with per-site mixed substrates")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the "
                         "kernels' plain versions)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump serving metrics (.prom/.txt → Prometheus "
                         "text, else JSON)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace-event JSON of the "
                         "serving spans")
    _add_reduced_overrides(ap)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the plain versions")
    plan = None
    if args.plan:
        if os.path.isdir(args.plan):
            raise NotImplementedError(
                "plan bundles (directories) need the checkpoint module, not "
                "ported yet (ROADMAP.md, queue 1 item 8); pass a plan JSON")
        plan = plan_mod.load_plan(args.plan)
        print(f"[serve] substrate plan: {plan.label}")
    cfg = reg.get_config(args.arch, **_overrides_from(args))
    bundle = reg.build_bundle(cfg)
    params = bundle.init_params(
        torch.Generator(device=device).manual_seed(0), device)
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
