"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Counterpart of ``repro.launch.train``: config (reduced with the
``--n-layers`` ... ``--dot-plan`` overrides) → model bundle → optimizer
(Adafactor on ``repro``'s stacked tree for MoE configs, AdamW for the rest,
as ``repro`` chooses) → :class:`~repro_torch.train.TrainLoop` over the
synthetic LM stream, with
checkpoint/restart in ``--ckpt-dir``, QAT (``--qat``, ``--qat-forward``,
``--qat-moment``) and a final plan bundle (``--qat-out DIR``, which
``python -m repro_torch.launch.serve --plan DIR`` serves). Random weights
come from a seeded ``torch.Generator`` on ``--device``: ``cuda`` unless
``--device cpu`` is given, and no card raises::

    python -m repro_torch.launch.train --arch minitron-8b --n-layers 4 \\
        --batch 8 --seq-len 32 --steps 3 --qat --dot-mode approx_cuda:proposed@8
    python -m repro_torch.launch.train --arch minitron-8b --device cpu \\
        --n-layers 2 --d-model 32 --d-ff 64 --vocab 64 --n-heads 2 \\
        --n-kv-heads 2 --batch 4 --seq-len 16 --steps 8 --qat-out bundle

Every family ``repro`` trains trains here: dense, MoE (``--n-experts``
overrides the expert count), vlm, encdec, xlstm and zamba::

    python -m repro_torch.launch.train --arch llama4-maverick-400b-a17b \
        --device cpu --n-layers 4 --d-model 64 --d-ff 128 --vocab 512 \
        --n-heads 4 --n-kv-heads 2 --n-experts 4 --batch 2 --seq-len 16 --steps 4
    python -m repro_torch.launch.train --arch zamba2-1.2b --device cpu \
        --n-layers 6 --d-model 64 --d-ff 128 --vocab 512 --n-heads 4 \
        --n-kv-heads 4 --batch 2 --seq-len 16 --steps 4

``--mesh debug`` trains over the ``("data", "model")`` mesh of the ranks
that ``torchrun`` starts (a world of one without it), on the process-group
backend ``--backend`` (``gloo``, the default, runs every rank on one card;
``nccl``, which needs a card a rank, is refused until a machine with more
than one card has run it), as ``repro`` trains under ``with mesh:``::

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --mesh debug --arch llama4-maverick-400b-a17b \
        --n-layers 2 --n-experts 4 --batch 8 --seq-len 32 --steps 3 --qat \
        --dot-mode approx_cuda:proposed@8

Each rank takes its "data" shard of every batch; every gradient is the
mean over the "data" group; an MoE config runs expert-parallel, each rank
holding its E / M experts (``convert.shard_experts``). Rank 0 alone prints
and writes checkpoints and ``--qat-out`` bundles, in ``repro``'s
unsharded on-disk format (the expert shards gathered to it).
``--mesh pod|multipod`` train the same way over the production mesh
(``launch.mesh.make_production_mesh``: 16 × 16, or 2 × 16 × 16 with the
batch over ("pod", "data")), which needs a world of 256 / 512 ranks and
raises its ``ValueError`` in any other; no machine with that many ranks
has run it.
"""
from __future__ import annotations

import argparse
import json
import math

import torch
import torch.distributed as dist

from repro_torch.checkpoint import save_plan_bundle
from repro_torch.data import SyntheticLMStream
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convert
from repro_torch.models import registry as reg
from repro_torch.models import sharding as sh
from repro_torch.nn import collectives as coll
from repro_torch.nn import plan as plan_mod
from repro_torch.optim import adafactor, adamw, warmup_cosine
from repro_torch.train import QATPolicy, TrainLoop, TrainLoopConfig


def parse_plan_arg(arg: str) -> plan_mod.SubstratePlan:
    """CLI plan argument: a spec string, inline plan JSON, or a JSON path."""
    arg = arg.strip()
    if arg.startswith("{"):
        return plan_mod.SubstratePlan.from_json(arg)
    if arg.endswith(".json"):
        return plan_mod.load_plan(arg)
    return plan_mod.as_plan(arg)


def add_reduced_overrides(ap: argparse.ArgumentParser):
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--d-ff", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--n-heads", type=int, default=None)
    ap.add_argument("--n-kv-heads", type=int, default=None)
    ap.add_argument("--n-experts", type=int, default=None)
    ap.add_argument("--dot-mode", default=None,
                    help="uniform substrate spec, e.g. 'exact', 'int8', or "
                         "'approx_cuda:proposed@6' (any registered "
                         "backend:mult@width)")
    ap.add_argument("--dot-plan", default=None,
                    help="site-addressed substrate plan: a spec string, "
                         "inline plan JSON, or path to a plan .json")


def overrides_from(args) -> dict:
    keys = {"n_layers": args.n_layers, "d_model": args.d_model,
            "d_ff": args.d_ff, "vocab": args.vocab, "n_heads": args.n_heads,
            "n_kv_heads": args.n_kv_heads, "n_experts": args.n_experts}
    out = {k: v for k, v in keys.items() if v is not None}
    # --dot-plan (site-addressed) wins over --dot-mode (uniform shorthand);
    # both land in cfg.dot_plan
    if getattr(args, "dot_plan", None):
        out["dot_plan"] = parse_plan_arg(args.dot_plan)
    elif args.dot_mode:
        out["dot_plan"] = plan_mod.SubstratePlan.uniform(
            plan_mod._check_spec(args.dot_mode))
    return out


def main(argv=None):
    """Run the launcher → (the loop, the trained params)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=reg.list_archs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--mesh", choices=["none", "debug", "pod", "multipod"],
                    default="none")
    ap.add_argument("--backend", choices=mesh_lib.BACKENDS, default="gloo",
                    help="process-group backend under --mesh debug|pod|multipod: gloo "
                         "(every rank may share one card); nccl is refused "
                         "(ROADMAP.md, queue 1 item 14)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the "
                         "kernels' plain versions)")
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--qat", action="store_true",
                    help="approximation-aware training: straight-through "
                         "approximate forward on the configured plan")
    ap.add_argument("--qat-forward", choices=["bitexact", "stat"],
                    default="bitexact",
                    help="QAT forward numerics (stat = the separable "
                         "error-moment model, same wiring and width)")
    ap.add_argument("--qat-moment", action="store_true",
                    help="add the error-moment slope correction to the "
                         "straight-through backward")
    ap.add_argument("--qat-out", default="",
                    help="directory for a final plan+params bundle "
                         "(checkpoint.save_plan_bundle)")
    add_reduced_overrides(ap)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    overrides = overrides_from(args)
    cfg = reg.get_config(args.arch, **overrides)
    bundle = reg.build_bundle(cfg)
    mesh, owns_group, shards, shard = None, False, 1, 0
    if args.mesh != "none":
        owns_group = not dist.is_initialized()
        mesh_lib.init_ranks(args.backend)
        try:
            mesh = (mesh_lib.make_debug_mesh() if args.mesh == "debug" else
                    mesh_lib.make_production_mesh(
                        multi_pod=args.mesh == "multipod"))
        except ValueError:
            if owns_group:
                dist.destroy_process_group()
            raise
        device = mesh_lib.rank_device(device.type)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if cfg.n_experts:
            shards = coll.axis_size(mesh, "model")
            shard = coll.axis_index(mesh, "model")
            tokens = args.batch * args.seq_len
            data = math.prod(coll.axis_size(mesh, a) for a in ("pod", "data")
                             if a in coll.axis_names(mesh))
            if cfg.n_experts % shards or tokens % (data * shards):
                raise ValueError(
                    f"expert parallelism over {tuple(mesh.mesh.shape)} ranks "
                    f"needs the {cfg.n_experts} experts and the {tokens} "
                    "tokens of a batch to divide into the shards")
    leader = mesh is None or dist.get_rank() == 0
    # as repro chooses: Adafactor on its stacked tree for the MoE configs
    optimizer = adafactor(bundle.layout) if cfg.n_experts else adamw()
    qat_policy = (QATPolicy(forward=args.qat_forward,
                            moment_correction=args.qat_moment)
                  if args.qat else None)
    loop = TrainLoop(
        bundle.loss_fn, optimizer,
        TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir, lr=args.lr,
                        grad_accum=args.grad_accum, qat=qat_policy,
                        plan=overrides.get("dot_plan")),
        lr_schedule=warmup_cosine(args.lr, max(1, args.steps // 10), args.steps),
        layout=bundle.layout, mesh=mesh)
    stream = SyntheticLMStream(vocab=cfg.vocab, batch=args.batch,
                               seq_len=args.seq_len, seed=0)

    def init():
        params = bundle.init_params(torch.Generator(device).manual_seed(0),
                                    device)
        return (convert.shard_experts(params, shard, shards) if shards > 1
                else params)

    params, opt_state, start = loop.init_or_restore(init)
    # read back from loop.cfg: restore may have adopted the checkpoint's
    # plan/policy, and what the loop runs is what should be reported
    qat_tag = f" qat={loop.cfg.qat.forward}" if loop.cfg.qat is not None else ""
    plan_tag = f" plan={loop.cfg.plan.label}" if loop.cfg.plan is not None else ""
    n_params = sum(t.numel() for t in convert.named_leaves(params).values())
    if mesh is not None and leader:
        print(f"[train] mesh={args.mesh} backend={dist.get_backend()} "
              f"world={dist.get_world_size()} shape={tuple(mesh.mesh.shape)} "
              f"axes={tuple(mesh.mesh_dim_names)} expert_shards={shards}")
    if leader:
        print(f"[train] arch={args.arch} start_step={start}{plan_tag}{qat_tag} "
              f"params={n_params:,} device={device}")
    with sh.mesh_scope(mesh):
        params, opt_state, _ = loop.run(
            params, opt_state, stream, start,
            on_step=lambda s, l: leader and (s % 10 == 0) and print(
                f"  step {s:5d} loss {l:.4f}", flush=True))
    if args.qat_out:
        plan = loop.cfg.plan or plan_mod.SubstratePlan.uniform("exact")
        tree = loop.gather_experts(
            bundle.layout.to_tree(convert.named_leaves(params)))
        if leader:
            path = save_plan_bundle(
                args.qat_out, plan, tree,
                extra={"arch": args.arch,
                       "final_loss": loop.metrics.get("final_loss"),
                       "qat": (loop.cfg.qat.describe()
                               if loop.cfg.qat is not None else None)})
            print(f"[train] wrote plan bundle: {path}")
    if owns_group:
        dist.barrier()
        dist.destroy_process_group()
    if not leader:
        return loop, params

    fl = loop.metrics["final_loss"]
    print(f"[train] done: "
          f"final_loss={'n/a' if fl is None else format(fl, '.4f')} "
          f"stragglers={loop.metrics['straggler_steps']} "
          f"resumed_from={loop.metrics['resumed_from']}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({k: v for k, v in loop.metrics.items() if k != "losses"}
                      | {"losses_head": loop.metrics["losses"][:5],
                         "losses_tail": loop.metrics["losses"][-5:]},
                      f, indent=1)
    return loop, params


if __name__ == "__main__":
    main()
