"""End-to-end driver on the PyTorch port: train a ~100M-param LM for a few
hundred steps with the paper's approximate multiplier as the matmul
execution mode, with checkpointing + resume.

Default is a fast reduced run; pass --full for the ~100M/300-step version.

Run: PYTHONPATH=src python examples/torch_train_lm.py [--full] [--device cpu]

The counterpart of ``examples/train_lm.py``, on ``--device`` (the card
unless ``--device cpu``; no card raises). ``--dot-mode`` sets the config's
uniform substrate plan (the port has no ``ModelConfig.dot_mode``; it maps
to ``dot_plan`` as ``python -m repro_torch.launch.train`` maps it).
Checkpoints go to ``build/torch_train_lm_ckpt`` in the checkout unless
``--ckpt-dir`` says otherwise; running the same command again resumes from
the newest one. The last line printed is a JSON object of the first and
last loss.
"""
import argparse
import json
import pathlib

import torch

from repro_torch.data import SyntheticLMStream
from repro_torch.device import resolve_device
from repro_torch.models import convert
from repro_torch.models import registry as reg
from repro_torch.nn import plan as plan_mod
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import TrainLoop, TrainLoopConfig

DEFAULT_CKPT_DIR = (pathlib.Path(__file__).resolve().parent.parent / "build"
                    / "torch_train_lm_ckpt")
FULL = dict(n_layers=8, d_model=768, d_ff=2048, vocab=32768, n_heads=12,
            n_kv_heads=4, attn_chunk=256, loss_chunk=256)
REDUCED = dict(n_layers=2, d_model=128, d_ff=256, vocab=1024, n_heads=4,
               n_kv_heads=2, attn_chunk=64, loss_chunk=64, remat=False)


def main(argv=None, init_params=None, steps=None) -> TrainLoop:
    """Train (or resume); returns the loop, its losses in
    ``loop.metrics["losses"]``. ``init_params(bundle, device)`` replaces
    the seeded init; ``steps`` cuts the run (300 with ``--full``, else
    60)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params, 300 steps")
    ap.add_argument("--dot-mode", default="exact",
                    choices=["exact", "int8", "approx_stat", "approx_bitexact"])
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.full:
        over, default_steps, batch, seq = FULL, 300, 8, 256
    else:
        over, default_steps, batch, seq = REDUCED, 60, 8, 64
    steps = steps or default_steps

    cfg = reg.get_config("minitron-8b", dot_plan=plan_mod.SubstratePlan.uniform(
        plan_mod._check_spec(args.dot_mode)), **over)
    bundle = reg.build_bundle(cfg)

    loop = TrainLoop(
        bundle.loss_fn, adamw(),
        TrainLoopConfig(total_steps=steps, ckpt_every=max(10, steps // 5),
                        ckpt_dir=args.ckpt_dir, lr=3e-3),
        lr_schedule=warmup_cosine(3e-3, steps // 10, steps),
        layout=bundle.layout,
    )
    stream = SyntheticLMStream(vocab=cfg.vocab, batch=batch, seq_len=seq, seed=0)
    params, opt_state, start = loop.init_or_restore(
        (lambda: init_params(bundle, device)) if init_params is not None else
        (lambda: bundle.init_params(torch.Generator(device).manual_seed(0),
                                    device)))
    n_params = sum(t.numel() for t in convert.named_leaves(params).values())
    print(f"training {n_params:,} params from step {start} "
          f"(dot_plan={bundle.plan.label}, device={device.type}); "
          f"checkpoints -> {args.ckpt_dir}")
    loop.run(params, opt_state, stream, start,
             on_step=lambda s, l: (s % 10 == 0) and print(
                 f"  step {s:4d}  loss {l:.4f}", flush=True))
    losses = loop.metrics["losses"]
    if losses:
        print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"(resume with the same command; delete {args.ckpt_dir} to "
              "restart)")
    else:
        print(f"done: the checkpoint in {args.ckpt_dir} is at step {start} "
              f"of {steps}; delete it to restart")
    return loop


if __name__ == "__main__":
    losses = main().metrics["losses"]
    print(json.dumps({"loss_first": losses[0] if losses else None,
                      "loss_last": losses[-1] if losses else None}))
