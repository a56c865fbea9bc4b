"""Atomic, async checkpoints and substrate-plan bundles (copies of
``repro.checkpoint``'s on-disk formats)."""
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointManager,
    list_steps,
    load_checkpoint,
    load_plan_bundle,
    save_checkpoint,
    save_plan_bundle,
    unflatten_into,
)
