"""The card the entry points run on: ``--device`` resolved, and the
``nvidia-smi`` line that every time taken on the card is read beside."""
from __future__ import annotations

import subprocess

import torch


def resolve_device(name: str) -> torch.device:
    """``--device``: the card unless the CPU is asked for; no card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the plain versions")
    return device


def card_name() -> "str | None":
    """The first card's ``nvidia-smi --query-gpu=name,power.limit`` line
    (its name and power limit), or None without a card."""
    if not torch.cuda.is_available():
        return None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]
