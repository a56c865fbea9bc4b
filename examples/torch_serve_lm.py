"""Serve a small LM with batched requests through the port's serving engine.

Run: PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

The counterpart of ``examples/serve_lm.py``: the same reduced minitron-8b
(2 layers, d_model 128, vocab 1024), 8 requests of which every other one
samples at temperature 0.8, and 4 slots of continuous batching, on
``--device`` (the card unless ``--device cpu``; no card raises). Random
weights come from a seeded ``torch.Generator`` on the device. Run as a
script, its last line is a JSON object of the requests and tokens served.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import registry as reg
from repro_torch.serving import Request, ServingEngine

OVERRIDES = dict(n_layers=2, d_model=128, d_ff=256, vocab=1024, n_heads=4,
                 n_kv_heads=2, remat=False, attn_chunk=64, loss_chunk=64)


def requests() -> list:
    rng = np.random.default_rng(1)
    return [Request(prompt=[int(t) for t in rng.integers(1, 1024, size=5)],
                    max_tokens=12, temperature=0.0 if i % 2 else 0.8)
            for i in range(8)]


def main(device="cuda", params=None, **overrides) -> list:
    """Serve the 8 requests; returns them with their outputs. ``params``
    (an LM of the config, on ``device``) replaces the seeded init;
    ``overrides`` change config fields (``dtype=``, for example)."""
    device = resolve_device(str(device))
    cfg = reg.get_config("minitron-8b", **{**OVERRIDES, **overrides})
    bundle = reg.build_bundle(cfg)
    if params is None:
        params = bundle.init_params(
            torch.Generator(device=device).manual_seed(0), device)
    engine = ServingEngine(bundle, params, batch_size=4, max_len=96,
                           device=device)
    out = engine.generate(requests())
    for i, r in enumerate(out):
        print(f"req{i}  prompt={r.prompt}\n      -> {r.output}")
    total = sum(len(r.output) for r in out)
    print(f"\nserved {len(out)} requests, {total} tokens (continuous batching, "
          "4 slots)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the "
                         "kernels' plain versions)")
    out = main(ap.parse_args().device)
    print(json.dumps({"requests": len(out),
                      "tokens_served": sum(len(r.output) for r in out)}))
