"""Recovered-quality benchmark for approximation-aware training (QAT) on the
PyTorch port.

The counterpart of ``benchmarks/qat_recovery.py``, on ``device`` (the card
unless the caller asks for the CPU; no card raises). For a grid of
wirings × operand widths, measures quality on the two paper workloads
**before** and **after** a short QAT fine-tune under that wiring's own
error (:mod:`repro_torch.train.qat`):

* **edge** — PSNR of the planned Laplacian edge maps vs the exact
  multiplier (paper Fig. 9 metric). Pre = the untrained integer pipeline,
  post = the QAT edge model after :func:`repro_torch.train.qat.finetune_edge`.
* **lm** — eval loss of the reduced minitron-8b on a fixed synthetic batch,
  running its denses on the approximate substrate. Pre = exact-pretrained
  params evaluated on the approximate forward, post = after a short QAT
  fine-tune under ``qat_scope(QATPolicy(forward="stat"))`` (eval is always
  bit-exact). Each step is autograd through the straight-through forward
  and :func:`repro_torch.optim.adamw` at the reference's rate.

Each row carries the wiring's per-MAC PDP (unit-gate model, Table 5
pricing) and the workload's metered plan energy, so the headline
``recovered_points`` can be read directly: operating points *cheaper* than
uniform ``proposed@8`` whose post-QAT edge PSNR matches or beats the
uniform ``proposed@8`` pipeline *without* QAT. A full run with no recovered
point raises.

Writes ``BENCH_torch_qat.json`` at the repo root (the reference's
``BENCH_qat.json`` is left alone). Standalone:
``python -m benchmarks.torch_qat_recovery [--dry-run] [--json PATH]
[--device cpu]``.
"""
from __future__ import annotations

import copy
import json
import pathlib
import time

import torch

from repro_torch.data import image_batch
from repro_torch.device import card_name, resolve_device
from repro_torch.launch import autotune
from repro_torch.models import convert
from repro_torch.nn import conv
from repro_torch.nn import plan as plan_mod
from repro_torch.obs.meter import pdp_per_mac_fj
from repro_torch.train import qat

_REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
DEFAULT_JSON = _REPO_ROOT / "BENCH_torch_qat.json"

REFERENCE = ("proposed", 8)                # the paper's headline multiplier
WIRINGS = ("proposed", "design_du2022", "design_strollo2020")
WIDTHS = (6, 8)

# reduced LM (same shape as the launcher smoke runs)
LM_ARCH = "minitron-8b"
LM_OVERRIDES = dict(n_layers=2, d_model=64, d_ff=128, vocab=128,
                    n_heads=4, n_kv_heads=2)
LM_LR = 1e-3


def _spec(wiring: str, width: int) -> str:
    return f"approx_bitexact:{wiring}@{width}"


def _mac_fj(spec: str) -> float:
    from repro_torch.nn import substrate as psub

    return pdp_per_mac_fj(psub.get_substrate(spec).meta.mult_key)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _edge_rows(imgs, *, steps: int, lr: float = 0.05):
    """One row per wiring×width: pre/post PSNR + energy figures."""
    rows = []
    for wiring in WIRINGS:
        for width in WIDTHS:
            plan = plan_mod.SubstratePlan.uniform(_spec(wiring, width))
            site_macs = autotune.measure_site_macs(
                lambda p: conv.edge_detect_planned(imgs, p), plan)
            _sync(imgs.device)
            t0 = time.perf_counter()
            fin = qat.finetune_edge(imgs, plan, steps=steps, lr=lr)
            _sync(imgs.device)
            us = (time.perf_counter() - t0) * 1e6
            rows.append({
                "wiring": wiring, "width": width,
                "spec": _spec(wiring, width),
                "psnr_pre_db": fin["psnr_pre"],
                "psnr_post_db": fin["psnr_post"],
                "pdp_per_mac_fj": _mac_fj(_spec(wiring, width)),
                "plan_pdp_fj": autotune.plan_pdp_fj(site_macs, plan),
                "qat_steps": steps, "finetune_us": us,
            })
    return rows


def _batch(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64)
            for k, v in arrays.items()}


def _lm_rows(*, pretrain_steps: int, qat_steps: int, widths=(6, 8),
             wirings=("proposed",), device, init_params=None):
    """Reduced-LM eval loss on the approximate substrate, pre vs post QAT.
    ``init_params(bundle, device)`` replaces the seeded init."""
    from repro_torch.data import SyntheticLMStream
    from repro_torch.models import registry as reg
    from repro_torch.optim import adamw

    opt = adamw()
    stream = SyntheticLMStream(vocab=LM_OVERRIDES["vocab"], batch=4,
                               seq_len=32, seed=0)

    # exact pretrain → the params every wiring starts its recovery from
    exact_bundle = reg.get_bundle(LM_ARCH, dot_plan="exact", **LM_OVERRIDES)
    params = (init_params(exact_bundle, device) if init_params is not None
              else exact_bundle.init_params(
                  torch.Generator(device).manual_seed(0), device))
    state = opt.init(convert.named_leaves(params))
    stream.seek(0)
    for _ in range(pretrain_steps):
        _sgd_step(exact_bundle.loss_fn, opt, params, state,
                  _batch(stream.next(), device))
    eval_batch = _batch(stream.next(), device)
    with torch.no_grad():
        exact_loss = float(exact_bundle.loss_fn(params, eval_batch))

    rows = []
    for wiring in wirings:
        for width in widths:
            spec = _spec(wiring, width)
            plan = plan_mod.SubstratePlan.uniform(spec)
            bundle = reg.get_bundle(LM_ARCH, dot_plan=plan, **LM_OVERRIDES)
            with torch.no_grad():
                pre = float(bundle.loss_fn(params, eval_batch))

            policy = qat.QATPolicy(forward="stat")

            def qat_loss(p, b, _f=bundle.loss_fn, _pol=policy):
                with qat.qat_scope(_pol):
                    return _f(p, b)

            p2 = copy.deepcopy(params)
            s2 = opt.init(convert.named_leaves(p2))
            stream.seek(pretrain_steps + 1)
            for _ in range(qat_steps):
                _sgd_step(qat_loss, opt, p2, s2, _batch(stream.next(), device))
            with torch.no_grad():
                post = float(bundle.loss_fn(p2, eval_batch))
            rows.append({
                "wiring": wiring, "width": width, "spec": spec,
                "loss_exact": exact_loss, "loss_pre": pre, "loss_post": post,
                "pdp_per_mac_fj": _mac_fj(spec),
                "pretrain_steps": pretrain_steps, "qat_steps": qat_steps,
            })
    return rows


def _sgd_step(loss_fn, opt, params, state, batch) -> float:
    """One AdamW step on ``params`` (updated in place, as ``state``):
    autograd of ``loss_fn`` over every leaf; a leaf the loss does not reach
    gets a zero gradient, as under ``jax.value_and_grad``."""
    leaves = convert.named_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    opt.update({k: torch.zeros_like(p) if g is None else g
                for (k, p), g in zip(leaves.items(), grads)},
               state, leaves, LM_LR)
    return float(loss.detach())


def _recovered_points(edge_rows):
    """Cheaper-than-reference rows whose *post*-QAT PSNR ≥ reference *pre*."""
    ref = next(r for r in edge_rows
               if (r["wiring"], r["width"]) == REFERENCE)
    return [
        {"spec": r["spec"], "pdp_per_mac_fj": r["pdp_per_mac_fj"],
         "psnr_post_db": r["psnr_post_db"],
         "reference_spec": ref["spec"],
         "reference_pdp_per_mac_fj": ref["pdp_per_mac_fj"],
         "reference_psnr_pre_db": ref["psnr_pre_db"],
         "energy_saved_frac": 1 - r["pdp_per_mac_fj"] / ref["pdp_per_mac_fj"]}
        for r in edge_rows
        if r["pdp_per_mac_fj"] < ref["pdp_per_mac_fj"]
        and r["psnr_post_db"] >= ref["psnr_pre_db"]
    ]


def measure(dry_run: bool = False, device="cuda", init_params=None) -> dict:
    """The edge and LM rows of a run: ``{"images": (B, H, W), "edge",
    "lm"}``. ``init_params(bundle, device)`` replaces the LM's seeded init."""
    device = resolve_device(str(device))
    imgs = image_batch(2, 24, 24) if dry_run else image_batch(4, 48, 48)
    t_imgs = torch.from_numpy(imgs).to(device)
    if dry_run:
        edge = _edge_rows(t_imgs, steps=4)
        lm = _lm_rows(pretrain_steps=3, qat_steps=3, widths=(8,),
                      device=device, init_params=init_params)
    else:
        edge = _edge_rows(t_imgs, steps=120)
        lm = _lm_rows(pretrain_steps=40, qat_steps=25, device=device,
                      init_params=init_params)
    return {"images": imgs.shape, "edge": edge, "lm": lm}


def run(dry_run: bool = False, json_path=DEFAULT_JSON, device="cuda",
        init_params=None) -> list:
    """Harness entry point; returns ``(name, us, derived)`` CSV rows.
    ``init_params(bundle, device)`` replaces the LM's seeded init."""
    device = resolve_device(str(device))
    res = measure(dry_run, device, init_params)
    imgs, edge, lm = res["images"], res["edge"], res["lm"]
    if dry_run:
        json_path = None

    print(f"\n== QAT recovery (edge: {imgs[0]}x{imgs[1]}x{imgs[2]}) ==")
    print(f"{'spec':>34s} {'pre_db':>7s} {'post_db':>8s} {'fJ/MAC':>8s}")
    for r in edge:
        print(f"{r['spec']:>34s} {r['psnr_pre_db']:7.2f} "
              f"{r['psnr_post_db']:8.2f} {r['pdp_per_mac_fj']:8.1f}")
    print(f"{'lm spec':>34s} {'pre':>7s} {'post':>8s} {'exact':>8s}")
    for r in lm:
        print(f"{r['spec']:>34s} {r['loss_pre']:7.3f} "
              f"{r['loss_post']:8.3f} {r['loss_exact']:8.3f}")

    recovered = _recovered_points(edge)
    for p in recovered:
        print(f"[qat] recovered point: {p['spec']} "
              f"({p['pdp_per_mac_fj']:.1f} fJ/MAC, "
              f"{100 * p['energy_saved_frac']:.0f}% cheaper) post-QAT "
              f"{p['psnr_post_db']:.2f} dB >= {p['reference_spec']} pre-QAT "
              f"{p['reference_psnr_pre_db']:.2f} dB")
    if not dry_run and not recovered:
        raise AssertionError(
            "no recovered operating point: QAT failed to match the "
            "reference quality at any cheaper wiring/width")

    rows = []
    for r in edge:
        rows.append((f"qat/edge/{r['wiring']}@{r['width']}",
                     r["finetune_us"],
                     f"pre={r['psnr_pre_db']:.2f}dB,"
                     f"post={r['psnr_post_db']:.2f}dB"))
    for r in lm:
        rows.append((f"qat/lm/{r['wiring']}@{r['width']}", 0.0,
                     f"pre={r['loss_pre']:.3f},post={r['loss_post']:.3f}"))

    if json_path:
        payload = {
            "reference": _spec(*REFERENCE),
            "wirings": list(WIRINGS), "widths": list(WIDTHS),
            "backend": device.type,
            "card": card_name() if device.type == "cuda" else None,
            "edge": edge, "lm": lm,
            "recovered_points": recovered,
            "lm_arch": LM_ARCH, "lm_overrides": LM_OVERRIDES,
        }
        pathlib.Path(json_path).write_text(
            json.dumps(payload, indent=1) + "\n")
        print(f"[bench qat] wrote {json_path}")
    return rows


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dry-run", action="store_true",
                    help="tiny grid + steps, no JSON artifact (CI smoke)")
    ap.add_argument("--json", default=str(DEFAULT_JSON), dest="json_path",
                    help="output path for BENCH_torch_qat.json ('' disables)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the "
                         "kernels' plain versions)")
    args = ap.parse_args()
    run(dry_run=args.dry_run,
        json_path=None if args.dry_run else (args.json_path or None),
        device=args.device)
