"""Energy/quality substrate-plan autotuner (§Per-layer assignments).

Counterpart of ``repro.launch.autotune``. Searches per-site substrate
assignments (:class:`repro_torch.nn.plan.SubstratePlan`) that minimize
estimated MAC energy — MACs × the wiring's per-op PDP from the unit-gate
model (:mod:`repro_torch.core.energy`) — subject to a quality budget:

* **edge workload** — PSNR of the planned Laplacian edge maps
  (``conv.edge.center`` / ``conv.edge.ring`` tap-group sites) against the
  exact-multiplier reference, the paper's Fig. 9 metric;
* **lm workload** — max-abs logit divergence of a (reduced) LM prefill
  against the exact substrate, with per-layer ``layer.<i>.*`` move patterns.

Search is greedy: starting from a uniform baseline plan, repeatedly apply the
single (site → spec) move with the lowest estimated PDP among those whose
*scored* quality stays within budget, until no move lowers PDP. Scoring runs
on the fast ``approx_stat`` counterpart of each candidate backend (the
statistical error model — no per-product work); the winning plan is then
re-validated on the bit-exact backends (on the card, the CUDA kernels
wherever a plan names ``approx_cuda``), walking back through accepted moves
if the final check fails (stat scoring is a ranking heuristic, not an
oracle).

Per-site MAC counts come from one metered run (:mod:`repro_torch.obs.meter`)
of the baseline plan — move sets never change a site's contraction shape, so
the measurement is reused across the whole search. The model runs a Python
layer loop, so LM sites are metered as ``layer.<i>.attn.wq`` (``repro``'s
scan folds them to ``layer.*.attn.wq``); the move patterns are the same, and
a prefill's energy is summed in the scan's order, so every plan prices to
the same float as in ``repro`` (:func:`_scan_order_energy_fj`).

Everything runs on ``device``: the card unless the caller asks for the CPU
(no card raises). The result is written as a loadable plan bundle
(:func:`repro_torch.checkpoint.save_plan_bundle`, byte-compatible with
``repro``'s): serve it with ``python -m repro_torch.launch.serve --plan
<dir>`` or ``EdgeDetectService(substrate=plan)``.

  python -m repro_torch.launch.autotune --workload edge --out runs/edge_plan \\
      --wirings proposed,design_du2022 --widths 6,7,8 --images 6 --size 64x64
"""
from __future__ import annotations

import argparse
import json
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nn import plan as plan_mod
from repro_torch.nn import substrate as psub
from repro_torch.obs.meter import ContractionMeter, pdp_per_mac_fj, telemetry_scope

# fast statistical scoring counterparts — canonical home is nn.plan (the
# QAT layer shares them); re-exported here for existing callers
stat_spec = plan_mod.stat_spec
stat_plan = plan_mod.stat_plan


def with_rule(plan: plan_mod.SubstratePlan, pattern: str,
              spec: str) -> plan_mod.SubstratePlan:
    """``plan`` with ``pattern`` (re)assigned to ``spec``.

    An existing rule for the identical pattern is dropped and the new rule
    appended last; other rules are kept (exact-site rules still out-rank
    glob rules by the plan's specificity ordering).
    """
    rules = tuple((p, s) for p, s in plan.rules if p != pattern)
    return plan_mod.SubstratePlan(default=plan.default,
                                  rules=rules + ((pattern, spec),))


def measure_site_macs(run_fn: Callable[[plan_mod.SubstratePlan], None],
                      plan: plan_mod.SubstratePlan) -> Dict[str, int]:
    """Per-site MAC counts from one metered execution of ``run_fn(plan)``."""
    meter = ContractionMeter()
    with telemetry_scope(meter):
        run_fn(plan)
    return {site: int(e["macs"])
            for site, e in meter.site_summary().items() if e["macs"]}


def plan_pdp_fj(site_macs: Dict[str, int],
                plan: plan_mod.SubstratePlan) -> float:
    """Estimated energy (fJ) of the measured workload under ``plan``.

    Each measured site is priced at MACs × the per-op PDP of the multiplier
    its resolved spec names (``exact`` designs — including ``int8``'s exact
    8×8 array — price at the exact row of Table 5).
    """
    total = 0.0
    for site, macs in site_macs.items():
        meta = psub.get_substrate(plan.resolve(site)).meta
        total += macs * pdp_per_mac_fj(meta.mult_key)
    return total


def greedy_minimize(plan0: plan_mod.SubstratePlan,
                    patterns: Sequence[str], candidates: Sequence[str],
                    evaluate: Callable[[plan_mod.SubstratePlan],
                                       Tuple[float, float]],
                    budget: float,
                    log: Callable[[str], None] = lambda s: None):
    """Greedy PDP descent over single (pattern → spec) moves.

    ``evaluate(plan) -> (pdp_fj, score)`` prices and scores a candidate
    plan (higher scores are better). Accepts, per round, the move with the
    lowest estimated PDP among those whose score stays ≥ ``budget``; stops
    when no move lowers PDP. Returns ``(plan, pdp_fj, history)`` where
    ``history`` records every accepted step (including the starting point)
    for validation-time rollback.
    """
    cur = plan0
    cur_pdp, cur_score = evaluate(cur)
    history = [{"pattern": None, "spec": None, "pdp_fj": cur_pdp,
                "score": cur_score, "plan": cur.to_dict()}]
    while True:
        best = None  # (pdp, pattern, spec, score, plan)
        for pattern in patterns:
            for spec in candidates:
                if cur.resolve(pattern) == spec:
                    continue  # no-op move
                trial = with_rule(cur, pattern, spec)
                pdp, score = evaluate(trial)
                log(f"  try {pattern} -> {spec}: pdp={pdp:.1f} fJ "
                    f"score={score:.3f} "
                    f"({'ok' if score >= budget else 'reject'})")
                if pdp >= cur_pdp or score < budget:
                    continue
                if best is None or pdp < best[0]:
                    best = (pdp, pattern, spec, score, trial)
        if best is None:
            return cur, cur_pdp, history
        cur_pdp, pattern, spec, score, cur = best
        log(f"[autotune] accept {pattern} -> {spec} "
            f"(pdp={cur_pdp:.1f} fJ, score={score:.3f})")
        history.append({"pattern": pattern, "spec": spec, "pdp_fj": cur_pdp,
                        "score": score, "plan": cur.to_dict()})


def _validate_with_rollback(history: List[dict],
                            validate_fn: Callable[[plan_mod.SubstratePlan],
                                                  Tuple[bool, float, float]],
                            log: Callable[[str], None] = lambda s: None):
    """Walk accepted plans newest-first until one passes bit-exact validation.

    ``validate_fn(plan) -> (ok, quality, pdp_fj)``. Returns
    ``(plan, pdp_fj, quality, n_rolled_back)``; the baseline (first history
    entry) always terminates the walk — by construction it passes the
    match-mode budget, and an explicit floor the baseline itself misses is
    reported as-is rather than silently widened.
    """
    for i, step in enumerate(reversed(history)):
        plan = plan_mod.SubstratePlan.from_dict(step["plan"])
        ok, quality, pdp = validate_fn(plan)
        if ok or i == len(history) - 1:
            if i:
                log(f"[autotune] rolled back {i} step(s) at validation")
            return plan, pdp, quality, i
    raise AssertionError("unreachable: baseline terminates the walk")


# ---------------------------------------------------------------------------
# edge workload
# ---------------------------------------------------------------------------


def autotune_edge(images=None, *,
                  wirings: Sequence[str] = ("proposed", "design_du2022"),
                  widths: Sequence[int] = (6, 7, 8),
                  baseline: str = "approx_bitexact:proposed@8",
                  psnr_floor: Optional[float] = None,
                  n_images: int = 6, size: Tuple[int, int] = (64, 64),
                  seed: int = 0, verbose: bool = False,
                  qat_steps: int = 0, qat_lr: float = 0.05,
                  device="cuda") -> dict:
    """Tune per-tap-group substrates for the edge-detection workload.

    Quality metric: PSNR of the planned edge maps against the exact
    multiplier's, over ``images`` (a (B, H, W) uint8 batch, numpy or torch;
    a procedural ``data.image_batch`` when omitted), all on ``device``.
    ``psnr_floor=None`` is match mode: the budget is the baseline's own
    scored PSNR, so the tuned plan must be estimated no worse than uniform
    ``baseline`` — and is finally *validated* no worse on the bit-exact
    backends. Widths are capped at 8: the planned tap-group sum is only
    distributive for left-shift rescales (see
    :func:`repro_torch.nn.conv.edge_detect_planned`).

    ``qat_steps > 0`` makes the search *approximation-aware*: every
    candidate plan (and the final validation) is scored on the PSNR after a
    ``qat_steps``-step :func:`repro_torch.train.qat.finetune_edge` recovery
    under that plan's wirings, so greedy accepts moves whose error the
    model can train away. QAT widths are floored at 5 (the quantizer-clip
    contract of :func:`repro_torch.train.qat.edge_response`); the adapted
    edge params ride along in the result (and hence the saved bundle).

    Returns a result dict (see the CLI) with the winning plan under
    ``"plan"``.
    """
    from repro_torch.data import image_batch
    from repro_torch.nn import conv

    device = resolve_device(str(device))
    if max(widths) > 8:
        raise ValueError(f"edge plan widths must be <= 8, got {tuple(widths)}")
    if images is None:
        h, w = size
        images = image_batch(n_images, h, w, seed=seed)
    if not torch.is_tensor(images):
        images = torch.from_numpy(np.asarray(images, np.uint8))
    images = images.to(device=device, dtype=torch.uint8)
    log = print if verbose else (lambda s: None)

    ref = conv.edge_detect_batched(images, "exact")
    base_plan = plan_mod.SubstratePlan.uniform(baseline)
    sites = conv.edge_tap_sites()
    site_macs = measure_site_macs(
        lambda p: conv.edge_detect_planned(images, p), base_plan)

    if qat_steps and min(widths) < 5:
        raise ValueError(
            f"qat_steps > 0 needs widths >= 5, got {tuple(widths)}")

    def _finetuned(plan):
        from repro_torch.train import qat as qat_mod
        return qat_mod.finetune_edge(images, plan, steps=qat_steps,
                                     lr=qat_lr)

    def evaluate(plan):
        if qat_steps:
            # adapted quality: PSNR after a short QAT recovery on the fast
            # stat counterpart of the candidate's wirings
            score = _finetuned(stat_plan(plan))["psnr_post"]
        else:
            score = conv.psnr(
                ref, conv.edge_detect_planned(images, stat_plan(plan)))
        return plan_pdp_fj(site_macs, plan), score

    def exact_psnr(plan):
        if qat_steps:
            return _finetuned(plan)["psnr_post"]
        return conv.psnr(ref, conv.edge_detect_planned(images, plan))

    budget = (evaluate(base_plan)[1] if psnr_floor is None
              else float(psnr_floor))
    log(f"[autotune] edge: budget (scored PSNR) = {budget:.3f} dB")
    candidates = [f"approx_bitexact:{w}@{n}" for w in wirings for n in widths]
    tuned, tuned_pdp, history = greedy_minimize(
        base_plan, sites, candidates, evaluate, budget, log=log)

    base_psnr = exact_psnr(base_plan)
    floor = base_psnr if psnr_floor is None else float(psnr_floor)

    def validate(plan):
        q = exact_psnr(plan)
        return q >= floor, q, plan_pdp_fj(site_macs, plan)

    tuned, tuned_pdp, tuned_psnr, rolled_back = _validate_with_rollback(
        history, validate, log=log)
    res = {
        "workload": "edge",
        "sites": list(sites),
        "site_macs": site_macs,
        "candidates": candidates,
        "budget_scored_db": budget,
        "baseline": {"plan": base_plan.to_dict(), "psnr_db": base_psnr,
                     "pdp_fj": plan_pdp_fj(site_macs, base_plan)},
        "tuned": {"plan": tuned.to_dict(), "psnr_db": tuned_psnr,
                  "pdp_fj": tuned_pdp},
        "history": history,
        "rolled_back": rolled_back,
        "plan": tuned,
    }
    if qat_steps:
        fin = _finetuned(tuned)
        res["qat"] = {"steps": int(qat_steps), "lr": float(qat_lr),
                      "psnr_pre": fin["psnr_pre"],
                      "psnr_post": fin["psnr_post"]}
        res["params"] = fin["params"]  # adapted edge params → bundle
    return res


# ---------------------------------------------------------------------------
# lm workload
# ---------------------------------------------------------------------------


_LAYER_SITE = re.compile(r"^layer\.(\d+)\.")


def _scan_order_energy_fj(meter: ContractionMeter) -> float:
    """A metered prefill's estimated energy (fJ), summed in ``repro``'s order.

    ``repro``'s scanned layer stack folds the layer index out of a site's
    label: one counter per (spec, site) accumulates that site over the
    layers in execution order, and the total sums the counters in label
    order per spec. The port's layer loop keeps one counter per layer.
    Float addition is not associative: summed per layer, a plan that moves
    a layer between equally priced designs (``int8`` prices as ``exact``)
    can come out an ulp cheaper, and the greedy would take a move that
    saves nothing. Summed in the scan's order, such plans price equal, as
    in ``repro``.
    """
    groups: Dict[Tuple[str, str], List[Tuple[int, float]]] = {}
    for labels, value in meter._energy.samples():
        m = _LAYER_SITE.match(labels["site"])
        site = _LAYER_SITE.sub("layer.*.", labels["site"])
        groups.setdefault((labels["spec"], site), []).append(
            (int(m.group(1)) if m else -1, float(value)))
    per_spec: Dict[str, float] = {}
    for (spec, _), values in sorted(groups.items()):
        site_fj = 0.0
        for _, v in sorted(values):
            site_fj += v
        per_spec[spec] = per_spec.get(spec, 0.0) + site_fj
    return sum(per_spec.values())


def autotune_lm(arch: str, *, overrides: Optional[dict] = None,
                candidates: Sequence[str] = ("int8",
                                             "approx_bitexact:proposed@8"),
                baseline: str = "exact",
                div_budget: float = 0.25,
                batch: int = 2, seq: int = 16, seed: int = 0,
                verbose: bool = False, device="cuda") -> dict:
    """Tune per-layer substrates for a (reduced) LM prefill.

    Quality metric: max-abs logit divergence against the exact substrate on
    a fixed synthetic token batch — the tuned plan must stay within
    ``div_budget`` both under ``approx_stat`` scoring and in the final
    bit-exact validation. Move patterns are per-layer globs
    (``layer.<i>.*``), so one move reassigns a whole layer's denses.

    PDP is *measured*, not modeled: every trial runs once under the
    ambient :class:`~repro_torch.obs.meter.ContractionMeter`, whose energy
    counters price each executed contraction by its substrate's multiplier.
    The same run yields the divergence, so one prefill per trial covers
    both numbers. Parameters are drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device``.

    Returns the same result-dict shape as :func:`autotune_edge`, plus the
    ``params`` used (the LM module; callers bundle them for serving
    round-trips).
    """
    from repro_torch.models import registry as reg

    device = resolve_device(str(device))
    overrides = dict(overrides or {})
    log = print if verbose else (lambda s: None)
    cfg = reg.get_config(arch, **overrides)
    exact_bundle = reg.get_bundle(arch, dot_plan="exact", **overrides)
    params = exact_bundle.init_params(
        torch.Generator(device=device).manual_seed(seed), device)
    rng = np.random.default_rng(seed)
    tokens = {"tokens": torch.from_numpy(
        rng.integers(1, cfg.vocab, size=(batch, seq))).to(device)}

    def prefill(bundle) -> np.ndarray:
        with torch.no_grad():
            out = bundle.prefill(params, tokens)
        return out.to(torch.float32).cpu().numpy()

    ref = prefill(exact_bundle)

    def metered(plan):
        """One metered prefill → (measured pdp_fj, max-abs divergence)."""
        meter = ContractionMeter()
        b = reg.get_bundle(arch, dot_plan=plan, **overrides)
        with telemetry_scope(meter):
            out = prefill(b)
        return _scan_order_energy_fj(meter), float(np.abs(out - ref).max())

    base_plan = plan_mod.SubstratePlan.uniform(baseline)
    site_macs = measure_site_macs(
        lambda p: prefill(reg.get_bundle(arch, dot_plan=p, **overrides)),
        base_plan)
    patterns = [f"layer.{i}.*" for i in range(cfg.n_layers)]
    # scores are negated divergences so "higher is better" matches greedy's
    # contract; the budget is the negated divergence allowance
    budget = -float(div_budget)

    def evaluate(plan):
        pdp, div = metered(stat_plan(plan))
        return pdp, -div

    def validate(plan):
        pdp, div = metered(plan)
        return div <= float(div_budget), div, pdp

    tuned, tuned_pdp, history = greedy_minimize(
        base_plan, patterns, list(candidates), evaluate, budget, log=log)
    tuned, tuned_pdp, tuned_div, rolled_back = _validate_with_rollback(
        history, validate, log=log)
    base_pdp, base_div = metered(base_plan)
    return {
        "workload": "lm",
        "arch": arch,
        "sites": patterns,
        "site_macs": site_macs,
        "candidates": list(candidates),
        "div_budget": float(div_budget),
        "baseline": {"plan": base_plan.to_dict(), "divergence": base_div,
                     "pdp_fj": base_pdp},
        "tuned": {"plan": tuned.to_dict(), "divergence": tuned_div,
                  "pdp_fj": tuned_pdp},
        "history": history,
        "rolled_back": rolled_back,
        "plan": tuned,
        "params": params,
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _result_summary(res: dict) -> dict:
    """The JSON-serializable slice of a result (drops params / plan object)."""
    return {k: v for k, v in res.items() if k not in ("plan", "params")}


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=["edge", "lm"], default="edge")
    ap.add_argument("--out", required=True, metavar="DIR",
                    help="plan-bundle output directory (loadable by "
                         "launch/serve --plan and EdgeDetectService)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also dump the full search record as JSON")
    ap.add_argument("--baseline", default=None,
                    help="uniform starting spec (default: "
                         "approx_bitexact:proposed@8 for edge, exact for lm)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the "
                         "kernels' plain versions)")
    # edge knobs
    ap.add_argument("--wirings", default="proposed,design_du2022",
                    help="comma-separated wiring names to search (edge)")
    ap.add_argument("--widths", default="6,7,8",
                    help="comma-separated operand widths <= 8 (edge)")
    ap.add_argument("--images", type=int, default=6,
                    help="procedural image count (edge)")
    ap.add_argument("--size", default="64x64", metavar="HxW",
                    help="procedural image shape (edge)")
    ap.add_argument("--psnr-floor", type=float, default=None,
                    help="explicit PSNR budget in dB (edge; default: match "
                         "the baseline plan's own PSNR)")
    ap.add_argument("--qat-steps", type=int, default=0,
                    help="approximation-aware search: score each candidate "
                         "plan after this many QAT fine-tune steps (edge; "
                         "0 = raw scoring)")
    ap.add_argument("--qat-lr", type=float, default=0.05,
                    help="learning rate for --qat-steps fine-tuning (edge)")
    # lm knobs
    ap.add_argument("--arch", default=None, help="registry arch id (lm)")
    ap.add_argument("--candidates", default="int8,approx_bitexact:proposed@8",
                    help="comma-separated candidate specs (lm)")
    ap.add_argument("--div-budget", type=float, default=0.25,
                    help="max-abs logit divergence allowance (lm)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="reduced layer count override (lm)")
    args = ap.parse_args(argv)

    from repro_torch import checkpoint as ckpt

    device = resolve_device(args.device)
    if args.workload == "edge":
        h, w = (int(v) for v in args.size.lower().split("x"))
        res = autotune_edge(
            wirings=tuple(args.wirings.split(",")),
            widths=tuple(int(v) for v in args.widths.split(",")),
            baseline=args.baseline or "approx_bitexact:proposed@8",
            psnr_floor=args.psnr_floor, n_images=args.images, size=(h, w),
            seed=args.seed, verbose=True,
            qat_steps=args.qat_steps, qat_lr=args.qat_lr, device=device)
        quality = ("psnr_db", "dB")
        params = res.get("params")
        if "qat" in res:
            print(f"[autotune] qat({res['qat']['steps']} steps): "
                  f"pre={res['qat']['psnr_pre']:.3f} dB -> "
                  f"post={res['qat']['psnr_post']:.3f} dB (tuned plan)")
    else:
        if not args.arch:
            ap.error("--workload lm requires --arch")
        from repro_torch.models import convert
        from repro_torch.models import registry as reg

        overrides = {}
        if args.n_layers is not None:
            overrides["n_layers"] = args.n_layers
        res = autotune_lm(
            args.arch, overrides=overrides,
            candidates=tuple(args.candidates.split(",")),
            baseline=args.baseline or "exact",
            div_budget=args.div_budget, seed=args.seed, verbose=True,
            device=device)
        quality = ("divergence", "")
        # the bundle stores repro's parameter tree
        layout = reg.get_bundle(args.arch, **overrides).layout
        params = layout.to_tree(convert.named_leaves(res["params"]))

    base, tuned = res["baseline"], res["tuned"]
    qk, unit = quality
    print(f"[autotune] baseline: pdp={base['pdp_fj']:.1f} fJ "
          f"{qk}={base[qk]:.3f} {unit}")
    print(f"[autotune] tuned:    pdp={tuned['pdp_fj']:.1f} fJ "
          f"{qk}={tuned[qk]:.3f} {unit} "
          f"({100 * (1 - tuned['pdp_fj'] / base['pdp_fj']):.1f}% energy saved)")
    for pattern, spec in res["plan"].rules:
        print(f"  {pattern} -> {spec}")

    path = ckpt.save_plan_bundle(
        args.out, res["plan"], params=params,
        extra={"autotune": _result_summary(res)})
    print(f"[autotune] bundle -> {path}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(_result_summary(res), f, indent=1, default=str)
        print(f"[autotune] record -> {args.json}")
    return res


if __name__ == "__main__":
    main()
