"""Fault-tolerant training loop.

Counterpart of ``repro.train.loop`` (without ``dp_train_step_compressed``,
the data-parallel step with an int8 all-reduce: ROADMAP.md queue 1 item
11). The step is eager PyTorch:

* **checkpoint / restart** — async checkpoints every ``ckpt_every`` steps;
  on (re)start the loop finds the newest complete checkpoint, restores
  params and optimizer state into fresh ones, and seeks the data stream to
  that step, so a resumed run is bitwise the uninterrupted one.
  Checkpoints hold ``{"params", "opt"}`` in ``repro``'s tree layout (the
  ``layout`` given, :func:`repro_torch.models.convert.lm_layout` for an LM
  bundle), so either package restores the other's; an optimizer state
  keyed by tree path (Adafactor on ``repro``'s stacked leaves) is stored
  as it is.
* **failure injection** — ``fail_at_step`` raises at that step.
* **stragglers** — a step slower than ``straggler_factor`` × the step-time
  EWMA is counted in ``metrics["straggler_steps"]``.
* **grad accumulation** — ``grad_accum`` micro-batches, float32 sums.
* **approximation-aware training** — with ``cfg.qat`` (a
  :class:`repro_torch.train.qat.QATPolicy`) the loss runs inside
  :func:`~repro_torch.train.qat.qat_scope`, and with ``cfg.plan`` inside
  :func:`repro_torch.nn.plan.plan_override_scope`, so the plan governs every
  plan-consulting contraction whatever the model was built with. Both are
  recorded in every checkpoint manifest; on restore an unset one adopts the
  checkpoint's and a conflicting one raises. The scopes are entered on
  every step (there is no trace to rebuild on adoption).

``params`` is an ``nn.Module`` (an LM) or a flat dict of tensors. The step
turns autograd on for its leaves around the loss (``requires_grad_``) and
off after; the optimizer updates the leaves in place, so ``run`` returns the
module it was given.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.ckpt import tree_map
from repro_torch.models import convert
from repro_torch.optim import grad_utils
from repro_torch.optim.adamw import Optimizer


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "repro_ckpt"
    keep: int = 3
    lr: float = 1e-3
    grad_clip: float = 1.0
    grad_accum: int = 1
    fail_at_step: Optional[int] = None       # fault-injection hook
    straggler_factor: float = 3.0
    async_ckpt: bool = True
    qat: Optional[Any] = None                # repro_torch.train.qat.QATPolicy
    plan: Optional[Any] = None               # SubstratePlan / spec / dict


def _flat_state(state) -> Dict[str, torch.Tensor]:
    """Optimizer state as one flat dict of its tensors; ``mv`` keyed by
    parameter name or by tree path (Adafactor's stacked leaves)."""
    def key(k):
        return k if isinstance(k, str) else "/".join(map(str, k))
    return {"step": state["step"], **{f"{key(k)}.{s}": t
                                      for k, d in state["mv"].items()
                                      for s, t in d.items()}}


class TrainLoop:
    def __init__(self, loss_fn: Callable, optimizer: Optimizer,
                 cfg: TrainLoopConfig, lr_schedule: Optional[Callable] = None,
                 layout: Optional[convert.TreeLayout] = None):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.cfg = cfg
        if cfg.plan is not None:
            from repro_torch.nn import plan as _plan_mod
            cfg.plan = _plan_mod.as_plan(cfg.plan)
        self.lr_schedule = lr_schedule or (lambda step: cfg.lr)
        self.layout = layout if layout is not None else convert.TreeLayout()
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.metrics: Dict[str, Any] = {"straggler_steps": 0, "resumed_from": None}

    def _ckpt_extra(self) -> Dict[str, Any]:
        """Manifest record of the numerics this run trains under."""
        extra: Dict[str, Any] = {}
        if self.cfg.plan is not None:
            extra["plan"] = self.cfg.plan.to_dict()
        if self.cfg.qat is not None:
            extra["qat"] = self.cfg.qat.describe()
        return extra

    def _tree(self, params, opt_state) -> dict:
        return {"params": self.layout.to_tree(convert.named_leaves(params)),
                "opt": self.layout.state_to_tree(opt_state)}

    # -- one step -------------------------------------------------------------

    def _value_and_grad(self, params, batch):
        """(loss, {name: grad}) of one micro-batch under the run's scopes; a
        leaf the loss does not reach gets a zero gradient, as under jax."""
        cfg = self.cfg
        leaves = convert.named_leaves(params)
        for t in leaves.values():
            t.requires_grad_(True)
        try:
            with contextlib.ExitStack() as scopes:
                if cfg.plan is not None:
                    from repro_torch.nn import plan as _plan_mod
                    scopes.enter_context(_plan_mod.plan_override_scope(cfg.plan))
                if cfg.qat is not None:
                    from repro_torch.train import qat as qat_mod
                    scopes.enter_context(qat_mod.qat_scope(cfg.qat))
                loss = self.loss_fn(params, batch)
                grads = torch.autograd.grad(loss, list(leaves.values()),
                                            allow_unused=True)
        finally:
            for t in leaves.values():
                t.requires_grad_(False)
        return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                               for (k, p), g in zip(leaves.items(), grads)}

    def step(self, params, opt_state, batch: Dict[str, torch.Tensor], lr):
        """One optimizer step → (loss, grad norm); ``params`` and
        ``opt_state`` are updated in place."""
        cfg = self.cfg
        if cfg.grad_accum == 1:
            loss, grads = self._value_and_grad(params, batch)
        else:
            loss = grads = None
            for i in range(cfg.grad_accum):
                mb = {k: v[i * (v.shape[0] // cfg.grad_accum):
                           (i + 1) * (v.shape[0] // cfg.grad_accum)]
                      for k, v in batch.items()}
                l, g = self._value_and_grad(params, mb)
                if grads is None:  # float32 sums, as repro's zeros + g
                    loss, grads = l, {k: t.to(torch.float32) for k, t in g.items()}
                else:
                    loss = loss + l
                    grads = {k: grads[k] + t for k, t in g.items()}
            scale = 1.0 / cfg.grad_accum
            loss = loss * scale
            grads = {k: g * scale for k, g in grads.items()}
        grads, gnorm = grad_utils.clip_by_global_norm(grads, cfg.grad_clip)
        self.optimizer.update(grads, opt_state, convert.named_leaves(params), lr)
        return loss, gnorm

    # -- lifecycle -----------------------------------------------------------

    def init_or_restore(self, init_params_fn: Callable):
        """Fresh init, or the newest checkpoint restored into it in place;
        returns (params, opt_state, the step to start from)."""
        params = init_params_fn()
        leaves = convert.named_leaves(params)
        opt_state = self.optimizer.init(leaves)
        start_step = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            # shapes only: meta tensors allocate nothing
            template = self._tree({k: t.to("meta") for k, t in leaves.items()},
                                  tree_map(opt_state, lambda t: t.to("meta")))
            tree, step, extra = self.ckpt.restore(template, device="cpu")
            convert.assign_(params, self.layout.from_tree(tree["params"]))
            convert.assign_(_flat_state(opt_state), _flat_state(
                self.layout.state_from_tree(
                    tree["opt"], by_path=convert.keyed_by_path(opt_state))))
            start_step = step
            self.metrics["resumed_from"] = step
            self._check_numerics(extra or {})
        return params, opt_state, start_step

    def _check_numerics(self, extra: Dict[str, Any]):
        """Refuse to resume under other numerics than the checkpoint's: an
        unset ``cfg.plan`` / ``cfg.qat`` adopts the checkpoint's, a
        conflicting one raises. Adoption takes effect on the next step,
        which enters the scopes anew."""
        from repro_torch.nn import plan as _plan_mod
        saved_plan = extra.get("plan")
        if saved_plan is not None:
            saved = _plan_mod.as_plan(saved_plan)
            if self.cfg.plan is None:
                self.cfg.plan = saved
            elif self.cfg.plan != saved:
                raise ValueError(
                    f"checkpoint was trained under plan {saved.label!r} "
                    f"but this run configures {self.cfg.plan.label!r}; "
                    "pass the matching --dot-plan (or none, to adopt the "
                    "checkpoint's)")
        saved_qat = extra.get("qat")
        if saved_qat is not None:
            from repro_torch.train import qat as qat_mod
            saved_pol = qat_mod.QATPolicy.from_dict(saved_qat)
            if self.cfg.qat is None:
                # an approximate plan without its STE policy trains with
                # zero gradients through the rounding: adopt it as well
                self.cfg.qat = saved_pol
            elif self.cfg.qat != saved_pol:
                raise ValueError(
                    f"checkpoint QAT policy {saved_qat} differs from this "
                    f"run's {self.cfg.qat.describe()}")

    def run(self, params, opt_state, data_stream, start_step: int = 0,
            on_step: Optional[Callable] = None):
        cfg = self.cfg
        device = next(iter(convert.named_leaves(params).values())).device
        data_stream.seek(start_step)
        ewma = None
        losses = []
        step = start_step
        try:
            for step in range(start_step, cfg.total_steps):
                if cfg.fail_at_step is not None and step == cfg.fail_at_step:
                    raise RuntimeError(f"injected failure at step {step}")
                batch = {k: torch.from_numpy(v).to(device=device,
                                                   dtype=torch.int64)
                         for k, v in data_stream.next().items()}
                t0 = time.time()
                loss, _gnorm = self.step(params, opt_state, batch,
                                         self.lr_schedule(step))
                loss = float(loss)
                dt = time.time() - t0
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
                if dt > cfg.straggler_factor * ewma and step > start_step + 3:
                    self.metrics["straggler_steps"] += 1
                losses.append(loss)
                if on_step:
                    on_step(step, loss)
                if (step + 1) % cfg.ckpt_every == 0:
                    tree = self._tree(params, opt_state)
                    extra = self._ckpt_extra()
                    if cfg.async_ckpt:
                        self.ckpt.save_async(step + 1, tree, extra=extra)
                    else:
                        self.ckpt.save(step + 1, tree, extra=extra)
        finally:
            self.ckpt.wait()
        self.metrics["final_loss"] = losses[-1] if losses else None
        self.metrics["losses"] = losses
        return params, opt_state, step + 1
