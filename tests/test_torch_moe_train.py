"""MoE training in the port against ``repro``'s, on the CPU.

llama4-maverick (4 layers: 2 stacked units of a dense and a top-1 MoE layer
with a shared expert, 4 experts) and kimi-k2 (2 layers, every one a top-2
MoE of 8 experts with a shared expert) at ``tests/test_models_smoke.py``'s
reduced widths (d_model 64, vocab 512), float32, ``repro``'s parameters
carried across by ``models.convert``. The cases:

* ``loss_fn``'s gradient at every leaf against ``jax.grad`` of ``repro``'s
  (the router through the softmax, the top-k selection and the
  renormalised weights; the experts through their batched products;
  ``xn`` through the dispatch), also with a capacity factor low enough
  that choices drop (counted);
* ``TrainLoop`` steps with Adafactor on ``repro``'s stacked tree
  (``adafactor(bundle.layout)``, the launcher's choice) against
  ``repro``'s ``TrainLoop`` steps with ``adafactor()``: two under
  ``exact``, one under ``approx_lut:proposed@8`` with QAT (after a step,
  parameters a float32 ulp apart can move an activation's int8 code across
  a rounding boundary, as ``tests/test_torch_moe.py`` notes, and the next
  loss then differs by more than the tolerance: measured at kimi-k2's
  second step, 8e-5 relative).

maverick's router is top-1: its gradient is zero in exact arithmetic (the
one choice's renormalised weight is 1), so both packages' are float32
rounding, held below 1e-6 of the largest gradient; Adafactor divides that
noise by its own RMS and moves the router by a step of about lr in each
package, in directions that do not agree, so the router is not held after
a step (the losses of the second step still are).

Tolerances: gradients within rtol 1e-4 and an absolute 1e-6 of the leaf's
largest gradient (the float32 forward and backward round a few ulps apart
in XLA and torch, and the softmax, the weighted sums and the expert
products carry those through); losses within 1e-5 relative; parameters
within 1e-5 absolute, 1% of the step's lr of 1e-3 (Adafactor divides each
gradient by its factored RMS, which turns a gradient's relative rounding
into the same relative rounding of a step of about lr).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jreg
from repro.nn import plan as jplan
from repro.optim import adafactor as jadafactor
from repro.train import QATPolicy as JPolicy
from repro.train import TrainLoop as JLoop
from repro.train import TrainLoopConfig as JConfig
from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.models import common as cm
from repro_torch.models import convert
from repro_torch.models import registry as reg
from repro_torch.optim import adafactor
from repro_torch.train import QATPolicy, TrainLoop, TrainLoopConfig
from tests.test_models_smoke import reduced
from tests.test_torch_models import port_cfg
from tests.test_torch_xlstm import one_torch_thread  # noqa: F401  (autouse)

#: (arch, overrides): maverick at 2 units of (dense, top-1 MoE); kimi-k2
#: top-2 of 8 in every layer; kimi-k2 again with choices dropped
CASES = {"maverick": ("llama4-maverick-400b-a17b", dict(n_layers=4)),
         "kimi-k2": ("kimi-k2-1t-a32b", dict(n_experts=8, top_k=2)),
         "kimi-k2-drops": ("kimi-k2-1t-a32b", dict(n_experts=8, top_k=2,
                                                   capacity_factor=0.25))}


def _pair(case, plan="exact"):
    """(repro bundle, repro params, port bundle, port params), float32."""
    arch, over = CASES[case]
    jcfg = reduced(arch, dtype=jnp.float32, dot_plan=plan, **over)
    jb = jreg.build_bundle(jcfg)
    jp = jb.init_params(jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    return jb, jp, reg.build_bundle(cfg), convert.lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jp))


def _noise_router(cfg, path) -> bool:
    """A top-1 router: the one choice's renormalised weight is 1, so the
    loss's gradient at the router is zero in exact arithmetic, and both
    packages hold only its float32 rounding (about 1e-9 here)."""
    return cfg.top_k == 1 and path[-1] == "router"


def _batch(vocab, seed=0, b=2, s=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)),
            "labels": rng.integers(0, vocab, (b, s))}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_gradients_match_jax_grad(case, monkeypatch):
    jb, jp, b, p = _pair(case)
    batch = _batch(b.cfg.vocab)
    jloss, jgrads = jax.jit(jax.value_and_grad(jb.loss_fn))(
        jp, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    kept = []
    dispatch = cm._dispatch_local

    def counting(cfg, xn, router):
        buf, info = dispatch(cfg, xn, router)
        kept.append((int(info[2].sum()), info[2].numel()))
        return buf, info

    monkeypatch.setattr(cm, "_dispatch_local", counting)
    leaves = convert.named_leaves(p)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = b.loss_fn(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    dropped = sum(n - k for k, n in kept)
    if case.endswith("drops"):
        assert 2 * dropped > sum(n for _, n in kept), kept
    got = b.layout.to_tree(dict(zip(leaves, grads)))
    largest = max(float(g.abs().max()) for g in grads)
    for (path, want), (_, g) in zip(tree_leaves(jax.tree.map(np.asarray, jgrads)),
                                    tree_leaves(got)):
        want = np.asarray(want, np.float32)
        if _noise_router(b.cfg, path):
            assert max(float(np.abs(want).max()), float(g.abs().max())) \
                < 1e-6 * largest, path
            continue
        assert float(np.abs(want).max()) > 0, path
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()),
                                   err_msg=str(path))


@pytest.mark.parametrize("case,plan,qat", [
    ("maverick", "exact", None),
    ("maverick", "approx_lut:proposed@8", "bitexact"),
    ("kimi-k2", "exact", None),
    ("kimi-k2", "approx_lut:proposed@8", "bitexact")])
def test_moe_train_steps_with_adafactor_match_repro(tmp_path, case, plan, qat):
    jb, jp, b, p = _pair(case)
    jloop = JLoop(jb.loss_fn, jadafactor(), JConfig(
        total_steps=2, ckpt_dir=str(tmp_path / "j"),
        qat=None if qat is None else JPolicy(forward=qat), plan=jplan.as_plan(plan)))
    loop = TrainLoop(b.loss_fn, adafactor(b.layout), TrainLoopConfig(
        total_steps=2, ckpt_dir=str(tmp_path / "t"),
        qat=None if qat is None else QATPolicy(forward=qat), plan=plan),
        layout=b.layout)
    jstate = jloop.optimizer.init(jp)
    state = loop.optimizer.init(convert.named_leaves(p))
    steps = 2 if qat is None else 1
    for seed in range(steps):
        batch = _batch(b.cfg.vocab, seed=seed)
        jloss, _, jp, jstate = jloop._step_fn(
            jp, jstate, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()},
            jnp.float32(1e-3))
        loss, _ = loop.step(p, state, {k: torch.from_numpy(v) for k, v in batch.items()},
                            1e-3)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5), seed
    assert int(state["step"]) == steps and convert.keyed_by_path(state)
    for (path, want), (_, got) in zip(
            tree_leaves(jax.tree.map(np.asarray, jp)),
            tree_leaves(convert.lm_params_to_jax(b.cfg, p))):
        if not _noise_router(b.cfg, path):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                       err_msg=str(path))
    assert all(not t.requires_grad for t in p.parameters())
