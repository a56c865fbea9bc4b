"""The port's training path against ``repro``'s, on the CPU: the loss, the
``TrainLoop`` (steps, accumulation, crash → restart, the manifest's plan
and QAT record), remat, the trained embedding served afterwards, and the
training launcher.

Sizes: minitron-8b cut to 2 layers, d_model 32, vocab 64 (float32 where
held against ``repro``). Tolerances: a ``TrainLoop`` step's loss and
gradient norm within 1e-5 relative of ``repro``'s (the forward's integer
contractions are bit-identical; the float ops around them round a few
float32 ulps apart in XLA and torch), every updated parameter within 1e-5
absolute, 1% of the step's lr of 1e-3: AdamW's first step is
``g / (|g| + 1e-8)`` per element, which turns the rounding of a gradient
near 1e-8 into a visible part of the step (measured: 3.3e-6 at one
element of 4096). Everything within the port (restart, remat, threads,
checkpoints written by ``repro``) bit for bit.
"""
import json
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.data import SyntheticLMStream as JStream
from repro.models import registry as jreg
from repro.nn import plan as jplan
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.train import QATPolicy as JPolicy
from repro.train import TrainLoop as JLoop
from repro.train import TrainLoopConfig as JConfig
from repro_torch.data import SyntheticLMStream
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models import registry as reg
from repro_torch.nn import plan as splan
from repro_torch.optim import adafactor, adamw, warmup_cosine
from repro_torch.train import QATPolicy, TrainLoop, TrainLoopConfig, qat_scope
from tests.test_torch_models import port_cfg
from tests.test_torch_xlstm import one_torch_thread  # noqa: F401  (autouse)

RNG_T = np.random.default_rng(21)
SMALL = dict(n_layers=2, d_model=32, d_ff=64, vocab=64, n_heads=2, n_kv_heads=2)
FLAGS = ["--arch", "minitron-8b", "--n-layers", "2", "--d-model", "32", "--d-ff",
         "64", "--vocab", "64", "--n-heads", "2", "--n-kv-heads", "2"]


def _pair(**extra):
    """(repro bundle, repro params, port bundle, port params), float32, the
    same numbers."""
    jcfg = jreg.get_config("minitron-8b", dtype=jnp.float32, **SMALL, **extra)
    jb = jreg._BUILDERS["lm"](jcfg)
    jp = jb.init_params(jax.random.PRNGKey(7))
    cfg = port_cfg(jcfg)
    return jb, jp, reg.build_bundle(cfg), convert.lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jp))


def _bytes(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _batch(seed=0, batch=4, seq=16):
    return SyntheticLMStream(vocab=64, batch=batch, seq_len=seq, seed=seed).next()


# ---------------------------------------------------------------------------
# the loss and one TrainLoop step against repro
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loss_chunk", [512, 5])
def test_loss_matches_repro(loss_chunk):
    """One chunk, and chunks of 5 over 16 positions (a remainder of 1)."""
    jb, jp, b, p = _pair(loss_chunk=loss_chunk)
    batch = _batch()
    want = float(jb.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = b.loss_fn(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("plan,qat", [(None, None),
                                      ("approx_bitexact:proposed@8", None),
                                      ("approx_lut:csp_axc1@6", "bitexact")])
def test_train_step_matches_repro(tmp_path, plan, qat):
    jb, jp, b, p = _pair(remat=False)
    batch = _batch()
    jloop = JLoop(jb.loss_fn, jadamw(), JConfig(
        total_steps=1, ckpt_dir=str(tmp_path / "j"),
        qat=None if qat is None else JPolicy(forward=qat),
        plan=None if plan is None else jplan.as_plan(plan)))
    jloss, jnorm, jp2, _ = jloop._step_fn(
        jp, jloop.optimizer.init(jp), {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.float32(1e-3))
    loop = TrainLoop(b.loss_fn, adamw(), TrainLoopConfig(
        total_steps=1, ckpt_dir=str(tmp_path / "t"),
        qat=None if qat is None else QATPolicy(forward=qat), plan=plan),
        layout=b.layout)
    state = loop.optimizer.init(convert.named_leaves(p))
    loss, norm = loop.step(p, state, {k: torch.from_numpy(v).long()
                                      for k, v in batch.items()}, 1e-3)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-5)
    assert int(state["step"]) == 1
    got = convert.lm_params_to_jax(b.cfg, p)
    for a, c in zip(jax.tree.leaves(jp2), jax.tree.leaves(got)):
        np.testing.assert_allclose(c, np.asarray(a), rtol=0, atol=1e-5)
    assert all(not t.requires_grad for t in p.parameters())  # off after the step


def test_a_leaf_the_loss_does_not_reach_gets_a_zero_gradient(tmp_path):
    """jax differentiates to zeros where autograd returns None: the leaf
    then moves by weight decay alone, in both packages (a flat dict of
    params, the default layout)."""
    a = RNG_T.normal(size=(3, 4)).astype(np.float32)
    u = RNG_T.normal(size=(5,)).astype(np.float32)
    batch = {"x": np.ones((2,), np.float32)}
    jloop = JLoop(lambda p, b: (p["a"] ** 2).sum() * b["x"].sum(),
                  jadamw(weight_decay=0.5), JConfig(ckpt_dir=str(tmp_path / "j")))
    jp = {"a": jnp.asarray(a), "unused": jnp.asarray(u)}
    _, _, jp2, _ = jloop._step_fn(jp, jloop.optimizer.init(jp),
                                  {"x": jnp.asarray(batch["x"])}, jnp.float32(1e-2))
    loop = TrainLoop(lambda p, b: (p["a"] ** 2).sum() * b["x"].sum(),
                     adamw(weight_decay=0.5), TrainLoopConfig(ckpt_dir=str(tmp_path)))
    p = {"a": torch.from_numpy(a.copy()), "unused": torch.from_numpy(u.copy())}
    loop.step(p, loop.optimizer.init(p), {"x": torch.from_numpy(batch["x"])}, 1e-2)
    np.testing.assert_allclose(p["unused"].numpy(), np.asarray(jp2["unused"]),
                               rtol=1e-6)
    np.testing.assert_allclose(p["unused"].numpy(), u - 1e-2 * 0.5 * u, rtol=1e-6)
    np.testing.assert_allclose(p["a"].numpy(), np.asarray(jp2["a"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# TrainLoop within the port (tests/test_infra.py's and test_qat.py's cases)
# ---------------------------------------------------------------------------


_PLAN = splan.SubstratePlan.uniform("approx_stat:proposed@8")


def _loop(tmp_path, total_steps=12, fail_at=None, plan=_PLAN,
          policy=QATPolicy(forward="stat"), arch="minitron-8b", **cfg_extra):
    """A TrainLoop of ``arch`` at ``SMALL`` (``cfg_extra`` overriding it),
    with the launcher's optimizer: Adafactor on repro's stacked tree for an
    MoE config, else AdamW."""
    bundle = reg.get_bundle(arch, **{**SMALL, **cfg_extra})
    loop = TrainLoop(
        bundle.loss_fn, adafactor(bundle.layout) if bundle.cfg.n_experts
        else adamw(weight_decay=0.0),
        TrainLoopConfig(total_steps=total_steps, ckpt_every=4,
                        ckpt_dir=str(tmp_path / "ckpt"), lr=5e-3,
                        fail_at_step=fail_at, async_ckpt=fail_at is None,
                        qat=policy, plan=plan),
        lr_schedule=warmup_cosine(5e-3, 2, total_steps), layout=bundle.layout)
    stream = SyntheticLMStream(vocab=64, batch=4, seq_len=16, seed=0)
    init = lambda: bundle.init_params(torch.Generator().manual_seed(7))  # noqa: E731
    return loop, stream, init


def _same(a, b):
    la, lb = convert.named_leaves(a), convert.named_leaves(b)
    assert set(la) == set(lb)
    for k in la:
        assert torch.equal(la[k], lb[k]), k


def test_train_loss_decreases(tmp_path):
    loop, stream, init = _loop(tmp_path, total_steps=25, plan=None, policy=None)
    params, opt, start = loop.init_or_restore(init)
    loop.run(params, opt, stream, start)
    losses = loop.metrics["losses"]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


#: llama4-maverick at SMALL widths, 4 layers: 2 stacked units of a dense and
#: a top-1 MoE layer of 4 experts (Adafactor on repro's stacked tree)
MOE_SMALL = dict(arch="llama4-maverick-400b-a17b", n_layers=4, n_experts=4)


@pytest.mark.parametrize("plan,policy,model", [
    (None, None, {}), (_PLAN, QATPolicy(forward="stat"), {}),
    ("approx_lut:proposed@8", QATPolicy(), {}),
    ("approx_lut:proposed@8", QATPolicy(), MOE_SMALL)],
    ids=["None-None", "plan1-policy1", "approx_lut:proposed@8-policy2",
         "moe-adafactor"])
def test_crash_restart_bitwise(tmp_path, plan, policy, model):
    loop_a, stream_a, init = _loop(tmp_path / "a", plan=plan, policy=policy, **model)
    pa, oa, sa = loop_a.init_or_restore(init)
    pa, oa, _ = loop_a.run(pa, oa, stream_a, sa)

    loop_b, stream_b, init_b = _loop(tmp_path / "b", fail_at=10, plan=plan,
                                     policy=policy, **model)
    pb, ob, sb = loop_b.init_or_restore(init_b)
    with pytest.raises(RuntimeError, match="injected failure"):
        loop_b.run(pb, ob, stream_b, sb)

    loop_c, stream_c, init_c = _loop(tmp_path / "b", plan=plan, policy=policy, **model)
    pc, oc, sc = loop_c.init_or_restore(init_c)
    assert sc == 8 and loop_c.metrics["resumed_from"] == 8
    pc, oc, _ = loop_c.run(pc, oc, stream_c, sc)
    _same(pa, pc)
    assert torch.equal(oa["step"], oc["step"])
    assert set(oa["mv"]) == set(oc["mv"])
    assert convert.keyed_by_path(oa) == bool(model)  # Adafactor: repro's leaves
    for k in oa["mv"]:
        assert set(oa["mv"][k]) == set(oc["mv"][k])
        for stat in oa["mv"][k]:
            assert torch.equal(oa["mv"][k][stat], oc["mv"][k][stat]), (k, stat)


def test_grad_accum_matches_full_batch(tmp_path):
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(seed=1, batch=8).items()}

    def run(accum):
        loop, _, init = _loop(tmp_path, plan=None, policy=None)
        loop.cfg.grad_accum = accum
        params = init()
        loss, _ = loop.step(params, loop.optimizer.init(convert.named_leaves(params)),
                            batch, 1e-3)
        return float(loss), params

    l1, p1 = run(1)
    l2, p2 = run(2)
    assert l1 == pytest.approx(l2, rel=2e-3)
    for (k, a), b in zip(p1.named_parameters(), p2.parameters()):
        torch.testing.assert_close(a, b, rtol=3e-2, atol=3e-3)


def test_checkpoint_manifest_records_plan_and_policy(tmp_path):
    loop, stream, init = _loop(tmp_path, total_steps=4)
    params, opt, start = loop.init_or_restore(init)
    loop.run(params, opt, stream, start)
    with open(tmp_path / "ckpt" / "step_0000000004" / "manifest.json") as f:
        extra = json.load(f)["extra"]
    assert splan.SubstratePlan.from_dict(extra["plan"]) == _PLAN
    assert QATPolicy.from_dict(extra["qat"]) == QATPolicy(forward="stat")


def test_restore_adopts_plan_and_rejects_mismatch(tmp_path):
    loop, stream, init = _loop(tmp_path, total_steps=4)
    params, opt, start = loop.init_or_restore(init)
    loop.run(params, opt, stream, start)
    loop2, _, init2 = _loop(tmp_path, total_steps=4, plan=None, policy=None)
    loop2.init_or_restore(init2)
    assert loop2.cfg.plan == _PLAN and loop2.cfg.qat == QATPolicy(forward="stat")
    other = splan.SubstratePlan.uniform("approx_bitexact:proposed@6")
    loop3, _, init3 = _loop(tmp_path, total_steps=4, plan=other)
    with pytest.raises(ValueError, match="plan"):
        loop3.init_or_restore(init3)
    loop4, _, init4 = _loop(tmp_path, total_steps=4, policy=QATPolicy())
    with pytest.raises(ValueError, match="QAT policy"):
        loop4.init_or_restore(init4)


def test_adopted_plan_governs_resumed_contractions(tmp_path):
    """A plan-less, policy-less resume continues bit for bit as one that
    configures the checkpoint's plan and policy: the bundle has no
    dot_plan, so only the adopted scopes can supply the numerics."""
    seed_loop, stream, init = _loop(tmp_path / "a", total_steps=4)
    params, opt, start = seed_loop.init_or_restore(init)
    seed_loop.run(params, opt, stream, start)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    loop_e, stream_e, init_e = _loop(tmp_path / "a", total_steps=8)
    pe, oe, se = loop_e.init_or_restore(init_e)
    pe, _, _ = loop_e.run(pe, oe, stream_e, se)
    loop_a, stream_a, init_a = _loop(tmp_path / "b", total_steps=8, plan=None,
                                     policy=None)
    pa, oa, sa = loop_a.init_or_restore(init_a)
    assert sa == 4 and loop_a.cfg.plan == _PLAN
    pa, _, _ = loop_a.run(pa, oa, stream_a, sa)
    _same(pe, pa)


def test_repro_checkpoint_resumes_in_the_port(tmp_path):
    """repro's TrainLoop checkpoint (params + AdamW state, bf16) restores
    in the port's TrainLoop bit for bit, with its plan and policy adopted;
    and the port's next checkpoint restores in repro's TrainLoop."""
    _resume_both_ways(tmp_path, "minitron-8b", {}, "approx_bitexact:proposed@8")


def test_repro_moe_adafactor_checkpoint_resumes_in_the_port(tmp_path):
    """The same for an MoE config with the launcher's optimizer, Adafactor
    on repro's stacked tree: its state in repro's ``{"step", "mv"}`` tree
    leaf for leaf (a stacked norm scale's shared ``vc`` included), both
    ways."""
    _resume_both_ways(tmp_path, MOE_SMALL["arch"], dict(n_layers=4, n_experts=4),
                      "approx_lut:proposed@8")


def _resume_both_ways(tmp_path, arch, over, plan):
    jcfg = jreg.get_config(arch, **{**SMALL, **over})
    jb = jreg.build_bundle(jcfg)
    b = reg.build_bundle(port_cfg(jcfg))
    moe = bool(jcfg.n_experts)
    jopt = jadafactor if moe else jadamw
    jloop = JLoop(jb.loss_fn, jopt(), JConfig(
        total_steps=4, ckpt_every=4, ckpt_dir=str(tmp_path), async_ckpt=False,
        qat=JPolicy(), plan=jplan.as_plan(plan)))
    jp, jo, js = jloop.init_or_restore(lambda: jb.init_params(jax.random.PRNGKey(1)))
    jp, jo, _ = jloop.run(jp, jo, JStream(vocab=64, batch=4, seq_len=16, seed=0), js)

    loop = TrainLoop(b.loss_fn, adafactor(b.layout) if moe else adamw(), TrainLoopConfig(
        total_steps=5, ckpt_every=5, ckpt_dir=str(tmp_path), async_ckpt=False),
        layout=b.layout)
    p, o, start = loop.init_or_restore(lambda: b.init_params(torch.Generator().manual_seed(0)))
    assert start == 4 and loop.cfg.plan == splan.as_plan(plan)
    assert loop.cfg.qat == QATPolicy()
    assert p.embed.emb.dtype == torch.bfloat16
    assert convert.keyed_by_path(o) == moe
    got = {"params": convert.lm_params_to_jax(b.cfg, p),
           "opt": convert.state_to_jax(b.layout, o)}
    want = {"params": jp, "opt": jo}
    assert jax.tree.structure(jax.tree.map(np.asarray, want)) == \
        jax.tree.structure(got)
    for a, c in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(_bytes(a), _bytes(c))
    p, o, _ = loop.run(p, o, SyntheticLMStream(vocab=64, batch=4, seq_len=16, seed=0),
                       start)
    jloop2 = JLoop(jb.loss_fn, jopt(), JConfig(total_steps=5, ckpt_dir=str(tmp_path)))
    jp5, jo5, js5 = jloop2.init_or_restore(lambda: jb.init_params(jax.random.PRNGKey(2)))
    assert js5 == 5 and jloop2.cfg.plan == jplan.as_plan(plan)
    for a, c in zip(jax.tree.leaves({"params": jp5, "opt": jo5}), jax.tree.leaves(
            {"params": convert.lm_params_to_jax(b.cfg, p),
             "opt": convert.state_to_jax(b.layout, o)})):
        np.testing.assert_array_equal(_bytes(a), _bytes(c))


# ---------------------------------------------------------------------------
# remat, threads, and the trained embedding served afterwards
# ---------------------------------------------------------------------------


def _grads(bundle, params, batch, plan, policy, thread=False):
    """The loss's gradients under the scopes; the backward on another
    thread when asked (where the scopes are not set, as on autograd's
    device thread on the card)."""
    params.requires_grad_(True)
    out = {}
    with splan.plan_override_scope(plan), qat_scope(policy):
        loss = bundle.loss_fn(params, batch)
        if thread:
            t = threading.Thread(target=lambda: out.update(
                g=torch.autograd.grad(loss, list(params.parameters()))))
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
        else:
            out["g"] = torch.autograd.grad(loss, list(params.parameters()))
    params.requires_grad_(False)
    return loss.detach(), out["g"]


def test_remat_changes_no_number_and_recomputes_under_the_forwards_scopes():
    _remat_check("minitron-8b", SMALL)


#: the recurrent families at tests/test_models_smoke.py's reduced sizes (zamba:
#: 6 layers, the shared block after layers 2 and 5)
RECURRENT_SMALL = {
    "xlstm-125m": dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                       vocab=64),
    "zamba2-1.2b": dict(n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                        vocab=64, shared_attn_every=3, ssm_state=8)}


@pytest.mark.parametrize("arch", list(RECURRENT_SMALL))
def test_recurrent_remat_changes_no_number_and_recomputes_under_the_forwards_scopes(
        arch):
    """The same for xlstm (each layer a checkpointed region) and zamba (each
    mamba layer and each run of the shared block, which a plan rule puts on
    its own substrate)."""
    _remat_check(arch, RECURRENT_SMALL[arch])


def _remat_check(arch, size):
    """Gradients with and without remat, the backward on this thread and on
    another (where the scopes are not set): all bit for bit equal, under a
    plan that gives layer 1 (and zamba's shared FFN) other substrates."""
    plan = splan.as_plan({"version": 1, "default": "approx_bitexact:proposed@8",
                          "rules": [{"site": "layer.1.*", "spec": "approx_lut:csp_axc1@6"},
                                    {"site": "shared.ffn.*",
                                     "spec": "approx_lut:csp_axc5@7"}]})
    batch = {k: torch.from_numpy(v).long() for k, v in _batch().items()}
    runs = {}
    for remat in (False, True):
        bundle = reg.get_bundle(arch, **size, remat=remat)
        params = bundle.init_params(torch.Generator().manual_seed(3))
        for thread in (False, True):
            runs[remat, thread] = _grads(bundle, params, batch, plan, QATPolicy(),
                                         thread=thread)
    ref_loss, ref_g = runs[False, False]
    assert all(float(g.abs().max()) > 0 for g in ref_g)
    for loss, g in runs.values():
        assert torch.equal(loss, ref_loss)
        assert all(torch.equal(a, b) for a, b in zip(g, ref_g))


def test_served_logits_after_training_use_the_trained_embedding(tmp_path):
    """After a step, decode logits equal those of a model built afresh from
    the trained parameters: no stale float32 copy of the embedding. In
    bfloat16, where the float32 copy is a copy (in float32 ``.to`` returns
    the tensor itself)."""
    b = reg.get_bundle("minitron-8b", **SMALL)
    p = b.init_params(torch.Generator().manual_seed(5))
    assert p.embed.emb.dtype == torch.bfloat16
    token = torch.tensor([[3], [9]])

    def logits(params):
        return b.decode_step(params, b.init_decode_state(2, 8), {"token": token,
                                                                 "cache_len": 0})[0]

    before = logits(p)
    loop = TrainLoop(b.loss_fn, adamw(), TrainLoopConfig(total_steps=1,
                                                         ckpt_dir=str(tmp_path)),
                     layout=b.layout)
    loop.step(p, loop.optimizer.init(convert.named_leaves(p)),
              {k: torch.from_numpy(v).long() for k, v in _batch().items()}, 1e-2)
    fresh = convert.lm_params_from_jax(b.cfg, convert.lm_params_to_jax(b.cfg, p))
    after = logits(p)
    assert not torch.equal(after, before)
    assert torch.equal(after, logits(fresh))
    assert torch.equal(p.embed.emb_f32, p.embed.emb.float())


def test_float32_embedding_follows_a_replaced_parameter_and_is_cast_once():
    """A new ``emb`` Parameter is recast even where its address and version
    counter could match the old one's (the cache holds a weak reference to
    its source); workers reading it together share one cast."""
    b = reg.get_bundle("minitron-8b", **SMALL)
    p = b.init_params(torch.Generator().manual_seed(5))
    first = p.embed.emb_f32
    assert p.embed.emb_f32 is first
    new = torch.nn.Parameter(p.embed.emb.detach() + 1, requires_grad=False)
    key = p.embed._f32[0]
    p.embed.emb = new
    # the cache key as it would be had the allocator reused the address
    p.embed._f32 = ((key[0], new.data_ptr(), new._version), first)
    assert torch.equal(p.embed.emb_f32, new.float())
    p.embed._f32 = (None, None)
    casts = []
    threads = [threading.Thread(target=lambda: casts.append(p.embed.emb_f32))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(casts) == 4 and all(c is casts[0] for c in casts)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_train_launcher_runs_on_the_cpu_and_serve_restores_its_bundle(tmp_path, capsys):
    bundle_dir = tmp_path / "bundle"
    loop, params = launch_train.main(FLAGS + [
        "--device", "cpu", "--batch", "4", "--seq-len", "16", "--steps", "6",
        "--ckpt-every", "3", "--ckpt-dir", str(tmp_path / "ckpt"), "--qat",
        "--dot-mode", "approx_pallas:proposed@8", "--qat-out", str(bundle_dir),
        "--metrics-out", str(tmp_path / "m.json")])
    text = capsys.readouterr().out
    assert "plan=plan(approx_pallas:proposed@8) qat=bitexact" in text
    assert "wrote plan bundle" in text and "device=cpu" in text
    assert len(loop.metrics["losses"]) == 6
    assert json.loads((tmp_path / "m.json").read_text())["final_loss"] is not None
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_0000000003", "step_0000000006"]
    # a second run resumes from step 6: nothing left to do
    loop2, _ = launch_train.main(FLAGS + [
        "--device", "cpu", "--steps", "6", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert loop2.metrics["resumed_from"] == 6 and loop2.cfg.qat == QATPolicy()
    # the bundle: repro reads it, and serve --plan DIR restores its params
    jplan_, jparams, jextra = jckpt.load_plan_bundle(str(bundle_dir))
    assert jplan_ == jplan.as_plan("approx_pallas:proposed@8")
    assert jextra["qat"] == {"forward": "bitexact", "moment_correction": False}
    assert "embed/emb" in jparams and "unit/0/attn/wq/w" in jparams
    out = launch_serve.main(FLAGS + ["--device", "cpu", "--requests", "2",
                                     "--max-tokens", "3", "--plan", str(bundle_dir)])
    assert [len(r.output) for r in out] == [3, 3]
    # the served model holds the trained params: greedy outputs equal an
    # engine's over them
    from repro_torch.serving import Request, ServingEngine

    cfg = reg.get_config("minitron-8b", **SMALL)
    eng = ServingEngine(reg.build_bundle(cfg), params, batch_size=2, max_len=128,
                        substrate="approx_pallas:proposed@8", device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=list(rng.integers(1, 64, size=4)), max_tokens=3,
                    temperature=0.0 if i % 2 == 0 else 0.8) for i in range(2)]
    eng.generate(reqs)
    assert reqs[0].output == out[0].output


def test_train_launcher_refuses_without_a_card_and_meshes(tmp_path):
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        launch_train.main(FLAGS + ["--device", "cpu", "--mesh", "debug"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            launch_train.main(FLAGS + ["--ckpt-dir", str(tmp_path)])


def _repro_restores(ckpt_dir, jcfg, jopt):
    """repro's ``load_checkpoint`` of the newest step into its own template
    (its params and ``jopt``'s state, as shapes), which raises on a missing
    leaf or a shape that differs; returns the restored tree after checking
    that the checkpoint holds no leaf the template lacks."""
    jb = jreg.build_bundle(jcfg)
    params = jax.eval_shape(jb.init_params, jax.random.PRNGKey(0))
    template = {"params": params, "opt": jax.eval_shape(jopt.init, params)}
    tree, step, _ = jckpt.load_checkpoint(str(ckpt_dir), template)
    step_dir = ckpt_dir / f"step_{step:010d}"
    with np.load(step_dir / "arrays.npz") as z:
        assert len(z.files) == len(jax.tree.leaves(template))
    return tree


@pytest.mark.parametrize("flags", [
    ["--arch", "llama4-maverick-400b-a17b", "--n-layers", "2", "--d-model", "32",
     "--d-ff", "64", "--vocab", "64", "--n-heads", "2", "--n-kv-heads", "2",
     "--n-experts", "4"],
    FLAGS + ["--n-experts", "4"],
], ids=["llama4-maverick", "minitron-with-experts"])
def test_train_launcher_refuses_moe_configs(tmp_path, flags):
    """The launcher trains MoE configs (it once refused them) with repro's
    choice of optimizer, Adafactor on repro's stacked tree: the checkpoint
    it writes restores in repro's loader into repro's template of the
    params and ``adafactor()``'s state, leaf for leaf, a stacked norm
    scale's statistics factored."""
    loop, params = launch_train.main(flags + [
        "--device", "cpu", "--batch", "2", "--seq-len", "16", "--steps", "2",
        "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(loop.metrics["losses"]) == 2 and all(
        np.isfinite(loop.metrics["losses"]))
    n_layers = int(flags[flags.index("--n-layers") + 1])
    jcfg = jreg.get_config(flags[1], **{
        k: int(flags[flags.index(f"--{k.replace('_', '-')}") + 1])
        for k in ("n_layers", "d_model", "d_ff", "vocab", "n_heads", "n_kv_heads",
                  "n_experts")})
    tree = _repro_restores(tmp_path / "ckpt", jcfg, jadafactor())
    period = len(tree["params"]["unit"])
    ln = tree["opt"]["mv"]["unit"][0]["attn"]["ln"]
    assert set(ln) == {"vr", "vc"} and ln["vr"].shape == (n_layers // period,)
    want = convert.named_leaves(params)
    back = loop.layout.from_tree(jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)), tree["params"]))
    assert all(torch.equal(want[k].float(), back[k]) for k in want)


@pytest.mark.parametrize("arch", list(RECURRENT_SMALL))
def test_train_launcher_trains_the_recurrent_families(tmp_path, arch):
    """xlstm and zamba train through the launcher with AdamW, as repro's
    launcher trains them; the checkpoint restores in repro's loader into
    repro's template, the parameters bit for bit."""
    size = RECURRENT_SMALL[arch]
    flags = ["--arch", arch] + [a for k in ("n_layers", "d_model", "n_heads",
                                            "n_kv_heads", "d_ff", "vocab")
                                for a in (f"--{k.replace('_', '-')}", str(size[k]))]
    loop, params = launch_train.main(flags + [
        "--device", "cpu", "--batch", "2", "--seq-len", "16", "--steps", "2",
        "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(loop.metrics["losses"]) == 2 and all(
        np.isfinite(loop.metrics["losses"]))
    jcfg = jreg.get_config(arch, **{k: size[k] for k in (
        "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab")})
    tree = _repro_restores(tmp_path / "ckpt", jcfg, jadamw())
    want = convert.named_leaves(params)
    back = loop.layout.from_tree(jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)), tree["params"]))
    assert set(back) == set(want)
    assert all(torch.equal(want[k].float(), back[k]) for k in want)


def test_parse_plan_arg_cli_forms(tmp_path):
    from repro_torch.launch.train import parse_plan_arg

    assert parse_plan_arg("approx_bitexact:proposed@6").default == \
        "approx_bitexact:proposed@6"
    p = splan.SubstratePlan(default="exact",
                            rules=(("conv.edge.*", "approx_lut:proposed"),))
    assert parse_plan_arg(p.to_json()) == p
    path = tmp_path / "plan.json"
    splan.save_plan(str(path), p)
    assert parse_plan_arg(str(path)) == p
