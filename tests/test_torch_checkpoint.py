"""The port's checkpoints and plan bundles against ``repro``'s, on the CPU.

The port keeps ``repro``'s on-disk formats (``step_%010d/`` with
``arrays.npz`` + ``manifest.json``; a bundle's ``plan.json`` +
``manifest.json`` + ``arrays.npz``; ``/``-joined keys; bf16 as a ``uint16``
container named in ``dtypes``), so a directory written by either package
restores in the other. The first cases mirror ``tests/test_infra.py``'s
checkpoint cases on the port; the rest write with one package and read with
the other, bf16 leaves, LM parameters and AdamW state (through
``models.convert``) included. Every comparison is exact.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.models import encdec as jed
from repro.models import lm as jlm
from repro.nn import plan as jplan
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import (CheckpointManager, list_steps, load_checkpoint,
                                    load_plan_bundle, save_checkpoint,
                                    save_plan_bundle)
from repro_torch.checkpoint.ckpt import tree_leaves, tree_map
from repro_torch.models import convert
from repro_torch.models import registry as reg
from repro_torch.nn import plan as tplan
from repro_torch.optim import adamw
from tests.test_models_smoke import reduced
from tests.test_torch_models import port_cfg

RNG = np.random.default_rng(11)


def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "nest": {"b": torch.ones((4,), dtype=torch.int32)},
            "lst": [torch.zeros((2,)), torch.full((3,), 7.0)]}


def _leaves(tree):
    return [t for _, t in tree_leaves(tree)]


def _bits(x) -> np.ndarray:
    """The bytes of a tensor or a numpy array (bf16 from either side)."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _mixed():
    """A numpy tree of every stored kind: float32, int32, bf16, 0-d, lists."""
    return {"w": RNG.normal(size=(3, 5)).astype(np.float32),
            "e": RNG.normal(size=(4, 2)).astype(jnp.bfloat16),
            "step": np.asarray(7, np.int32),
            "layers": [{"k": RNG.normal(size=(2,)).astype(np.float32)},
                       {"k": RNG.normal(size=(2,)).astype(jnp.bfloat16)}]}


def _torch_tree(tree):
    return tree_map(tree, lambda a: torch.from_numpy(
        np.array(a.view(np.int16))).view(torch.bfloat16)
        if a.dtype.name == "bfloat16" else torch.from_numpy(np.array(a)))


# ---------------------------------------------------------------------------
# the port alone (tests/test_infra.py's checkpoint cases)
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 5, t)
    out, step, _ = load_checkpoint(str(tmp_path), t)
    assert step == 5
    for a, b in zip(_leaves(t), _leaves(out)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_checkpoint_atomicity_tmp_ignored(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    os.makedirs(tmp_path / "step_0000000009.tmp")  # a crashed save
    (tmp_path / "step_0000000009.tmp" / "arrays.npz").write_bytes(b"garbage")
    os.makedirs(tmp_path / "step_0000000007")  # renamed, no manifest
    assert list_steps(str(tmp_path)) == [1]
    _, step, _ = load_checkpoint(str(tmp_path), t)
    assert step == 1


def test_checkpoint_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert list_steps(str(tmp_path)) == [3, 4]


def test_checkpoint_async_snapshots_before_in_place_updates(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = _tree()
    mgr.save_async(11, t)
    t["a"].add_(100.0)  # the training step updates in place
    mgr.wait()
    assert mgr.latest_step() == 11
    out, _, _ = mgr.restore(_tree())
    assert torch.equal(out["a"], _tree()["a"])


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.ones((2,))})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(str(tmp_path), {"a": torch.ones((3,))})
    with pytest.raises(KeyError, match="missing leaf"):
        load_checkpoint(str(tmp_path), {"b": torch.ones((2,))})


def test_meta_template_and_device(tmp_path):
    """A template of meta tensors allocates nothing; the leaves land on the
    device asked for, else the CPU."""
    t = _tree()
    save_checkpoint(str(tmp_path), 2, t)
    meta = tree_map(t, lambda x: x.to("meta"))
    out, _, _ = load_checkpoint(str(tmp_path), meta)
    assert all(x.device.type == "cpu" for x in _leaves(out))
    out, _, _ = load_checkpoint(str(tmp_path), meta, device="cpu")
    assert torch.equal(out["lst"][1], t["lst"][1])


def test_unknown_container_dtype_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.ones((2,))})
    path = tmp_path / "step_0000000001" / "manifest.json"
    m = json.loads(path.read_text())
    m["dtypes"] = {"a": "float8_e4m3fn"}
    path.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        load_checkpoint(str(tmp_path), {"a": torch.ones((2,))})


# ---------------------------------------------------------------------------
# across the packages: checkpoints and bundles
# ---------------------------------------------------------------------------


def test_repro_checkpoint_restores_in_the_port(tmp_path):
    tree = _mixed()
    jckpt.save_checkpoint(str(tmp_path), 3, jax.tree.map(jnp.asarray, tree),
                          extra={"note": "jax"})
    out, step, extra = load_checkpoint(str(tmp_path), _torch_tree(tree))
    assert step == 3 and extra == {"note": "jax"}
    assert out["e"].dtype == torch.bfloat16 and out["step"].dtype == torch.int32
    for (pa, a), (pb, b) in zip(tree_leaves(tree), tree_leaves(out)):
        assert pa == pb
        np.testing.assert_array_equal(_bits(b), _bits(a))


def test_port_checkpoint_restores_in_repro(tmp_path):
    tree = _mixed()
    save_checkpoint(str(tmp_path), 4, _torch_tree(tree), extra={"note": "torch"})
    manifest = json.loads((tmp_path / "step_0000000004" / "manifest.json").read_text())
    assert manifest["dtypes"] == {"e": "bfloat16", "layers/1/k": "bfloat16"}
    assert manifest["n_arrays"] == 5
    out, step, extra = jckpt.load_checkpoint(str(tmp_path),
                                             jax.tree.map(jnp.asarray, tree))
    assert step == 4 and extra == {"note": "torch"}
    assert out["e"].dtype == jnp.bfloat16
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(out)):
        np.testing.assert_array_equal(_bits(np.asarray(b)), _bits(a))


_PLAN = {"version": 1, "default": "approx_pallas:proposed@8",
         "rules": [{"site": "conv.edge.center", "spec": "exact"},
                   {"site": "layer.0.*", "spec": "approx_lut:csp_axc1@6"}]}


@pytest.mark.parametrize("with_params", [False, True])
def test_bundles_cross_both_ways(tmp_path, with_params):
    tree = _mixed() if with_params else None
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_plan_bundle(jdir, jplan.as_plan(_PLAN),
                           None if tree is None else jax.tree.map(jnp.asarray, tree),
                           extra={"by": "jax"})
    save_plan_bundle(tdir, _PLAN, None if tree is None else _torch_tree(tree),
                     extra={"by": "torch"})
    for d in (jdir, tdir):
        assert sorted(os.listdir(d)) == (["arrays.npz"] if with_params else []) + [
            "manifest.json", "plan.json"]
    plan, params, extra = load_plan_bundle(jdir)
    assert plan == tplan.as_plan(_PLAN) and extra == {"by": "jax"}
    jp, jparams, jextra = jckpt.load_plan_bundle(tdir)
    assert jp == jplan.as_plan(_PLAN) and jextra == {"by": "torch"}
    if not with_params:
        assert params is None and jparams is None
        with pytest.raises(ValueError, match="no params"):
            load_plan_bundle(jdir, {"w": torch.ones(1)})
        return
    assert set(params) == set(jparams) == {"w", "e", "step", "layers/0/k",
                                           "layers/1/k"}
    for k in params:
        np.testing.assert_array_equal(_bits(params[k]), _bits(jparams[k]))
    _, restored, _ = load_plan_bundle(jdir, _torch_tree(tree))
    for a, b in zip(jax.tree.leaves(tree), _leaves(restored)):
        np.testing.assert_array_equal(_bits(b), _bits(a))


def test_not_a_bundle_raises(tmp_path):
    save_plan_bundle(str(tmp_path / "b"), "exact")
    (tmp_path / "b" / "manifest.json").write_text(json.dumps({"kind": "x"}))
    with pytest.raises(ValueError, match="not a substrate-plan bundle"):
        load_plan_bundle(str(tmp_path / "b"))


# ---------------------------------------------------------------------------
# LM params and AdamW state in repro's layout (models.convert)
# ---------------------------------------------------------------------------


def _lm_pair(name="minitron-8b", **extra):
    jcfg = reduced(name, vocab=128, **extra)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    cfg = port_cfg(jcfg)
    return jcfg, jparams, cfg, convert.lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("name,extra", [("minitron-8b", {}),
                                        ("qwen1.5-32b", {}),
                                        ("gemma3-27b", {"n_layers": 8})])
def test_lm_params_to_jax_inverts_from_jax(name, extra):
    """Unit stacking (gemma3: period 6, one unit and a tail of 2), QKV
    biases and bf16 leaves, bit for bit."""
    _, jparams, cfg, params = _lm_pair(name, **extra)
    back = convert.lm_params_to_jax(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(_bits(b), _bits(np.asarray(a)))


def test_lm_checkpoint_with_adamw_state_crosses_both_ways(tmp_path):
    """repro's {"params", "opt"} after one AdamW step restores in the port
    (lm_layout) and back, every leaf bit for bit; adamw_state_to_jax /
    adamw_state_from_jax give the same trees."""
    jcfg, jparams, cfg, _ = _lm_pair()
    opt = jadamw()
    jstate = opt.init(jparams)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.5, jparams)
    jparams, jstate = opt.update(grads, jstate, jparams, jnp.float32(1e-3))
    jtree = {"params": jparams, "opt": jstate}
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, jtree)

    layout = reg.build_bundle(cfg).layout
    params = reg.build_bundle(cfg).init_params(torch.Generator().manual_seed(0))
    leaves = convert.named_leaves(params)
    state = adamw().init(leaves)
    template = {"params": layout.to_tree({k: t.to("meta") for k, t in leaves.items()}),
                "opt": layout.state_to_tree(tree_map(state, lambda t: t.to("meta")))}
    tree, step, _ = load_checkpoint(str(tmp_path / "j"), template)
    assert step == 1
    convert.assign_(params, layout.from_tree(tree["params"]))
    state = layout.state_from_tree(tree["opt"])
    assert int(state["step"]) == 1 and set(state["mv"]) == set(leaves)
    want = {"params": jax.tree.map(np.asarray, jparams),
            "opt": jax.tree.map(np.asarray, jstate)}
    got = {"params": convert.lm_params_to_jax(cfg, params),
           "opt": convert.adamw_state_to_jax(cfg, state)}
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(_bits(b), _bits(a))
    again = convert.adamw_state_from_jax(cfg, want["opt"])
    for k in leaves:
        for s in ("m", "v"):
            assert torch.equal(again["mv"][k][s], state["mv"][k][s])

    # and back: the port writes, repro restores into its own tree
    save_checkpoint(str(tmp_path / "t"), 2,
                    {"params": layout.to_tree(convert.named_leaves(params)),
                     "opt": layout.state_to_tree(state)})
    out, step, _ = jckpt.load_checkpoint(str(tmp_path / "t"), jtree)
    assert step == 2
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(out)):
        np.testing.assert_array_equal(_bits(np.asarray(b)), _bits(np.asarray(a)))


def test_assign_refuses_what_does_not_fit():
    _, _, cfg, params = _lm_pair()
    flat = {k: t.clone() for k, t in convert.named_leaves(params).items()}
    bad = dict(flat)
    bad["embed.ln_f"] = bad["embed.ln_f"].to(torch.float64)
    with pytest.raises(ValueError, match="does not fit"):
        convert.assign_(params, bad)
    bad = dict(flat)
    del bad["embed.emb"]
    with pytest.raises(KeyError, match="missing"):
        convert.assign_(params, bad)
    convert.assign_(params, flat)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "llama4-maverick-400b-a17b",
                                  "paligemma-3b", "whisper-large-v3"])
def test_family_params_cross_both_ways(tmp_path, arch):
    """The MoE units (bare expert arrays stacked over units, the router, the
    shared FFN), the vlm's top-level ``patch_proj`` and the encoder-decoder's
    ``enc`` / ``dec`` stacked over layers: through ``models.convert`` both
    ways, then a plan bundle written by ``repro`` restored in the port
    through ``bundle.layout`` and one written by the port restored in
    ``repro``; every leaf bit for bit, bf16 weights included."""
    jcfg = reduced(arch, vocab=128)
    assert jcfg.dtype == jnp.bfloat16
    encdec = jcfg.family == "encdec"
    jparams = (jed if encdec else jlm).init_params(jcfg, jax.random.PRNGKey(3))
    cfg = port_cfg(jcfg)
    from_jax, to_jax = ((convert.encdec_params_from_jax, convert.encdec_params_to_jax)
                        if encdec else (convert.lm_params_from_jax,
                                        convert.lm_params_to_jax))
    params = from_jax(cfg, jax.tree.map(np.asarray, jparams))
    back = to_jax(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(_bits(b), _bits(np.asarray(a)))
    if jcfg.n_experts:  # e.g. maverick's unit[1]["moe"]["wi"]: (1, 4, 64, 128)
        moe = [u["moe"] for u in jparams["unit"] if "moe" in u][0]
        assert moe["wi"].ndim == 4 and moe["router"].dtype == jnp.float32

    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_plan_bundle(jdir, jplan.as_plan(_PLAN), jparams)
    bundle = reg.build_bundle(cfg)
    fresh = bundle.init_params(torch.Generator().manual_seed(0))
    template = bundle.layout.to_tree({k: t.to("meta") for k, t in
                                      convert.named_leaves(fresh).items()})
    _, tree, _ = load_plan_bundle(jdir, template)
    convert.assign_(fresh, bundle.layout.from_tree(tree))
    want = convert.named_leaves(params)
    for name, t in convert.named_leaves(fresh).items():
        assert t.dtype == want[name].dtype, name
        np.testing.assert_array_equal(_bits(t), _bits(want[name]))

    save_plan_bundle(tdir, _PLAN, bundle.layout.to_tree(convert.named_leaves(params)))
    _, out, _ = jckpt.load_plan_bundle(tdir, jparams)
    assert jax.tree.structure(out) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(out)):
        np.testing.assert_array_equal(_bits(np.asarray(b)), _bits(np.asarray(a)))
