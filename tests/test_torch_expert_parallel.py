"""Expert parallelism, the compressed data-parallel step and the mesh
launcher against ``repro``'s, on CPU ranks.

The port's side runs on ``gloo`` ranks (``tests/test_torch_ranks.py``);
``repro``'s once per module in a subprocess with 4 forced host devices, a
2 × 2 ``("data", "model")`` mesh with Auto axes (and the 4-device "data"
mesh of ``tests/test_distributed.py`` for the data-parallel step).

* ``moe_block`` at llama4-maverick's smoke widths (d_model 32, d_ff 64, 2
  heads, 4 experts, float32), each rank given its data shard of the batch
  and its 2 of 4 experts, under the 2 × 2 mesh, against ``repro``'s
  ``moe_block`` under the mesh (its ``_moe_block_ep``): the output, and
  each rank's dispatch (slots and kept choices equal, weights to 1e-6), in
  four cases — top-1, top-2, a capacity nothing overflows, and one most
  choices overflow (the per-shard capacity drops other tokens than the
  local path, as in ``repro``). Then the gradient of Σ y · c at the
  input, the router, each expert shard, the norm and the shared expert,
  against ``jax.grad`` of ``repro``'s: the data ranks' gradients summed
  (each rank's loss is its shard's part of the sum), the model replicas'
  equal. Tolerances: rtol 1e-4 with an absolute 1e-6 of the leaf's largest
  gradient (XLA and torch round the float32 forward and backward a few
  ulps apart). A top-1 router's gradient is zero in exact arithmetic (the
  one choice's renormalised weight is 1): both packages' are rounding, held
  below 1e-6 of the largest gradient.
* ``compress_int8`` / ``decompress_int8`` bit for bit (half to even), and
  ``compressed_psum`` and ``dp_train_step_compressed`` (``compress`` on and
  off) on 4 ranks against ``repro``'s on 4 devices: the reduced trees bit
  for bit, the step's loss and parameters within 1e-6.
* ``python -m repro_torch.launch.train --mesh debug`` (its ``main``) on 1,
  2 and 4 ranks for a dense and an MoE config at smoke sizes: every leaf
  equal on the ranks that replicate it, the losses finite and equal on
  every rank, the MoE's (no token dropped) within 1e-5 of the single
  rank's, and rank 0's checkpoint restored by ``repro``'s loader into its
  own template with the gathered parameters, and so is its ``--qat-out``
  bundle by ``repro``'s bundle loader; the MoE runs restarted from
  that checkpoint (each rank restoring its expert shard) end bit for bit
  where an uninterrupted run does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.models import registry as jreg
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import grad_utils as jgu
from repro_torch.optim import grad_utils
from tests import test_torch_ranks as tr

REPRO = """
import numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.models import common as jcm
from repro.models import registry as jreg
from tests import test_torch_ranks as tr

for case, (top_k, cf) in tr.MOE_CASES.items():
    cfg = jreg.get_config("llama4-maverick-400b-a17b", dtype=jnp.float32,
                          top_k=top_k, capacity_factor=cf, dot_plan="exact",
                          **tr.MOE_OVERRIDES)
    x, c, tree = tr.moe_inputs(case)
    p = jax.tree.map(jnp.asarray, tree)

    # jitted, the parameters as arguments: eager shard_map runs op by op
    block = jax.jit(lambda p, x, cfg=cfg: jcm.moe_block(cfg, p, x))
    grad = jax.jit(jax.grad(lambda x, p, c, cfg=cfg: jnp.sum(
        jcm.moe_block(cfg, p, x) * c), argnums=(0, 1)))
    with MESH:
        y = block(p, jnp.asarray(x))
        gx, gp = grad(jnp.asarray(x), p, jnp.asarray(c))
    OUT[(case, "y")] = np.asarray(y)
    OUT[(case, "y_local")] = np.asarray(jax.jit(
        lambda p, x, cfg=cfg: jcm.moe_block(cfg, p, x))(p, jnp.asarray(x)))
    OUT[(case, "gx")] = np.asarray(gx)
    OUT[(case, "gp")] = jax.tree.map(np.asarray, gp)
    t = tr.MOE_B * tr.MOE_S
    xn = jcm.rms_norm(jnp.asarray(x), p["ln"]).reshape(t, -1)
    for d in range(2):
        for m in range(2):
            mine = xn[d * t // 2:(d + 1) * t // 2][m * t // 4:(m + 1) * t // 4]
            _, (slot, topw, keep, cap) = jcm._dispatch_local(cfg, mine,
                                                             p["router"])
            OUT[(case, "route", d, m)] = (np.asarray(slot), np.asarray(topw),
                                          np.asarray(keep), cap)

# the data-parallel step, tests/test_distributed.py's case on 4 devices
from repro.optim import adamw
from repro.optim import grad_utils
from repro.train.loop import dp_train_step_compressed
from jax.experimental.shard_map import shard_map

dmesh = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
trees = []
for r in range(4):  # dp_program's trees
    rng = np.random.default_rng(100 + r)
    a = rng.normal(size=(5, 7)).astype(np.float32)
    trees.append({"a": a, "b": (rng.normal(size=(9,)) * 1e-3).astype(np.float32)})
stacked = {k: jnp.stack([t[k] for t in trees]) for k in ("a", "b")}
f = shard_map(lambda t: grad_utils.compressed_psum(
                  {k: v[0] for k, v in t.items()}, "data"),
              mesh=dmesh, in_specs=(P("data"),), out_specs=P(),
              check_rep=False)
OUT["psum"] = {k: np.asarray(v) for k, v in f(stacked).items()}

def loss_fn(params, batch):
    pred = batch["tokens"].astype(jnp.float32) @ params["w"]
    tgt = batch["labels"].astype(jnp.float32)
    return jnp.mean((pred - tgt[..., None]) ** 2)

batch = {k: jnp.asarray(v) for k, v in tr.dp_batch().items()}
with dmesh:
    for compress in (True, False):
        params = {"w": jnp.ones((16, 1), jnp.float32) * 0.1}
        opt = adamw(weight_decay=0.0)
        step = dp_train_step_compressed(loss_fn, opt, dmesh, compress=compress)
        loss, new, _ = step(params, opt.init(params), batch, jnp.float32(1e-2))
        OUT[("step", compress)] = (float(loss), np.asarray(new["w"]))
"""

CASES = list(tr.MOE_CASES)
LEAVES = ["x", "router", "wi", "wg", "wo", "ln", "shared.wi.w", "shared.wg.w",
          "shared.wo.w", "shared.ln"]


@pytest.fixture(scope="module")
def repro_out(tmp_path_factory):
    return tr.run_repro(REPRO, tmp_path_factory.mktemp("repro"))


@pytest.fixture(scope="module")
def moe_ranks(tmp_path_factory):
    return tr.spawn("moe_program", 4, tmp_path_factory.mktemp("moe"))


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    return tr.spawn("dp_program", 4, tmp_path_factory.mktemp("dp"))


def _rank(d, m):
    return d * 2 + m


def _leaf(tree, name):
    for seg in name.split("."):
        tree = tree[seg]
    return tree


def _assemble(ranks, case, name):
    """The port's whole gradient (or output) of ``name`` from the ranks'
    shards, after checking the model replicas agree."""
    def get(out):
        o = out[case]
        if name in ("y", "x"):
            return o[name].numpy()
        return o["grads"][name].numpy()

    if name in ("wi", "wg", "wo"):  # expert shards: sum over data
        return np.concatenate([get(ranks[_rank(0, m)]) + get(ranks[_rank(1, m)])
                               for m in range(2)], axis=0)
    for d in range(2):  # replicated over "model"
        np.testing.assert_array_equal(get(ranks[_rank(d, 0)]),
                                      get(ranks[_rank(d, 1)]))
    if name in ("y", "x"):  # rows of the data shards
        return np.concatenate([get(ranks[_rank(d, 0)]) for d in range(2)])
    return get(ranks[_rank(0, 0)]) + get(ranks[_rank(1, 0)])


def _close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * scale,
                               err_msg=what)


@pytest.mark.parametrize("case", CASES)
def test_moe_block_ep_output_matches_repro(moe_ranks, repro_out, case):
    y = _assemble(moe_ranks, case, "y")
    np.testing.assert_allclose(y, repro_out[(case, "y")], rtol=1e-4, atol=1e-5)
    if case == "no_drop":  # nothing dropped: the local path's output
        np.testing.assert_allclose(y, repro_out[(case, "y_local")],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_moe_block_ep_routing_matches_repro(moe_ranks, repro_out, case):
    dropped = 0
    for d in range(2):
        for m in range(2):
            (slot, topw, keep, cap), = moe_ranks[_rank(d, m)][case]["routes"]
            jslot, jtopw, jkeep, jcap = repro_out[(case, "route", d, m)]
            assert cap == jcap
            np.testing.assert_array_equal(slot.numpy(), jslot)
            np.testing.assert_array_equal(keep.numpy(), jkeep)
            np.testing.assert_allclose(topw.numpy(), jtopw, atol=1e-6)
            dropped += int((~keep).sum())
    assert (dropped == 0) == (case == "no_drop"), dropped


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("leaf", LEAVES)
def test_moe_block_ep_gradients_match_jax_grad(moe_ranks, repro_out, case,
                                               leaf):
    got = _assemble(moe_ranks, case, leaf)
    want = (repro_out[(case, "gx")] if leaf == "x"
            else _leaf(repro_out[(case, "gp")], leaf))
    if leaf == "router" and tr.MOE_CASES[case][0] == 1:
        scale = max(float(np.abs(_leaf(repro_out[(case, "gp")], n)).max())
                    for n in ("wi", "wg", "wo"))
        assert np.abs(got).max() <= 1e-6 * scale
        assert np.abs(want).max() <= 1e-6 * scale
        return
    _close(got, want, f"{case} {leaf}")


# ---------------------------------------------------------------------------
# int8 gradient compression and the data-parallel step
# ---------------------------------------------------------------------------


def test_compress_int8_matches_repro_half_to_even():
    rng = np.random.default_rng(4)
    g = rng.normal(size=(64,)).astype(np.float32)
    g[:4] = [1.0, -0.5 / 127, 2.5 / 127, -127.0 / 127]  # ties at scale 1/127
    q, s = grad_utils.compress_int8(torch.from_numpy(g))
    jq, js = jgu.compress_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    back = grad_utils.decompress_int8(q, s, torch.bfloat16)
    jback = jgu.decompress_int8(jq, js, jnp.bfloat16)
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(jback).astype(np.float32))


def test_compressed_psum_matches_repro(dp_ranks, repro_out):
    for rank, out in enumerate(dp_ranks):
        for k, want in repro_out["psum"].items():
            np.testing.assert_array_equal(out["psum"][k].numpy(), want,
                                          err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("compress", [True, False])
def test_dp_train_step_compressed_matches_repro(dp_ranks, repro_out, compress):
    jloss, jw = repro_out[("step", compress)]
    loss0, w0 = dp_ranks[0][("step", compress)]
    for out in dp_ranks:
        loss, w = out[("step", compress)]
        assert loss == loss0
        assert torch.equal(w, w0)
    assert abs(loss0 - jloss) <= 1e-6 * abs(jloss)
    np.testing.assert_allclose(w0.numpy(), jw, atol=1e-6)


# ---------------------------------------------------------------------------
# the mesh launcher
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def launcher_runs(tmp_path_factory):
    runs = {}
    for config in tr.TRAIN_CONFIGS:
        for world in ((1, 2, 4) if config == "moe" else (2, 4)):
            tmp = tmp_path_factory.mktemp(f"train_{config}_{world}")
            ckpt = tmp / "ckpt"
            runs[(config, world)] = (tr.spawn("train_program", world, tmp,
                                              config, str(ckpt)), ckpt)
    return runs


def _whole_params(ranks, world):
    """Every leaf of the whole model from the ranks: expert shards
    concatenated over "model", after checking each leaf equal on the ranks
    that replicate it."""
    from repro_torch.models import convert

    model = 2 if world % 2 == 0 else 1
    out = {}
    for name, t0 in ranks[0]["params"].items():
        if convert.is_expert_name(name) and model > 1:
            for m in range(model):
                for r in range(m, world, model):
                    assert torch.equal(ranks[r]["params"][name],
                                       ranks[m]["params"][name]), name
            out[name] = torch.cat([ranks[m]["params"][name]
                                   for m in range(model)])
        else:
            for r in range(world):
                assert torch.equal(ranks[r]["params"][name], t0), (name, r)
            out[name] = t0
    return out


@pytest.mark.parametrize("config,world", [("dense", 2), ("dense", 4),
                                          ("moe", 2), ("moe", 4)])
def test_mesh_launcher_replicas_losses_and_checkpoint(launcher_runs, config,
                                                      world):
    from repro_torch.models import registry as reg

    ranks, ckpt = launcher_runs[(config, world)]
    params = _whole_params(ranks, world)
    losses = ranks[0]["losses"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert all(r["losses"] == losses for r in ranks)
    if config == "moe":
        single = launcher_runs[("moe", 1)][0][0]["losses"]
        np.testing.assert_allclose(losses, single, rtol=1e-5)
    arch, _, fields = tr.TRAIN_CONFIGS[config]
    over = dict(n_layers=2, d_model=32, d_ff=64, vocab=64, n_heads=2,
                n_kv_heads=2, **fields)
    if config == "moe":
        over.update(n_experts=4)
    jcfg = jreg.get_config(arch, **over)
    jb = jreg.build_bundle(jcfg)
    jparams = jax.eval_shape(jb.init_params, jax.random.PRNGKey(0))
    jopt = jadafactor() if config == "moe" else jadamw()
    template = {"params": jparams, "opt": jax.eval_shape(jopt.init, jparams)}
    tree, step, _ = jckpt.load_checkpoint(str(ckpt), template)
    assert step == 2
    layout = reg.build_bundle(reg.get_config(arch, **over)).layout
    restored = layout.from_tree(jax.tree.map(np.asarray, tree["params"]))
    assert set(restored) == set(params)
    for name, t in params.items():
        np.testing.assert_array_equal(
            np.asarray(restored[name]).astype(np.float32),
            t.float().numpy(), err_msg=name)
    _, jbundle, _ = jckpt.load_plan_bundle(str(ckpt) + "_bundle", jparams)
    flat = layout.from_tree(jax.tree.map(np.asarray, jbundle))
    for name, t in params.items():  # rank 0's bundle: the whole model
        np.testing.assert_array_equal(np.asarray(flat[name]).astype(np.float32),
                                      t.float().numpy(), err_msg=name)
    if config == "moe":  # a restart from it: each rank's shard, bit for bit
        for r in ranks:
            assert r["resumed_from"] == 2
            for name, t in r["uninterrupted"].items():
                assert torch.equal(r["resumed"][name], t), name
