"""SPMD rank programs for the partitioned-path tests, and their harness.

The partitioned paths run one process per mesh rank. :func:`spawn` starts
``world`` CPU ranks on ``gloo`` (a ``file://`` rendezvous under the test's
``tmp_path``, so the test workers never share a port), runs one of the
programs below on every rank and returns each rank's results, which the
rank saved with ``torch.save``. This module imports no JAX: the ranks load
it, and ``repro``'s side runs in its own subprocess
(:func:`run_repro`, 4 forced host devices, a mesh with Auto axes).

The tests of this file check the collectives on their own: each against
the single-process sum, gather or exchange it stands for, and their
gradients against the transposes ``jax`` gives them.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, tmp: str, program: str, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    try:
        out = globals()[program](rank, world, *args)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(program: str, world: int, tmp_path, *args) -> list:
    """Run ``program(rank, world, *args)`` on ``world`` gloo ranks; its
    return value on each rank, in rank order."""
    tmp = Path(tmp_path) / f"{program}_{world}"
    tmp.mkdir(parents=True, exist_ok=True)
    mp.spawn(_rank_main, args=(world, str(tmp), program, args), nprocs=world)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def run_repro(code: str, tmp_path, n_devices: int = 4):
    """``repro``'s side in a subprocess with ``n_devices`` forced host
    devices; ``code`` leaves its results in ``OUT`` (a dict), which comes
    back unpickled."""
    out = Path(tmp_path) / "repro_out.pkl"
    prelude = textwrap.dedent(f"""
        import pickle
        import jax
        from jax.sharding import AxisType
        OUT = {{}}
        MESH = jax.make_mesh((2, 2), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    script = prelude + textwrap.dedent(code) + textwrap.dedent(f"""
        with open({str(out)!r}, "wb") as f:
            pickle.dump(OUT, f)
    """)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, timeout=600, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def debug_mesh():
    from repro_torch.launch import mesh as ml
    return ml.make_debug_mesh()


# ---------------------------------------------------------------------------
# rank programs: collectives
# ---------------------------------------------------------------------------


def collectives_program(rank, world):
    """Each collective over "model" and "data" of the 2 × 2 mesh, on a
    rank-dependent tensor, and the gradients of a weighted sum through it."""
    from repro_torch.nn import collectives as coll

    mesh = debug_mesh()
    out = {}
    for axis in ("data", "model"):
        x = (torch.arange(24, dtype=torch.float32).reshape(4, 6)
             + 100 * rank).requires_grad_(True)
        res = {
            "psum": coll.psum(x, mesh, axis),
            "psum_scatter": coll.psum_scatter(x, mesh, axis, dim=1),
            "all_gather": coll.all_gather(x, mesh, axis, dim=0),
            "all_to_all": coll.all_to_all(x, mesh, axis, split_axis=0,
                                          concat_axis=1),
            "pmax": coll.pmax(x, mesh, axis),
        }
        for name, y in res.items():
            out[(axis, name)] = y.detach()
            if y.requires_grad:
                wy = torch.ones_like(y) * (rank + 1)
                (g,) = torch.autograd.grad((y * wy).sum(), x)
                out[(axis, name, "grad")] = g
        out[(axis, "int32_psum")] = coll.psum(
            torch.full((3,), 2 ** 31 - 1 - rank, dtype=torch.int32), mesh, axis)
        out[(axis, "index")] = coll.axis_index(mesh, axis)
    return out


# ---------------------------------------------------------------------------
# rank programs: the sharded contraction
# ---------------------------------------------------------------------------

#: the grid of ``tests/test_dot_general.py::test_sharded_bit_identity_8_devices``
GRID_SPECS = ("exact", "int8", "approx_bitexact",
              "approx_bitexact:design_strollo2020", "approx_lut",
              "approx_lut:csp_axc1@4")
#: the port's kernel backend at the same products (its plain version here)
CUDA_SPECS = ("approx_cuda:proposed@8", "approx_cuda:design_strollo2020",
              "approx_cuda:csp_axc1@4")
SHAPES = ((8, 32, 8), (5, 19, 3), (16, 64, 4))
PARTS = (("data", None), (None, "model"), ("data", "model"))
FLOAT_SPECS = ("int8", "approx_bitexact", "approx_lut", "exact")


def grid_operands():
    """{(m, k, n): (a, b)} int8 operands, seeded."""
    rng = np.random.default_rng(3)
    return {s: (rng.integers(-128, 128, s[:2]).astype(np.int8),
                rng.integers(-128, 128, s[1:]).astype(np.int8)) for s in SHAPES}


def float_operands():
    rng = np.random.default_rng(5)
    return (rng.normal(size=(6, 40)).astype(np.float32),
            rng.normal(size=(40, 8)).astype(np.float32))


def contraction_program(rank, world):
    """Every grid case sharded and unsharded, the quantized float path,
    ``approx_stat`` at K = 19 and 32, and the batch-dimension refusal."""
    from repro_torch.nn import substrate as sub

    mesh = debug_mesh()
    out = {}
    ops = grid_operands()
    for spec in GRID_SPECS + CUDA_SPECS:
        s = sub.get_substrate(spec)
        for shape, (a, b) in ops.items():
            a_t, b_t = torch.from_numpy(a), torch.from_numpy(b)
            out[(spec, shape, "unsharded")] = s.dot_int(a_t, b_t)
            for m_axis, k_axis in PARTS:
                part = sub.Partitioning(mesh, m_axis=m_axis, k_axis=k_axis)
                out[(spec, shape, m_axis, k_axis)] = s.dot_general(
                    a_t, b_t, sub.ContractionSpec(partitioning=part))
    x, w = map(torch.from_numpy, float_operands())
    part = sub.Partitioning(mesh, m_axis="data", k_axis="model")
    for spec in FLOAT_SPECS:
        s = sub.get_substrate(spec)
        out[("float", spec, "unsharded")] = s.dot_general(
            x, w, sub.ContractionSpec.matmul(quant=sub.QuantPolicy()))
        out[("float", spec)] = s.dot_general(x, w, sub.ContractionSpec.matmul(
            quant=sub.QuantPolicy(), partitioning=part))
    stat = sub.get_substrate("approx_stat")
    rng = np.random.default_rng(7)
    for k in (19, 32):
        a = torch.from_numpy(rng.integers(-128, 128, (6, k)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-128, 128, (k, 4)).astype(np.int8))
        try:
            out[("stat", k)] = stat.dot_general(
                a, b, sub.ContractionSpec(partitioning=part))
        except ValueError as e:
            out[("stat", k)] = str(e)
    bdims = (((2,), (1,)), ((0,), (0,)))
    a3 = torch.ones((2, 3, 4), dtype=torch.int8)
    b3 = torch.ones((2, 4, 5), dtype=torch.int8)
    for spec in ("approx_lut", "exact"):
        try:
            sub.get_substrate(spec).dot_general(
                a3, b3, sub.ContractionSpec(bdims, partitioning=part))
            out[("batch", spec)] = None
        except NotImplementedError as e:
            out[("batch", spec)] = str(e)
    try:
        sub.get_substrate("exact").dot_general(
            a3.float(), b3.float(), sub.ContractionSpec(
                bdims, quant=sub.QuantPolicy(), partitioning=part))
        out[("batch", "exact_float")] = None
    except NotImplementedError as e:
        out[("batch", "exact_float")] = str(e)
    return out


# ---------------------------------------------------------------------------
# rank programs: the edge paths
# ---------------------------------------------------------------------------

#: (port spec, repro spec): the same products on both sides
EDGE_SPECS = (("approx_bitexact", "approx_bitexact"),
              ("approx_lut:design_strollo2020", "approx_lut:design_strollo2020"),
              ("approx_cuda:proposed@8", "approx_pallas:proposed@8"))
#: the planned path's plan, in both packages' schema
EDGE_PLAN = {"version": 1, "default": "approx_lut",
             "rules": [["conv.edge.center", "approx_lut:exact"],
                       ["conv.edge.ring", "approx_bitexact:csp_axc1@6"]]}
#: the mixed-shape request stream served on 4 ranks
SERVED_SHAPES = ((20, 30), (17, 33), (20, 30), (8, 8), (31, 17))


def edge_batch():
    return np.random.default_rng(11).integers(0, 256, (4, 12, 16),
                                              dtype=np.uint8)


def served_images():
    rng = np.random.default_rng(12)
    return [rng.integers(0, 256, s, dtype=np.uint8) for s in SERVED_SHAPES]


def edge_program(rank, world):
    """The batched and planned edge paths under the 2 × 2 partitioning, and
    ``EdgeDetectService(partitioning=)`` serving a mixed-shape stream."""
    from repro_torch.launch import mesh as ml
    from repro_torch.nn import conv
    from repro_torch.nn import plan as plan_mod
    from repro_torch.serving import EdgeDetectService

    mesh = debug_mesh()
    part = ml.contraction_partitioning(mesh)
    imgs = torch.from_numpy(edge_batch())
    out = {}
    for spec, _ in EDGE_SPECS:
        out[("batched", spec)] = conv.edge_detect_batched(
            imgs, spec, partitioning=part).numpy()
    plan = plan_mod.SubstratePlan.from_dict(EDGE_PLAN)
    out["planned"] = conv.edge_detect_planned(imgs, plan,
                                              partitioning=part).numpy()
    for name, sv in (("served", "approx_cuda"), ("served_plan", plan)):
        svc = EdgeDetectService(sv, device="cpu", partitioning=part,
                                max_batch_size=2, n_workers=2)
        if svc.leader:
            out[name] = svc.detect(served_images())
        svc.close()
        out[(name, "followed")] = svc.followed
    try:
        conv.conv2d_batched(conv.to_signed_pixels(imgs), conv.LAPLACIAN,
                            "approx_cuda", partitioning=part, fused=True)
    except ValueError as e:
        out["fused"] = str(e)
    return out


# ---------------------------------------------------------------------------
# rank programs: the expert-parallel MoE, the data-parallel step, training
# ---------------------------------------------------------------------------

#: maverick at smoke widths; cases: (top_k, capacity_factor)
MOE_OVERRIDES = dict(n_layers=2, d_model=32, d_ff=64, n_heads=2, n_kv_heads=2,
                     vocab=64, n_experts=4, head_dim=0, remat=False)
MOE_CASES = {"top1": (1, 1.25), "top2": (2, 1.25), "no_drop": (1, 4.0),
             "overflow": (2, 0.5)}
MOE_B, MOE_S = 4, 8


def moe_inputs(case: str):
    """x (B, S, d), the cotangent c, and repro's MoE tree (numpy)."""
    rng = np.random.default_rng(sorted(MOE_CASES).index(case))
    d, f, e = 32, 64, 4
    tree = {"router": (rng.normal(size=(d, e)) / 4).astype(np.float32),
            "wi": (rng.normal(size=(e, d, f)) / 6).astype(np.float32),
            "wg": (rng.normal(size=(e, d, f)) / 6).astype(np.float32),
            "wo": (rng.normal(size=(e, f, d)) / 8).astype(np.float32),
            "ln": (1 + rng.normal(size=(d,)) / 10).astype(np.float32),
            "shared": {k: {"w": (rng.normal(size=s) / 6).astype(np.float32)}
                       for k, s in (("wi", (d, f)), ("wg", (d, f)),
                                    ("wo", (f, d)))}}
    tree["shared"]["ln"] = (1 + rng.normal(size=(d,)) / 10).astype(np.float32)
    x = rng.normal(size=(MOE_B, MOE_S, d)).astype(np.float32)
    c = rng.normal(size=(MOE_B, MOE_S, d)).astype(np.float32)
    return x, c, tree


def moe_cfg(case: str):
    from repro_torch.models import registry as reg

    top_k, cf = MOE_CASES[case]
    return reg.get_config("llama4-maverick-400b-a17b", dtype=torch.float32,
                          top_k=top_k, capacity_factor=cf, dot_plan="exact",
                          **MOE_OVERRIDES)


def moe_program(rank, world):
    """``moe_block`` expert-parallel on the rank's data shard and expert
    shard: its output, each dispatch's routing, and the gradient of
    Σ y · c at every leaf and at the input."""
    from repro_torch.models import common as cm
    from repro_torch.models import convert
    from repro_torch.models import sharding as sh
    from repro_torch.nn import collectives as coll

    mesh = debug_mesh()
    di, mi = coll.axis_index(mesh, "data"), coll.axis_index(mesh, "model")
    dp, mp_ = coll.axis_size(mesh, "data"), coll.axis_size(mesh, "model")
    routes = []
    dispatch = cm._dispatch_local

    def recording(cfg, xn, router):
        buf, info = dispatch(cfg, xn, router)
        slot, topw, keep, cap = info
        routes.append((slot.clone(), topw.detach().clone(), keep.clone(), cap))
        return buf, info

    cm._dispatch_local = recording
    out = {}
    try:
        for case in MOE_CASES:
            cfg = moe_cfg(case)
            x, c, tree = moe_inputs(case)
            rows = slice(di * MOE_B // dp, (di + 1) * MOE_B // dp)
            p = convert.shard_experts(convert._moe(tree, "cpu"), mi, mp_)
            leaves = dict(p.named_parameters())
            for t in leaves.values():
                t.requires_grad_(True)
            xd = torch.from_numpy(x[rows]).requires_grad_(True)
            routes.clear()
            with sh.mesh_scope(mesh):
                y = cm.moe_block(cfg, p, xd)
            grads = torch.autograd.grad((y * torch.from_numpy(c[rows])).sum(),
                                        [xd] + list(leaves.values()))
            out[case] = {"y": y.detach(), "x": grads[0],
                         "grads": dict(zip(leaves, grads[1:])),
                         "routes": list(routes)}
    finally:
        cm._dispatch_local = dispatch
    return out


def dp_batch():
    rng = np.random.default_rng(0)
    return {"tokens": rng.normal(size=(32, 16)).astype(np.float32),
            "labels": rng.normal(size=(32,)).astype(np.float32)}


def dp_program(rank, world):
    """``compressed_psum`` of a rank-dependent tree, and one
    ``dp_train_step_compressed`` step with ``compress`` on and off, on a
    4-rank "data" mesh: ``tests/test_distributed.py``'s case."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.optim import adamw
    from repro_torch.optim import grad_utils
    from repro_torch.train.loop import dp_train_step_compressed

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    rng = np.random.default_rng(100 + rank)
    tree = {"a": torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32)),
            "b": torch.from_numpy((rng.normal(size=(9,)) * 1e-3)
                                  .astype(np.float32))}
    out = {"psum": grad_utils.compressed_psum(tree, "data", mesh),
           "tree": tree}

    def loss_fn(params, batch):
        pred = batch["tokens"] @ params["w"]
        return torch.mean((pred - batch["labels"][..., None]) ** 2)

    batch = {k: torch.from_numpy(v) for k, v in dp_batch().items()}
    for compress in (True, False):
        params = {"w": torch.ones((16, 1), dtype=torch.float32) * 0.1}
        opt = adamw(weight_decay=0.0)
        state = opt.init(params)
        step = dp_train_step_compressed(loss_fn, opt, mesh, compress=compress)
        loss, params, _ = step(params, state, batch, 1e-2)
        out[("step", compress)] = (float(loss), params["w"].clone())
    return out


#: the launcher's smoke configs: (arch, flags, config fields the CLI has
#: no flag for, set in the rank's registry: a capacity nothing overflows)
TRAIN_CONFIGS = {
    "dense": ("minitron-8b", [], {}),
    "moe": ("llama4-maverick-400b-a17b", ["--n-experts", "4"],
            {"capacity_factor": 4.0}),
}
TRAIN_FLAGS = ["--device", "cpu", "--n-layers", "2", "--d-model", "32",
               "--d-ff", "64", "--vocab", "64", "--n-heads", "2",
               "--n-kv-heads", "2", "--batch", "4", "--seq-len", "8",
               "--mesh", "debug"]


def train_program(rank, world, config: str, ckpt_dir: str):
    """``launch.train.main --mesh debug`` on this rank (the process group
    already formed, a ``--qat-out`` bundle written), its parameters and
    loss after the run; for the MoE
    config also a third step resumed from the run's checkpoint (each rank
    taking its expert shard of the gathered tree) beside an uninterrupted
    three-step run."""
    from repro_torch.launch import train as launch_train
    from repro_torch.models import convert
    from repro_torch.models import registry as reg

    arch, flags, fields = TRAIN_CONFIGS[config]
    if fields:  # this rank's process only
        reg.register(reg.get_config(arch, **fields))

    def run(steps, ckpt, every="2", extra=()):
        loop, params = launch_train.main(
            ["--arch", arch] + TRAIN_FLAGS + list(flags) + list(extra)
            + ["--steps", steps, "--ckpt-every", every, "--ckpt-dir", ckpt])
        return loop, {k: t.detach().clone()
                      for k, t in convert.named_leaves(params).items()}

    loop, params = run("2", ckpt_dir, extra=["--qat-out", ckpt_dir + "_bundle"])
    out = {"params": params, "losses": list(loop.metrics["losses"])}
    if config == "moe":
        resumed, out["resumed"] = run("3", ckpt_dir, every="1000")
        out["resumed_from"] = resumed.metrics["resumed_from"]
        _, out["uninterrupted"] = run("3", ckpt_dir + "_fresh", every="1000")
    return out


def driver_program(rank, world, which: str, tmp: str):
    """One driver's sharded option on this rank (the process group already
    formed): the kernel bench (dry run), the harness's kernel bench (its
    shapes cut to the dry run's) or the serving example (smoke)."""
    import contextlib
    import functools
    import importlib.util
    import io

    from benchmarks import torch_kernelbench, torch_run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if which == "kernelbench":
            rows = torch_kernelbench.run(
                substrates=["approx_lut", "int8", "approx_cuda:csp_axc1@4"],
                sharded=True, dry_run=True, json_path=f"{tmp}/k.json",
                device="cpu")
            out = {"rows": rows}
        elif which == "run":
            run = torch_kernelbench.run
            torch_kernelbench.run = functools.partial(run, dry_run=True)
            try:
                rows = torch_run.main(["--only", "kernel", "--sharded",
                                       "--device", "cpu", "--substrates",
                                       "approx_lut,exact", "--json-dir", tmp])
            finally:
                torch_kernelbench.run = run
            out = {"rows": rows}
        else:
            path = ROOT / "examples" / "torch_serve_edge.py"
            spec = importlib.util.spec_from_file_location("serve_edge", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            res = mod.main(["--sharded", "--smoke", "--device", "cpu",
                            "--workers", "2", "--max-batch", "2"])
            out = {"outputs": res["outputs"], "images": res["images"],
                   "followed": res.get("followed")}
    out["printed"] = buf.getvalue()
    return out


# ---------------------------------------------------------------------------
# the collectives, held to what they stand for
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return spawn("collectives_program", 4, tmp_path_factory.mktemp("coll"))


def _x(rank):
    return (np.arange(24, dtype=np.float32).reshape(4, 6) + 100 * rank)


#: the 2 × 2 mesh's groups, by global rank: {axis: [members of each group]}
GROUPS = {"data": [[0, 2], [1, 3]], "model": [[0, 1], [2, 3]]}


def _group(axis, rank):
    return next(g for g in GROUPS[axis] if rank in g)


def _expected(name, axis, rank):
    """(value, gradient of Σ y · (r + 1) over the group) on ``rank``."""
    g = _group(axis, rank)
    i, n = g.index(rank), len(g)
    xs = [_x(r) for r in g]
    ws = [float(r + 1) for r in g]
    if name == "psum":
        return sum(xs), np.full((4, 6), sum(ws), np.float32)
    if name == "psum_scatter":
        cols = slice(i * 6 // n, (i + 1) * 6 // n)
        grad = np.zeros((4, 6), np.float32)
        grad[:] = np.concatenate([np.full((4, 6 // n), w) for w in ws], axis=1)
        return sum(xs)[:, cols], grad
    if name == "all_gather":
        return np.concatenate(xs, axis=0), np.full((4, 6), sum(ws), np.float32)
    if name == "all_to_all":
        blocks = [x[i * 4 // n:(i + 1) * 4 // n] for x in xs]
        grad = np.concatenate([np.full((4 // n, 6), w) for w in ws], axis=0)
        return np.concatenate(blocks, axis=1), grad
    if name == "pmax":
        return np.maximum.reduce(xs), None
    raise KeyError(name)


@pytest.mark.parametrize("axis", ["data", "model"])
@pytest.mark.parametrize("name", ["psum", "psum_scatter", "all_gather",
                                  "all_to_all", "pmax"])
def test_collective_values_and_gradients(collectives, axis, name):
    """Every rank's value is the group's sum / block / gather / exchange /
    maximum, and its gradient the transpose's (a psum, an all_gather, a
    psum_scatter, the reverse all_to_all); exact (small integers)."""
    for rank, out in enumerate(collectives):
        want, grad = _expected(name, axis, rank)
        np.testing.assert_array_equal(out[(axis, name)].numpy(), want)
        if grad is not None:
            np.testing.assert_array_equal(out[(axis, name, "grad")].numpy(),
                                          grad)
        else:
            assert (axis, name, "grad") not in out


@pytest.mark.parametrize("axis", ["data", "model"])
def test_int32_psum_wraps_and_coordinates(collectives, axis):
    """int32 sums wrap in their ring, as ``repro``'s psum of int32; each
    rank's coordinate is its place in its group."""
    for rank, out in enumerate(collectives):
        g = _group(axis, rank)
        want = np.array(sum(2 ** 31 - 1 - r for r in g), np.int64)
        want = ((want + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
        np.testing.assert_array_equal(out[(axis, "int32_psum")].numpy(),
                                      np.full(3, want))
        assert out[(axis, "index")] == g.index(rank)


# ---------------------------------------------------------------------------
# rank programs: the dry run's explicit movements on DTensors
# ---------------------------------------------------------------------------


def _moves_inputs():
    """Seeded operands of :func:`moves_program` (every rank the same)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    return dict(
        proj=r(8, 4, 548), proj_w=r(8, 4, 548), rope=r(8, 6, 1, 32),
        rope_w=r(8, 6, 1, 32), q=r(8, 6, 4, 32), k=r(8, 6, 1, 32),
        v=r(8, 6, 1, 32), attn_w=r(8, 6, 4, 32), cache=r(1, 16, 2, 8),
        xh=r(8, 4, 4, 8), dt=torch.nn.functional.softplus(r(8, 4, 4)),
        B=r(8, 4, 16), C=r(8, 4, 16), a=-torch.exp(r(4)), y_w=r(8, 4, 4, 8),
        st_w=r(8, 4, 8, 16))


#: zamba's in_proj pieces (xin, z, B, C, dt) at d_model 128, state 16, 4 heads
MOVE_SIZES = [256, 256, 16, 16, 4]


def moves_program(rank, world):
    """``sharding.split``, rope through ``halves`` / ``cat``, the attention
    of one KV head split along head_dim, ``block`` of a position-split
    cache and ``mamba_scan`` with B and C split along n (both forms of its
    products), on the 4 × 2 mesh's DTensors of :func:`_moves_inputs`:
    ``{case: [(this rank's local result, its block of the plain
    result), ...]}``, the gradients of a weighted sum among them."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import common as cm
    from repro_torch.models import sharding as sh
    from repro_torch.models import zamba

    mesh = debug_mesh()
    ins = _moves_inputs()
    out = {}

    def dist_(t, *pl):
        return distribute_tensor(t, mesh, list(pl)).requires_grad_(
            t.is_floating_point())

    def plain(t):
        return t.clone().requires_grad_()

    def pairs(dts, ts):
        return [(d.to_local().detach(),
                 distribute_tensor(t.detach(), mesh, d.placements).to_local())
                for d, t in zip(dts, ts)]

    def loss(ys, ws):
        return sum((y * w).sum() for y, w in zip(ys, ws))

    s0, s2, s3 = Shard(0), Shard(2), Shard(3)
    rep = (Replicate(), Replicate())
    with sh.mesh_scope(mesh), implicit_replication():
        x, xp = dist_(ins["proj"], s0, s2), plain(ins["proj"])
        ws = torch.split(ins["proj_w"], MOVE_SIZES, -1)
        got = sh.split(x, MOVE_SIZES, -1)
        loss(got, [distribute_tensor(w, mesh, rep) for w in ws]
             ).full_tensor().backward()
        with sh.mesh_scope(None):
            want = torch.split(xp, MOVE_SIZES, -1)
            loss(want, ws).backward()
        out["split"] = pairs(list(got) + [x.grad], list(want) + [xp.grad])

        pos = torch.arange(6).expand(8, 6)
        x, xp = dist_(ins["rope"], s0, s3), plain(ins["rope"])
        got = cm.rope(x, pos, 1e4)
        (got * distribute_tensor(ins["rope_w"], mesh, rep)).sum(
        ).full_tensor().backward()
        with sh.mesh_scope(None):
            want = cm.rope(xp, pos, 1e4)
            (want * ins["rope_w"]).sum().backward()
        out["rope"] = pairs([got, x.grad], [want, xp.grad])

        q, k, v = dist_(ins["q"], s0, s2), dist_(ins["k"], s0, s3), \
            dist_(ins["v"], s0, s3)
        qp, kp, vp = plain(ins["q"]), plain(ins["k"]), plain(ins["v"])
        got = cm.attention_chunked(q, k, v, q_offset=0, chunk=4)
        (got * distribute_tensor(ins["attn_w"], mesh, rep)).sum(
        ).full_tensor().backward()
        with sh.mesh_scope(None):
            want = cm.attention_chunked(qp, kp, vp, q_offset=0, chunk=4)
            (want * ins["attn_w"]).sum().backward()
        out["attention"] = pairs([got, q.grad, k.grad, v.grad],
                                 [want, qp.grad, kp.grad, vp.grad])

        cache = distribute_tensor(ins["cache"], mesh, [Shard(1), s2])
        with torch.no_grad():
            got = [sh.block(cache, 1, start, size)
                   for start, size in ((0, 4), (4, 8), (10, 6))]
        out["block"] = pairs(got, [ins["cache"][:, a:a + n]
                                   for a, n in ((0, 4), (4, 8), (10, 6))])

        specs = (("batch", None, "heads", None), ("batch", None, "heads"),
                 ("batch", None, "heads"), ("batch", None, "heads"),
                 ("heads",), ("batch", "heads", None, None))
        for form in ("forward", "recompute"):
            args = [dist_(ins["xh"], s0, s2), dist_(ins["dt"], s0, s2),
                    dist_(ins["B"], s0, s2), dist_(ins["C"], s0, s2),
                    dist_(ins["a"], Replicate(), s0),
                    distribute_tensor(torch.zeros(8, 4, 8, 16), mesh,
                                      [s0, Shard(1)])]
            with sh.remat_scope(recompute=form == "recompute"):
                ops = sh.state_split_ops("heads", args[0])
                y, st = sh.on_shards(
                    lambda *t: zamba.mamba_scan(*t, chunk=2, **ops), specs,
                    [specs[0], specs[5]], *args)
            loss([y, st], [distribute_tensor(ins["y_w"], mesh, rep),
                           distribute_tensor(ins["st_w"], mesh, rep)]
                 ).full_tensor().backward()
            plains = [plain(ins[n]) for n in ("xh", "dt", "B", "C", "a")]
            with sh.mesh_scope(None):
                yp, stp = zamba.mamba_scan(*plains, torch.zeros(8, 4, 8, 16),
                                           chunk=2)
                loss([yp, stp], [ins["y_w"], ins["st_w"]]).backward()
            out[f"scan_{form}"] = pairs(
                [y, st] + [t.grad for t in args[:5]],
                [yp, stp] + [t.grad for t in plains])
    return out
