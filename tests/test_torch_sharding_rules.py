"""The port's production meshes and sharding rules
(``repro_torch.launch.mesh``, ``repro_torch.models.sharding``) and the
registry's shape specs against ``repro``'s.

``repro``'s side runs on a ``jax.sharding.AbstractMesh``, so no device
count is forced; the port's forms the mesh over a fake 256 / 512-rank world
(``dryrun.fake_world``). For every registered arch on both production
meshes: each parameter's PartitionSpec (and so its placements) is
``repro``'s for the leaf ``bundle.layout`` names, and rank 0's bytes of
params + optimizer state + batch (``train_4k``) and of params + decode
state + batch (``decode_32k``, both ``cache_shard`` modes, ``fsdp`` on and
off) equal the sums of ``repro``'s ``NamedSharding.shard_shape``.
"""
import collections
import logging
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.launch import mesh as jmesh
from repro.models import registry as jreg
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as ml
from repro_torch.models import registry as reg
from repro_torch.models import sharding as sh

ARCHS = reg.list_archs()
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def _quiet():
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)
    assert not dist.is_initialized()


def _key(path) -> tuple:
    return tuple(str(getattr(e, "key", getattr(e, "idx", e))) for e in path)


def _jflat(tree) -> dict:
    return {_key(p): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jbytes(specs, shardings) -> int:
    sds, shs = _jflat(specs), _jflat(shardings)
    return sum(math.prod(shs[k].shard_shape(v.shape)) * np.dtype(v.dtype).itemsize
               for k, v in sds.items())


def _tbytes(tree, shardings) -> int:
    """Rank 0's bytes of a port tree under its NamedShardings."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    shs = {tuple(n): s for n, s in ml._flatten(shardings)}
    return sum(math.prod(shs[tuple(n)].shard_shape(t.shape)) * t.element_size()
               for n, t in ml._flatten(tree) if isinstance(t, torch.Tensor))


_ONCE = {}


def _repro(arch):
    """repro's bundle, param specs and optimizer-state specs (once)."""
    if arch not in _ONCE:
        jcfg = jreg.get_config(arch)
        jb = jreg._BUILDERS[jcfg.family](jcfg)
        params = jreg.param_specs(jb)
        opt = jadafactor() if jcfg.n_experts else jadamw()
        _ONCE[arch] = (jcfg, jb, params, jax.eval_shape(opt.init, params))
    return _ONCE[arch]


def _port(arch):
    cfg = reg.get_config(arch)
    bundle = reg.build_bundle(cfg)
    params = reg.param_specs(bundle)
    opt = dryrun.pick_optimizer(bundle)
    return cfg, bundle, params, opt.init(dict(params.named_parameters()))


def _pad(spec, n):
    spec = tuple(spec)
    return spec + (None,) * (n - len(spec))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_argument_bytes_equal_repros(arch, multi_pod,
                                                     monkeypatch):
    jcfg, jb, jparams, jopt = _repro(arch)
    cfg, bundle, params, opt_state = _port(arch)
    jm = AbstractMesh(*MESHES[multi_pod])
    with dryrun.fake_world(512 if multi_pod else 256):
        mesh = ml.make_production_mesh(multi_pod=multi_pod)
        assert sh.axis_sizes(mesh) == dict(zip(MESHES[multi_pod][1],
                                               MESHES[multi_pod][0]))
        jsh = _jflat(jmesh.param_shardings(jparams, jm))
        psh = ml.param_shardings(params, mesh)
        assert set(psh) == {n for n, _ in params.named_parameters()}
        for name, t in params.named_parameters():
            path, r = bundle.layout._split(name)
            jspec = _pad(jsh[tuple(map(str, path))].spec,
                         t.dim() + (r is not None))
            want = jspec[1:] if r is not None else jspec
            if r is not None:
                assert jspec[0] is None
            assert _pad(psh[name].spec, t.dim()) == want, name
            assert psh[name].placements == sh.placements(want, mesh)

        # train_4k: params + optimizer state + batch
        shape = reg.SHAPES["train_4k"]
        jbatch = jreg.input_specs(jcfg, jreg.SHAPES["train_4k"])
        want = (_jbytes(jparams, jmesh.param_shardings(jparams, jm))
                + _jbytes(jopt, jmesh.param_shardings(jopt, jm))
                + _jbytes(jbatch, jmesh.batch_shardings(jbatch, jm)))
        batch = reg.input_specs(cfg, shape)
        got = (_tbytes(params, psh)
               + _tbytes(opt_state, ml.param_shardings(opt_state, mesh))
               + _tbytes(batch, ml.batch_shardings(batch, mesh)))
        assert got == want

        # decode_32k: params + decode state + batch, every rule setting
        shape = reg.SHAPES["decode_32k"]
        state = reg.decode_state_specs(bundle, shape)
        stacks = reg.decode_state_stacks(cfg, state)
        jstate = jreg.decode_state_specs(jb, jreg.SHAPES["decode_32k"])
        jbatch = jreg.input_specs(jcfg, jreg.SHAPES["decode_32k"])
        batch = reg.input_specs(cfg, shape)
        for fsdp in (True, False):
            for mode in ("auto", "heads"):
                if fsdp:
                    monkeypatch.delenv("REPRO_NO_FSDP", raising=False)
                else:
                    monkeypatch.setenv("REPRO_NO_FSDP", "1")
                monkeypatch.setenv("REPRO_CACHE_SHARD", mode)
                want = (_jbytes(jparams, jmesh.param_shardings(jparams, jm))
                        + _jbytes(jstate, jmesh.cache_shardings(jstate, jm))
                        + _jbytes(jbatch, jmesh.batch_shardings(jbatch, jm)))
                got = (_tbytes(params, ml.param_shardings(params, mesh,
                                                          fsdp=fsdp))
                       + _tbytes(state, ml.cache_shardings(
                           state, mesh, cache_shard=mode, stacks=stacks))
                       + _tbytes(batch, ml.batch_shardings(batch, mesh)))
                assert got == want, (fsdp, mode)


def test_kimi_largest_leaf_fits_a_device():
    """``tests/test_distributed.py::test_sharding_rules_shard_big_leaves``:
    on 2 × 16 × 16 kimi-k2's largest parameter is < 8 GiB a device."""
    _, _, params, _ = _port("kimi-k2-1t-a32b")
    with dryrun.fake_world(512):
        mesh = ml.make_production_mesh(multi_pod=True)
        psh = ml.param_shardings(params, mesh)
        worst = max(math.prod(psh[n].shard_shape(t.shape)) * t.element_size()
                    for n, t in params.named_parameters())
    assert worst < 8 * 2**30, worst
    # the experts are sharded on the expert and the FSDP axes
    assert psh["layers.1.moe.wi"].spec == ("model", ("pod", "data"), None)


def _dtype_name(dt) -> str:
    return str(dt).rpartition(".")[2] if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_specs_equal_repros(arch):
    """SHAPES, SUBQUADRATIC, input_specs, param_specs (through
    ``bundle.layout``) and decode_state_specs (stacked as
    ``decode_state_stacks`` says) have ``repro``'s shapes and dtypes."""
    assert reg.SHAPES == {k: reg.ShapeSpec(**vars(v))
                          for k, v in jreg.SHAPES.items()}
    assert reg.SUBQUADRATIC == jreg.SUBQUADRATIC
    jcfg, jb, jparams, _ = _repro(arch)
    cfg, bundle, params, _ = _port(arch)
    for name in reg.SHAPES:
        got = reg.input_specs(cfg, reg.SHAPES[name])
        want = jreg.input_specs(jcfg, jreg.SHAPES[name])
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].is_meta
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert _dtype_name(got[k].dtype) == _dtype_name(want[k].dtype)

    tree = bundle.layout.to_tree(dict(params.named_parameters()))
    got = {tuple(n): (tuple(t.shape), _dtype_name(t.dtype))
           for n, t in ml._flatten(tree)}
    want = {k: (tuple(v.shape), _dtype_name(v.dtype))
            for k, v in _jflat(jparams).items()}
    assert got == want

    shape = reg.SHAPES["decode_32k"]
    state = reg.decode_state_specs(bundle, shape)
    stacks = dict((tuple(n), s) for n, s in ml._flatten(
        reg.decode_state_stacks(cfg, state)))
    got = collections.Counter()
    for names, t in ml._flatten(state):
        n = stacks[tuple(names)]
        got[((n,) + tuple(t.shape) if n else tuple(t.shape),
             _dtype_name(t.dtype))] += 1 / (n or 1)
    jstate = jreg.decode_state_specs(jb, jreg.SHAPES["decode_32k"])
    want = collections.Counter(
        (tuple(v.shape), _dtype_name(v.dtype)) for v in _jflat(jstate).values())
    assert {k: round(v) for k, v in got.items()} == dict(want)


def test_spec_and_constrain_follow_the_rules():
    """Outside a mesh ``spec`` is empty and ``constrain`` the identity; on a
    plain tensor under a mesh too. A DTensor is redistributed to the
    rules' placements, dimensions that do not divide left whole, and
    ``set_rules`` replaces the table until it is reset."""
    x = torch.zeros(8, 4, 6)
    assert sh.spec("batch", "seq", "mlp") == ()
    assert sh.constrain(x, "batch", "seq", "mlp") is x
    with dryrun.fake_world(8):
        mesh = ml.make_debug_mesh()
        d = DTensor.from_local(torch.empty(8, 4, 6, device="meta"), mesh,
                               [Replicate(), Replicate()], run_check=False)
        with sh.mesh_scope(mesh):
            assert sh.constrain(x, "batch", "seq", "mlp") is x
            assert sh.spec("batch", "seq", "mlp") == ("data", None, "model")
            assert sh.spec("batch", "tokens") == ("data", None)  # once only
            assert sh.named_sharding("vocab", "embed").spec == ("model", None)
            y = sh.constrain(d, "batch", "seq", "mlp")
            assert y.placements == (Shard(0), Shard(2))
            assert sh.constrain(y, "batch", "seq", "mlp").placements == \
                y.placements
            # 4 rows on a 4-way data axis, 5 columns on a 2-way model axis
            z = DTensor.from_local(torch.empty(4, 5, device="meta"), mesh,
                                   [Replicate(), Replicate()], run_check=False)
            assert sh.constrain(z, "batch", "mlp").placements == (
                Shard(0), Replicate())
            sh.set_rules(dict(sh.DEFAULT_RULES, batch=None, seq="model"))
            try:
                assert sh.get_rules()["seq"] == "model"
                assert sh.constrain(d, "batch", "seq", "mlp").placements == (
                    Replicate(), Shard(1))
            finally:
                sh.set_rules(None)
            assert sh.get_rules() is sh.DEFAULT_RULES
        assert sh.named_sharding("batch") is None


def test_constraints_hold_the_cotangent():
    """``constrain`` puts a non-parameter's cotangent on the rules'
    placements too (the transpose of ``with_sharding_constraint``), a
    parameter's on its own shards; ``gather_fsdp`` gathers a weight over
    the batch axes only; ``reduce_pending`` sums a partial result;
    ``regroup`` moves a head split that does not divide the KV groups to
    the positions, and leaves one that does."""
    from torch.distributed.tensor import Partial

    with dryrun.fake_world(8):
        mesh = ml.make_debug_mesh()
        rep = [Replicate(), Replicate()]
        with sh.mesh_scope(mesh):
            w = DTensor.from_local(torch.empty(8, 4, 6, device="meta"), mesh,
                                   rep, run_check=False).requires_grad_()
            sh.constrain(w * 2, "batch", "seq", "mlp").sum().backward()
            assert w.grad.placements == (Shard(0), Shard(2))
            p = DTensor.from_local(torch.empty(2, 4, 6, device="meta"), mesh,
                                   [Shard(0), Replicate()], run_check=False,
                                   shape=(8, 4, 6), stride=(24, 6, 1)
                                   ).requires_grad_()
            sh.constrain(p, None, None, "mlp").sum().backward()
            assert p.grad.placements == p.placements
            assert sh.gather_fsdp(DTensor.from_local(
                torch.empty(2, 3, device="meta"), mesh, [Shard(0), Shard(1)],
                run_check=False)).placements == (Replicate(), Shard(1))
            part = DTensor.from_local(torch.empty(8, 6, device="meta"), mesh,
                                      [Shard(0), Partial()], run_check=False)
            assert sh.reduce_pending(part).placements == (Shard(0), Replicate())
            q = DTensor.from_local(torch.empty(8, 16, 3, 4, device="meta"),
                                   mesh, [Replicate(), Shard(2)],
                                   run_check=False)     # 6 heads, 3 a rank
            assert sh.regroup(q, 3, dim=2, alt=1).placements == (
                Replicate(), Shard(1))        # 3 groups of 2 heads
            assert sh.regroup(q, 2, dim=2, alt=1) is q     # 2 groups of 3
    x = torch.zeros(4, 6)
    assert sh.gather_fsdp(x) is x and sh.reduce_pending(x) is x
    assert sh.regroup(x, 3, dim=1, alt=0) is x



def test_the_moves_land_where_gspmd_puts_them(tmp_path):
    """On 8 ``gloo`` ranks (a 4 × 2 mesh): ``split``'s pieces, rope through
    ``halves`` / ``cat``, the attention of one KV head split along
    head_dim, ``block``s of a position-split cache and ``mamba_scan`` with
    B and C split along n (its forward and its recompute form) give each
    rank its block of the plain result, and their gradients each rank's
    block of the plain gradients: the backward is the transpose."""
    from tests.test_torch_ranks import spawn

    ranks = spawn("moves_program", 8, tmp_path)
    for rank, out in enumerate(ranks):
        assert set(out) == {"split", "rope", "attention", "block",
                            "scan_forward", "scan_recompute"}
        for case, pairs in out.items():
            for i, (got, want) in enumerate(pairs):
                assert got.shape == want.shape, (rank, case, i)
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                           msg=f"rank {rank} {case} {i}")


def _kinds(c):
    return {k for k, v in c.coll.bytes_by_kind.items() if v}


def test_each_move_is_the_kind_gspmd_moves():
    """On a fake 8-rank world, counted on rank 0: ``split`` permutes and
    its backward regroups through the batch by all-to-alls; ``halves``
    permutes both ways; ``cat`` regroups by all-to-alls and its backward
    permutes; ``block`` permutes and all-reduces; ``gather_last`` gathers
    and each product's cotangent is reduce-scattered; a row-parallel result
    reduced onto a split stream is reduce-scattered. On plain tensors each
    is the plain op."""
    from torch.distributed.tensor import Partial

    from repro_torch.launch import roofline

    x = torch.randn(8, 4, 548)
    assert all(torch.equal(a, b) for a, b in zip(
        sh.split(x, [256, 256, 16, 16, 4], -1),
        torch.split(x, [256, 256, 16, 16, 4], -1)))
    h1, h2 = sh.halves(x[..., :32], 16)
    assert torch.equal(h1, x[..., :16]) and torch.equal(h2, x[..., 16:32])
    assert torch.equal(sh.cat([h1, h2], -1), x[..., :32])
    assert torch.equal(sh.block(x, 1, 1, 2), x[:, 1:3])
    assert sh.gather_last(x) is x and sh.reduce_grad(x) is x
    with sh.reduce_onto(x):
        assert sh.reduce_pending(x) is x
    assert sh.state_split_ops("heads", x) == {}
    assert sh.gather_local("heads", 3)(x) is x

    def meta(shape, pl, dtype=torch.float32):
        """A meta DTensor of ``shape`` on placements ``pl``."""
        local = list(shape)
        for i, q in enumerate(pl):
            if q.is_shard():
                local[q.dim] //= mesh.size(i)
        return DTensor.from_local(
            torch.empty(local, device="meta", dtype=dtype), mesh, pl,
            run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())

    with dryrun.fake_world(8):
        mesh = ml.make_debug_mesh()
        s0, s2, s3 = Shard(0), Shard(2), Shard(3)
        with sh.mesh_scope(mesh):
            p = meta((8, 64, 548), (s0, s2)).requires_grad_()
            with roofline.CostCounter("meta") as f:
                pieces = sh.split(p, [256, 256, 16, 16, 4], -1)
            assert _kinds(f) == {"collective-permute"}
            assert all(t.placements == (s0, s2) for t in pieces)
            with roofline.CostCounter("meta") as b:
                torch.autograd.backward(pieces, [meta(t.shape, (s0, s2))
                                                 for t in pieces])
            assert _kinds(b) == {"all-to-all"}
            assert p.grad.placements == (s0, s2)

            k = meta((8, 80, 1, 32), (s0, s3)).requires_grad_()
            with roofline.CostCounter("meta") as f:
                k1, k2 = sh.halves(k, 16)
                r = sh.cat([k1 * 2, k2 * 3], -1)
            assert _kinds(f) == {"collective-permute", "all-to-all"}
            assert f.coll.count_by_kind["all-to-all"] == 3
            assert r.placements == (s0, s3) and r.shape == k.shape
            with roofline.CostCounter("meta") as b:
                r.backward(meta(r.shape, (s0, s3)))
            assert _kinds(b) == {"collective-permute"}
            assert b.coll.count_by_kind["collective-permute"] == 4

            cache = meta((1, 256, 2, 32), (Shard(1), s2), torch.bfloat16)
            with torch.no_grad(), roofline.CostCounter("meta") as c:
                blk = sh.block(cache, 1, 64, 64)
            assert c.coll.count_by_kind == dict(
                {k_: 0 for k_ in c.coll.count_by_kind},
                **{"collective-permute": 1, "all-reduce": 1})
            assert blk.shape == (1, 64, 2, 32) and blk.placements == (
                Replicate(), s2)

            stream = meta((8, 80, 128), (s0, s2)).requires_grad_()
            with roofline.CostCounter("meta") as f:
                whole = sh.gather_last(stream)
                y = sh.reduce_pending(whole) * 2 + sh.reduce_pending(whole)
            assert _kinds(f) == {"all-gather"}
            assert whole.placements == (s0, Replicate())
            with roofline.CostCounter("meta") as b:
                y.backward(meta(y.shape, (s0, Partial())))
            assert _kinds(b) == {"reduce-scatter"}
            assert b.coll.count_by_kind["reduce-scatter"] == 2
            assert stream.grad.placements == (s0, s2)
            part = meta((8, 80, 128), (s0, Partial())).requires_grad_()
            with roofline.CostCounter("meta") as f, sh.reduce_onto(stream):
                onto = sh.reduce_pending(part)
            assert _kinds(f) == {"reduce-scatter"}
            assert onto.placements == (s0, s2)
            onto.backward(meta(onto.shape, (s0, s2)))
            assert part.grad.shape == part.shape
