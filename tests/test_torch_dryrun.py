"""The port's dry run (``repro_torch.launch.dryrun``), its layer-differenced
correction (``rooffix``), ``hillclimb`` and ``report``, on the CPU.

``tests/test_distributed.py``'s dry-run cells, held to what the port can
show: the reduced minitron train step counts flops and collectives on a
fake 4 × 2 world; ``approx_stat`` under ``--dot-partition`` runs and
all-reduces; a 1-device ``meta`` run counts exactly what the same step
counts on real tensors; the L0 / L1 correction equals the full-depth count;
and no fake process group outlives a call."""
import json
import logging

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import dryrun, hillclimb, report, rooffix, roofline
from repro_torch.launch import mesh as ml
from repro_torch.models import registry as reg

#: test_distributed.py's reduced minitron
SMALL = dict(n_layers=2, d_model=128, d_ff=256, vocab=512, n_heads=4,
             n_kv_heads=2, attn_chunk=64, loss_chunk=64, remat=False)
TRAIN = reg.ShapeSpec("train_8x64", "train", 64, 8)


@pytest.fixture(autouse=True)
def _no_group_outlives_a_test():
    logging.disable(logging.WARNING)
    assert not dist.is_initialized()
    yield
    logging.disable(logging.NOTSET)
    assert not dist.is_initialized()


def test_dryrun_cell_on_debug_mesh():
    """The reduced minitron train step on a fake 4 × 2 world: flops, bytes
    and collectives counted, a roofline row derived; the arguments are
    rank 0's shards."""
    cfg = reg.get_config("minitron-8b", **SMALL)
    with dryrun.fake_world(8):
        mesh = ml.make_debug_mesh()
        assert tuple(mesh.mesh.shape) == (4, 2)
        cell = dryrun.count_step(cfg, TRAIN, mesh)
    c = cell.counts
    assert c["flops"] > 0 and c["bytes"] > 0 and c["temp"] > 0
    assert c["coll"] > 0          # sharded training must communicate
    assert c["coll_counts"]["all-reduce"] > 0
    assert c["coll"] == sum(c["coll_by"].values())
    rf = roofline.derive(c, 8, roofline.model_flops_for(cfg, TRAIN))
    assert rf.bottleneck in ("compute", "memory", "collective")
    # params + AdamW moments + the batch, a quarter to an eighth a rank
    whole = cell.params * (2 + 4 + 4) + 2 * 8 * 64 * 4
    assert whole / 8 <= cell.argument_bytes < whole / 2


@pytest.mark.parametrize("kind,accum", [("train", 1), ("train", 2),
                                        ("prefill", 1), ("decode", 1)])
def test_mesh_count_is_the_one_device_count_shared(kind, accum):
    """Each of the 8 ranks of a fake 4 × 2 world counts an eighth of the
    1-device ``meta`` step's flops, and microbatching changes no flop: no
    contraction runs whole on every rank of an axis (an FSDP weight is
    gathered at its use, a row-parallel product's partial sums are reduced
    after it, and a constraint holds its cotangent too)."""
    cfg = reg.get_config("minitron-8b", **SMALL)
    shape = {"train": TRAIN, "prefill": reg.ShapeSpec("p", "prefill", 64, 8),
             "decode": reg.ShapeSpec("d", "decode", 64, 8)}[kind]
    one = dryrun.count_step(cfg, shape, device="meta", accum=accum)
    with dryrun.fake_world(8):
        cell = dryrun.count_step(cfg, shape, ml.make_debug_mesh(), accum=accum)
    assert cell.counts["flops"] * 8 == one.counts["flops"] > 0
    if kind == "train":
        assert one.counts["flops"] == dryrun.count_step(
            cfg, TRAIN, device="meta", accum=1).counts["flops"]


def test_dryrun_partitioned_approx_substrate_lowers():
    """``--dot-partition``: ``approx_stat`` contracts through the
    substrate's Partitioning (M over "data", K reduce-scattered over
    "model") on the dry run's DTensors, and the step all-reduces."""
    cfg = reg.get_config("minitron-8b", dot_plan="approx_stat", **SMALL)
    with dryrun.fake_world(8):
        mesh = ml.make_debug_mesh()
        part = ml.contraction_partitioning(mesh)
        assert (part.m_axis, part.k_axis) == ("data", "model")
        cell = dryrun.count_step(cfg, TRAIN, mesh, part=part)
    c = cell.counts
    assert c["coll_counts"]["all-reduce"] > 0
    assert c["coll_counts"]["reduce-scatter"] > 0 and c["flops"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_count_equals_the_real_steps(kind):
    """One device, no mesh: the ``meta`` dry run counts exactly the flops,
    bytes and ops that the same step counts on real CPU tensors."""
    cfg = reg.get_config("minitron-8b", **SMALL)
    shape = {"train": TRAIN, "prefill": reg.ShapeSpec("p", "prefill", 64, 4),
             "decode": reg.ShapeSpec("d", "decode", 64, 4)}[kind]
    meta = dryrun.count_step(cfg, shape, device="meta")
    real = dryrun.count_step(cfg, shape, device="cpu", seed=3)
    for k in ("flops", "bytes", "ops", "coll"):
        assert meta.counts[k] == real.counts[k], k
    assert meta.counts["flops"] > 0 and meta.counts["coll"] == 0
    assert meta.argument_bytes == real.argument_bytes
    assert meta.output_bytes == real.output_bytes


@pytest.mark.parametrize("arch,over", [
    ("minitron-8b", dict(n_layers=4, d_model=128, d_ff=256, vocab=512,
                         n_heads=4, n_kv_heads=2)),
    ("llama4-maverick-400b-a17b", dict(n_layers=8, d_model=128, d_ff=128,
                                       vocab=512, n_heads=4, n_kv_heads=2,
                                       n_experts=16)),
], ids=["dense", "period2-moe"])
def test_rooffix_equals_the_full_depth_count(arch, over):
    """L2 + (n_layers / period − 2) · (L3 − L2) equals the full-depth count
    on the 16 × 16 mesh, for flops, bytes, collectives by kind and the
    temp bytes' peak."""
    shape = reg.ShapeSpec("t", "train", 64, 32)
    cfg = reg.get_config(arch, **over, attn_chunk=64, loss_chunk=64)
    if arch.startswith("llama4"):
        assert rooffix.lm.unit_period(cfg) == 2
    with dryrun.fake_world(256):
        mesh = ml.make_production_mesh()
        full = dryrun.count_step(cfg, shape, mesh).counts
        corr = rooffix.corrected_cell(arch, shape, **over, attn_chunk=64,
                                      loss_chunk=64)
    for k in ("flops", "bytes", "coll", "temp"):
        assert corr[k] == full[k], k
    assert corr["coll_by"] == {k: float(v) for k, v in full["coll_by"].items()}
    period = rooffix.lm.unit_period(cfg)
    assert corr["method"] == \
        f"L2+{over['n_layers'] // period - 2}x(L3-L2), period={period}"


def test_one_hillclimb_variant_runs(tmp_path):
    """Two variants of minitron-8b × decode_32k at its published widths:
    the head-sharded cache shards no sequence, and both rows are
    ``repro``'s."""
    out = tmp_path / "hill.json"
    rows = hillclimb.main(["--arch", "minitron-8b", "--shape", "decode_32k",
                           "--variants", "base,kv_headshard", "--out",
                           str(out)])
    assert [r["variant"] for r in rows] == ["base", "kv_headshard"]
    assert all(r["ok"] for r in rows), rows
    assert rows[0]["t_memory"] > 0 and rows[0]["collective_bytes"] >= 0
    assert json.loads(out.read_text())[1]["variant"] == "kv_headshard"
    assert "| minitron-8b×decode_32k | kv_headshard |" in \
        report.hillclimb_table(str(out))


def test_report_renders_repro_rows(tmp_path):
    """The three tables from ``repro``-shaped rows (``compile_s``) and the
    port's (``step_s``); failed rows are left out."""
    rf = dict(t_compute=1.0, t_memory=0.5, t_collective=0.25,
              bottleneck="compute", useful_ratio=0.5, roofline_fraction=0.5)
    dry = [dict(arch="a", shape="train_4k", mesh="16x16", ok=True,
                memory={"argument_size_in_bytes": 2**30,
                        "temp_size_in_bytes": 2**31},
                collective_counts={"all-gather": 3, "all-reduce": 0},
                compile_s=12.5, **rf),
           dict(arch="b", shape="decode_32k", mesh="2x16x16", ok=True,
                memory={}, collective_counts={}, step_s=1.5, **rf),
           dict(arch="c", shape="train_4k", mesh="16x16", ok=False)]
    hill = [dict(arch="a", shape="train_4k", variant="base", ok=True, **rf)]
    for name, rows in (("dryrun", dry), ("roofline", dry), ("hillclimb", hill)):
        (tmp_path / f"{name}.json").write_text(json.dumps(rows))
    d = report.dryrun_table(str(tmp_path / "dryrun.json")).splitlines()
    assert d[2] == "| a | train_4k | 16x16 | 1.00 | 2.00 | gather:3 | 12.5 |"
    assert d[3] == "| b | decode_32k | 2x16x16 | 0.00 | 0.00 |  | 1.5 |"
    r = report.roofline_table(str(tmp_path / "roofline.json")).splitlines()
    assert r[2] == "| a | train_4k | 1 | 0.5 | 0.25 | compute | 0.500 | 0.5000 |"
    assert len(r) == 4
    h = report.hillclimb_table(str(tmp_path / "hillclimb.json")).splitlines()
    assert h[2] == "| a×train_4k | base | 1 | 0.5 | 0.25 | compute | 0.5000 |"


def test_fake_world_refuses_a_group_and_restores_none():
    """A fake world does not replace a process group; it destroys its own
    on exit, an exception included."""
    ml.init_ranks("gloo")
    try:
        with pytest.raises(RuntimeError, match="a process group exists"):
            with dryrun.fake_world(8):
                pass
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    with pytest.raises(KeyError):
        with dryrun.fake_world(256):
            assert dist.get_world_size() == 256
            raise KeyError("inside")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        with dryrun.fake_world(256):
            ml.make_production_mesh(multi_pod=True)


def test_dryrun_cli_records_a_failure_and_goes_on(tmp_path, monkeypatch):
    """``run_cells`` records a failing cell and counts the next; ``main``
    resumes from its output file."""
    calls = []

    def fake_lower(arch, shape, multi_pod, **kw):
        calls.append(arch)
        if arch == "bad":
            raise RuntimeError("boom")
        return dict(arch=arch, shape=shape, mesh="16x16", flops_per_device=1.0,
                    collective_bytes=0.0, bottleneck="compute", step_s=0.1)

    monkeypatch.setattr(dryrun, "lower_cell", fake_lower)
    out = tmp_path / "r.json"
    rows = dryrun.run_cells([("bad", "train_4k", False),
                             ("good", "train_4k", False)], str(out))
    assert [r["ok"] for r in rows] == [False, True]
    assert "RuntimeError: boom" in rows[0]["error"]
    rows = dryrun.run_cells([("good", "train_4k", False)], str(out))
    assert calls == ["bad", "good"] and len(rows) == 2
    cells = dryrun.all_cells(False)
    assert ("xlstm-125m", "long_500k", False) in cells
    assert ("minitron-8b", "long_500k", False) not in cells
    assert not any(a == "edge-detect" for a, _, _ in cells)


def test_rooffix_all_sweeps_every_cell_of_both_meshes(tmp_path, monkeypatch):
    """``rooffix --all --both-meshes --only-arch A`` counts each of A's
    cells on both meshes through ``sweep_row`` and records them as the
    dry run's sweep does."""
    seen = []

    def fake_row(arch, shape, multi_pod):
        seen.append((shape, multi_pod))
        return dict(arch=arch, shape=shape,
                    mesh="2x16x16" if multi_pod else "16x16",
                    flops_per_device=1.0, collective_bytes=0.0,
                    bottleneck="memory", step_s=0.1)

    monkeypatch.setattr(rooffix, "sweep_row", fake_row)
    out = tmp_path / "roof.json"
    rows = rooffix.main(["--all", "--both-meshes", "--only-arch",
                         "minitron-8b", "--out", str(out)])
    shapes = ("train_4k", "prefill_32k", "decode_32k")
    assert seen == [(s, mp) for mp in (False, True) for s in shapes]
    assert all(r["ok"] for r in rows) and len(json.loads(out.read_text())) == 6
