"""The port's roofline (``repro_torch.launch.roofline``) against
``repro.launch.roofline``: the term arithmetic with the H100 constants,
``model_flops_for`` for every arch × shape, ``_tensor_bytes``, and
``CostCounter``'s collectives against ``parse_collectives`` of
``tests/test_roofline.py``'s HLO."""
import logging

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch import roofline as jroof
from repro.models import registry as jreg
from repro_torch.launch import dryrun, roofline
from repro_torch.models import registry as reg
from tests.test_roofline import HLO


def test_roofline_terms_and_bottleneck():
    rf = roofline.Roofline(
        flops_per_device=989e12,        # exactly 1 s of compute
        bytes_per_device=3.35e12 / 2,   # 0.5 s of HBM
        collective_bytes=450e9 / 4,     # 0.25 s of NVLink
        n_devices=256,
        model_flops=989e12 * 256 * 0.5,
    )
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    assert rf.t_compute == pytest.approx(1.0)
    assert rf.t_memory == pytest.approx(0.5)
    assert rf.t_collective == pytest.approx(0.25)
    assert rf.t_bound == pytest.approx(1.0)
    assert rf.bottleneck == "compute"
    assert rf.useful_flops_ratio == pytest.approx(0.5)
    assert rf.roofline_fraction == pytest.approx(0.5)
    row = rf.row()
    assert set(row) == set(jroof.Roofline(1, 1, 1, 1, 1).row())
    rf = roofline.derive({"flops": 0.0, "bytes": 0.0, "coll": 450e9}, 8,
                         989e12 * 8)
    assert rf.bottleneck == "collective" and rf.t_bound == pytest.approx(1.0)
    assert rf.roofline_fraction == pytest.approx(1.0)


@pytest.mark.parametrize("arch", [a for a in reg.list_archs()])
def test_model_flops_equal_repros(arch):
    """Every arch × shape, from the configs' own parameter formulas and
    from a measured active count."""
    assert reg.SHAPES.keys() == jreg.SHAPES.keys()
    cfg, jcfg = reg.get_config(arch), jreg.get_config(arch)
    for name in reg.SHAPES:
        shape, jshape = reg.SHAPES[name], jreg.SHAPES[name]
        assert roofline.model_flops_for(cfg, shape) == \
            jroof.model_flops_for(jcfg, jshape)
        assert roofline.model_flops_for(cfg, shape, n_active=1e9) == \
            jroof.model_flops_for(jcfg, jshape, n_active=1e9)


def test_tensor_bytes_dtypes():
    assert roofline._tensor_bytes(torch.bfloat16, (2, 3)) == \
        jroof._tensor_bytes("bf16", "2,3") == 12
    assert roofline._tensor_bytes(torch.float32, (10,)) == \
        jroof._tensor_bytes("f32", "10") == 40
    assert roofline._tensor_bytes(torch.int8, (7, 3)) == \
        jroof._tensor_bytes("s8", "7,3") == 21
    assert roofline._tensor_bytes(torch.bool, (4,)) == \
        jroof._tensor_bytes("pred", "4") == 4


def _meta(*shape, dtype):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_collectives_count_as_repros_hlo_parse():
    """The HLO's collectives run on ``meta`` tensors in a fake 8-rank world
    (the ``-start`` form has no eager counterpart and is left out): the
    bytes and counts by kind are ``parse_collectives``'s; the matmul beside
    them is flops and bytes, not a collective."""
    hlo = "\n".join(line for line in HLO.splitlines() if "-start" not in line)
    want = jroof.parse_collectives(hlo)
    logging.disable(logging.WARNING)
    try:
        with dryrun.fake_world(8):
            with roofline.CostCounter() as c:
                dist.all_gather_into_tensor(_meta(256, 16384, dtype=torch.bfloat16),
                                            _meta(256, 2048, dtype=torch.bfloat16))
                dist.all_reduce(_meta(1024, 1024, dtype=torch.float32))
                dist.reduce_scatter_tensor(_meta(64, 1024, dtype=torch.float32),
                                           _meta(512, 1024, dtype=torch.float32))
                dist.all_to_all_single(_meta(2048, 128, dtype=torch.int8),
                                       _meta(2048, 128, dtype=torch.int8))
                dist.recv(_meta(8, 128, dtype=torch.bfloat16), src=1)
                torch.matmul(_meta(128, 128, dtype=torch.float32),
                             _meta(128, 128, dtype=torch.float32))
    finally:
        logging.disable(logging.NOTSET)
    assert not dist.is_initialized()
    assert c.coll.bytes_by_kind == want.bytes_by_kind
    assert c.coll.count_by_kind == want.count_by_kind
    assert c.coll.total_bytes == want.total_bytes
    assert c.coll.elements_by_kind == {
        "all-gather": 256 * 16384, "all-reduce": 1024 * 1024,
        "reduce-scatter": 64 * 1024, "all-to-all": 2048 * 128,
        "collective-permute": 8 * 128}
    assert c.flops == 2 * 128 ** 3
    # the matmul, and each collective's input read and output written
    # (the in-place all-reduce reads and writes its tensor, the receive
    # only writes), as XLA's "bytes accessed" prices them
    assert c.bytes == 3 * 128 * 128 * 4 + (
        256 * 2048 * 2 + 256 * 16384 * 2) + 2 * 1024 * 1024 * 4 + (
        512 * 1024 * 4 + 64 * 1024 * 4) + 2 * 2048 * 128 + 8 * 128 * 2


def test_a_collective_is_priced_as_xla_prices_it():
    """One collective's bytes: its input read and its output written.
    ``cost_analysis()["bytes accessed"]`` of ``repro``'s compiled
    ``shard_map`` over 4 host devices reads 1310720 for an all-gather of
    a (256, 256) float32 shard into (1024, 256), and 524288 for a psum
    of the same shard (``tests/test_torch_dryrun_parity.py`` compiles
    both); the port's functional collectives, which ``DTensor`` issues,
    count the same."""
    from torch.distributed import _functional_collectives as funcol

    logging.disable(logging.WARNING)
    try:
        with dryrun.fake_world(4):
            group = dist.group.WORLD
            with roofline.CostCounter("meta") as g:
                funcol.all_gather_tensor(_meta(256, 256, dtype=torch.float32),
                                         0, group)
            with roofline.CostCounter("meta") as r:
                funcol.all_reduce(_meta(256, 256, dtype=torch.float32),
                                  "sum", group)
    finally:
        logging.disable(logging.NOTSET)
    assert g.bytes == 1310720 and r.bytes == 524288
    assert g.coll.bytes_by_kind["all-gather"] == 1024 * 256 * 4
    assert r.coll.elements_by_kind["all-reduce"] == 256 * 256


def test_views_move_nothing_and_temp_is_the_peak():
    """A view counts no bytes; in-place ops read and write; the temp peak is
    what the counted ops allocate and still hold."""
    x = torch.ones(64, 64)
    with roofline.CostCounter() as c:
        y = x.view(4096)
        y.mul_(2.0)
        z = x + 1.0         # 16 KiB held
        del z
        w = x * 3.0         # the freed 16 KiB, again
    assert c.flops == 0
    assert c.bytes == 3 * (2 * 4096 * 4)   # each: its input and its output
    assert c.peak_temp == 4096 * 4
    assert torch.equal(w, x * 3.0) and np.isclose(float(x[0, 0]), 2.0)
