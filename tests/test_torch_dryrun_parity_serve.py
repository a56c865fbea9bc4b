"""The mesh dry run's serving cells held to ``repro``'s compiled step:
prefill and decode for the dense and MoE families, the decode cells again
at float32, where XLA:CPU has no bf16 to widen, and a dense decode of one
sequence over a cache split along its positions (long_500k's case). The
harness, the configs and the bar are ``tests/test_torch_dryrun_parity.py``'s;
this module also holds the price of one collective to XLA's."""
from __future__ import annotations

import logging

import pytest
import torch

from repro_torch.launch import dryrun, roofline
from tests.test_torch_dryrun_parity import (
    both_sides, check_bytes, check_collectives, check_flops, check_share,
    check_widened)
from tests.test_torch_xlstm import one_torch_thread, once  # noqa: F401 (autouse)

CELLS = [f"{kind}:{fam}" for fam in ("dense", "moe")
         for kind in ("prefill", "decode")]
#: the decode cells with every parameter, cache and activation float32
FLOAT32 = [f"decode:{fam}:f32" for fam in ("dense", "moe")]
#: a decode of one sequence over a cache split along its positions
LONG = ["decode:dense:long"]
ALL = CELLS + FLOAT32 + LONG


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    return once("dryrun_parity_serve", lambda: both_sides(
        ALL, tmp_path_factory.mktemp("dryrun_parity_serve"), one_op=True))


@pytest.mark.parametrize("cell", ALL)
def test_collective_bytes_by_kind(sides, cell):
    check_collectives(cell, *sides[cell])


@pytest.mark.parametrize("cell", CELLS + LONG)
def test_tensor_core_flops(sides, cell):
    check_flops(cell, *sides[cell])


@pytest.mark.parametrize("cell", CELLS + LONG)
def test_mesh_share_of_the_one_device_flops(sides, cell):
    check_share(cell, *sides[cell])


@pytest.mark.parametrize("cell", ALL)
def test_hbm_bytes(sides, cell):
    """Prefill within 20%; bf16 decode is a :data:`KNOWN` factor, and at
    float32 decode is within the same 20%: the gap is XLA:CPU's bf16."""
    check_bytes(cell, *sides[cell])


@pytest.mark.parametrize("cell", CELLS + LONG)
def test_partitioned_collectives_are_bf16(sides, cell):
    check_widened(sides[cell][0])


def test_a_collective_costs_what_xla_counts(sides):
    """An all-gather of a (256, 256) float32 shard over 4 ranks and a sum
    of one: the port's counter prices each at its input read and its output
    written, the bytes ``cost_analysis`` gives ``repro``'s compiled
    ``shard_map`` of the same op."""
    from torch.distributed import _functional_collectives as funcol

    shard = torch.empty(256, 256, device="meta")
    logging.disable(logging.WARNING)
    try:
        with dryrun.fake_world(4):
            with roofline.CostCounter("meta") as g:
                funcol.all_gather_tensor(shard, 0, funcol.dist.group.WORLD)
            with roofline.CostCounter("meta") as r:
                funcol.all_reduce(shard, "sum", funcol.dist.group.WORLD)
    finally:
        logging.disable(logging.NOTSET)
    assert g.bytes == sides["all-gather"] == 1310720
    assert r.bytes == sides["all-reduce"] == 524288
