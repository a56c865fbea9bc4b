"""The sharded edge paths and partitioned serving against ``repro``'s.

On 4 CPU ``gloo`` ranks of a 2 × 2 ``("data", "model")`` mesh
(``tests/test_torch_ranks.py::edge_program``), under
``launch.mesh.contraction_partitioning``: M (the pixels) over "data", K
(the taps: 9 → 2 × 5 with one padded tap, the planned ring's 8 → 2 × 4,
its center 1 → 2 × 1) over "model". ``repro``'s side once per module in a
subprocess with 4 forced host devices and a mesh with Auto axes. Cases,
each map equal byte for byte on every rank:

* ``edge_detect_batched`` at approx_bitexact, approx_lut:design_strollo2020
  and the port's approx_cuda:proposed@8 (``repro``'s approx_pallas, in
  interpret mode) against ``repro``'s sharded and unsharded maps;
* ``edge_detect_planned`` under a per-tap-group plan, the same;
* ``EdgeDetectService(partitioning=)`` serving a stream of mixed shapes in
  batches of 2 on 2 worker threads (rank 0 serves, ranks 1–3 follow), on
  ``approx_cuda`` and under the plan, every map equal to ``repro``'s
  unsharded map of its image, and every follower executing each batch;
* ``fused=True`` with a partitioning raises ``repro``'s message.
"""
import numpy as np
import pytest

from tests import test_torch_ranks as tr

REPRO = """
import numpy as np
import jax.numpy as jnp
from repro.nn import conv
from repro.nn import plan as plan_mod
from repro.launch.mesh import contraction_partitioning
from tests import test_torch_ranks as tr
part = contraction_partitioning(MESH)
imgs = jnp.asarray(tr.edge_batch())
from repro.kernels.closed_form import closed_form_f00
from repro.nn import substrate as sub
# approx_pallas's f(0,0) is computed once and cached; repro cannot compute
# it inside the shard_map body's trace, so it is computed here first
closed_form_f00(sub.get_substrate("approx_pallas:proposed@8")._key)
for spec, jspec in tr.EDGE_SPECS:
    OUT[("batched", spec, "unsharded")] = np.asarray(
        conv.edge_detect_batched(imgs, jspec))
    OUT[("batched", spec)] = np.asarray(conv.edge_detect_batched(
        imgs, jspec, partitioning=part))
plan = plan_mod.SubstratePlan.from_dict(tr.EDGE_PLAN)
OUT["planned"] = np.asarray(conv.edge_detect_planned(imgs, plan,
                                                     partitioning=part))
OUT[("planned", "unsharded")] = np.asarray(conv.edge_detect_planned(imgs, plan))
served = tr.served_images()
OUT["served"] = [np.asarray(conv.edge_detect_batched(
    jnp.asarray(im)[None], "approx_bitexact"))[0] for im in served]
OUT["served_plan"] = [np.asarray(conv.edge_detect_planned(
    jnp.asarray(im)[None], plan))[0] for im in served]
try:
    conv.conv2d_batched(conv.to_signed_pixels(imgs), conv.LAPLACIAN,
                        "approx_pallas", partitioning=part, fused=True)
except ValueError as e:
    OUT["fused"] = str(e)
"""


@pytest.fixture(scope="module")
def repro_out(tmp_path_factory):
    return tr.run_repro(REPRO, tmp_path_factory.mktemp("repro"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tr.spawn("edge_program", 4, tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("spec", [s for s, _ in tr.EDGE_SPECS])
def test_sharded_edge_detect_batched_is_byte_identical(ranks, repro_out, spec):
    want = repro_out[("batched", spec)]
    np.testing.assert_array_equal(want, repro_out[("batched", spec, "unsharded")])
    for rank, out in enumerate(ranks):
        np.testing.assert_array_equal(out[("batched", spec)], want,
                                      err_msg=f"rank {rank}")


def test_sharded_edge_detect_planned_is_byte_identical(ranks, repro_out):
    want = repro_out["planned"]
    np.testing.assert_array_equal(want, repro_out[("planned", "unsharded")])
    for rank, out in enumerate(ranks):
        np.testing.assert_array_equal(out["planned"], want,
                                      err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", ["served", "served_plan"])
def test_partitioned_service_serves_repros_maps(ranks, repro_out, name):
    """Rank 0's served maps equal ``repro``'s unsharded map of each image;
    the three followers executed the same batches (3: the shapes bucket
    into 3 buckets of at most 2)."""
    got = ranks[0][name]
    assert len(got) == len(tr.SERVED_SHAPES)
    for i, (g, w) in enumerate(zip(got, repro_out[name])):
        np.testing.assert_array_equal(g, w, err_msg=f"image {i}")
    followed = [out[(name, "followed")] for out in ranks[1:]]
    assert followed == [followed[0]] * 3 and followed[0] >= 3
    assert name not in ranks[1]


def test_fused_with_a_partitioning_raises_repros_message(ranks, repro_out):
    assert "incompatible with partitioning" in repro_out["fused"]
    for out in ranks:
        assert out["fused"] == repro_out["fused"]
