"""The sharded contraction against ``repro``'s, on CPU ranks.

``repro``'s side runs once per module in a subprocess with 4 forced host
devices and a 2 × 2 ``("data", "model")`` mesh with Auto axes (jax 0.9's
default Explicit axes break ``repro``'s sharded code:
``tests/test_distributed.py``'s failures). The port's side runs once per
module on 4 ``gloo`` ranks of a 2 × 2 ``DeviceMesh``
(``tests/test_torch_ranks.py``), every rank holding the whole operands and
returning the whole result. Cases:

* ``Partitioning``'s validation, with ``repro``'s messages;
  ``partitioning_scope`` nesting; ``ContractionSpec`` in ``repro``'s field
  order;
* the grid of ``tests/test_dot_general.py::test_sharded_bit_identity_8_devices``
  (6 specs × 3 shapes × M only, K only, M + K: non-divisible M, K and N,
  the psum fallback, ``design_strollo2020``'s f(0,0) beside proposed's),
  plus the port's ``approx_cuda`` at three wirings (its plain version here;
  ``repro``'s side runs ``approx_lut`` at the same wirings, the same
  products): every rank's result equal bit for bit to ``repro``'s sharded
  and unsharded results (``repro``'s calls jitted: its eager ``shard_map``
  takes 3–6× longer);
* the quantized float path: bit for bit for int8 / approx_bitexact /
  approx_lut, ``exact`` within 1e-5 (a float psum, as ``repro``'s own test
  allows);
* ``approx_stat``: K = 19 raises ``repro``'s message, K = 32 within 4 of
  ``repro``'s sharded result (the per-shard float32 corrections truncate
  apart, ±1 a shard, as ``tests/test_torch_substrate.py`` allows ±1);
* batch dimensions under a partitioning raise;
* a world of one (a 1 × 1 mesh) changes nothing.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.nn import substrate as jsub
from repro_torch.launch import mesh as ml
from repro_torch.nn import substrate as sub
from tests import test_torch_ranks as tr

CASES = [(spec, shape, m, k) for spec in tr.GRID_SPECS + tr.CUDA_SPECS
         for shape in tr.SHAPES for m, k in tr.PARTS]

REPRO = """
import numpy as np
import jax.numpy as jnp
from repro.nn import substrate as sub
from tests import test_torch_ranks as tr
# approx_cuda's products are approx_lut's at the same wiring
REPRO_SPEC = {s: s for s in tr.GRID_SPECS} | {
    s: s.replace("approx_cuda", "approx_lut") for s in tr.CUDA_SPECS}
ops = tr.grid_operands()
for spec in tr.GRID_SPECS + tr.CUDA_SPECS:
    s = sub.get_substrate(REPRO_SPEC[spec])
    for m_axis, k_axis in tr.PARTS:
        part = sub.Partitioning(MESH, m_axis=m_axis, k_axis=k_axis)
        f = jax.jit(lambda a, b, s=s, p=part: s.dot_general(
            a, b, sub.ContractionSpec(partitioning=p)))
        for shape, (a, b) in ops.items():
            OUT[(spec, shape, m_axis, k_axis)] = np.asarray(f(a, b))
    for shape, (a, b) in ops.items():
        OUT[(spec, shape, "unsharded")] = np.asarray(s.dot_int(a, b))
x, w = map(jnp.asarray, tr.float_operands())
part = sub.Partitioning(MESH, m_axis="data", k_axis="model")
for spec in tr.FLOAT_SPECS:
    s = sub.get_substrate(spec)
    OUT[("float", spec)] = np.asarray(s.dot_general(
        x, w, sub.ContractionSpec.matmul(quant=sub.QuantPolicy(),
                                         partitioning=part)))
    OUT[("float", spec, "unsharded")] = np.asarray(s.dot(x, w))
stat = sub.get_substrate("approx_stat")
rng = np.random.default_rng(7)
for k in (19, 32):
    a = rng.integers(-128, 128, (6, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, 4)).astype(np.int8)
    try:
        OUT[("stat", k)] = np.asarray(stat.dot_general(
            jnp.asarray(a), jnp.asarray(b),
            sub.ContractionSpec(partitioning=part)))
    except ValueError as e:
        OUT[("stat", k)] = str(e)
"""


@pytest.fixture(scope="module")
def repro_out(tmp_path_factory):
    return tr.run_repro(REPRO, tmp_path_factory.mktemp("repro"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tr.spawn("contraction_program", 4, tmp_path_factory.mktemp("ranks"))


@pytest.fixture()
def world1():
    """A gloo world of one in this process, torn down after the test."""
    ml.init_ranks("gloo")
    try:
        yield ml.make_debug_mesh()
    finally:
        dist.destroy_process_group()


class _Mesh:
    """Only what ``Partitioning`` validates: the axis names."""
    mesh_dim_names = ("data", "model")


# ---------------------------------------------------------------------------
# the policy objects
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m_axis,k_axis", [(None, None), ("pod", None),
                                           ("data", "pod"), ("model", "model")])
def test_partitioning_validation_matches_repro(m_axis, k_axis):
    """The same three ``ValueError``s, with ``repro``'s words."""
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError) as want:
        jsub.Partitioning(jmesh, m_axis=m_axis, k_axis=k_axis)
    with pytest.raises(ValueError) as got:
        sub.Partitioning(_Mesh(), m_axis=m_axis, k_axis=k_axis)
    assert str(got.value) == str(want.value)


def test_partitioning_scope_nests():
    p = sub.Partitioning(_Mesh(), m_axis="data")
    q = sub.Partitioning(_Mesh(), m_axis=None, k_axis="model")
    assert sub.current_partitioning() is None
    with sub.partitioning_scope(p):
        assert sub.current_partitioning() is p
        with sub.partitioning_scope(q):
            assert sub.current_partitioning() is q
            with sub.partitioning_scope(None):
                assert sub.current_partitioning() is None
            assert sub.current_partitioning() is q
        assert sub.current_partitioning() is p
    assert sub.current_partitioning() is None


def test_contraction_spec_takes_repros_positional_arguments():
    """``(dimension_numbers, quant, partitioning, site)`` in both, and
    ``matmul(quant, partitioning, site)``."""
    assert ([f.name for f in dataclasses.fields(sub.ContractionSpec)]
            == [f.name for f in dataclasses.fields(jsub.ContractionSpec)])
    p = sub.Partitioning(_Mesh(), m_axis="data")
    q = sub.QuantPolicy()
    spec = sub.ContractionSpec(sub.MATMUL_DIMS, q, p, "layer.0.attn.wq")
    assert (spec.quant, spec.partitioning, spec.site) == (q, p, "layer.0.attn.wq")
    assert sub.ContractionSpec.matmul(q, p, "s") == sub.ContractionSpec(
        sub.MATMUL_DIMS, q, p, "s")


def test_world_of_one_changes_nothing(world1):
    """On a 1 × 1 mesh every partitioning gives the unsharded result."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.integers(-128, 128, (7, 13)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (13, 5)).astype(np.int8))
    assert ml.contraction_partitioning(world1).k_shards == 1
    for spec in ("approx_lut", "approx_cuda:design_strollo2020", "int8"):
        s = sub.get_substrate(spec)
        for m_axis, k_axis in tr.PARTS:
            part = sub.Partitioning(world1, m_axis=m_axis, k_axis=k_axis)
            assert torch.equal(s.dot_general(
                a, b, sub.ContractionSpec(partitioning=part)), s.dot_int(a, b))


# ---------------------------------------------------------------------------
# 4 ranks against repro's sharded and unsharded paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,shape,m_axis,k_axis", CASES)
def test_sharded_grid_is_bit_identical(ranks, repro_out, spec, shape, m_axis,
                                       k_axis):
    key = (spec, shape, m_axis, k_axis)
    want = repro_out[key]
    np.testing.assert_array_equal(want, repro_out[(spec, shape, "unsharded")])
    for rank, out in enumerate(ranks):
        np.testing.assert_array_equal(out[key].numpy(), want,
                                      err_msg=f"rank {rank}")
        np.testing.assert_array_equal(out[(spec, shape, "unsharded")].numpy(),
                                      want, err_msg=f"rank {rank} unsharded")


@pytest.mark.parametrize("spec", tr.FLOAT_SPECS)
def test_sharded_quantized_float_path(ranks, repro_out, spec):
    """Bit for bit for the integer-exact backends (int32 partial sums
    reduce exactly, the scales are the unsharded ones); ``exact`` within
    1e-5, a float psum (``repro``'s own tolerance)."""
    want = repro_out[("float", spec)]
    for rank, out in enumerate(ranks):
        got = out[("float", spec)].numpy()
        unsharded = out[("float", spec, "unsharded")].numpy()
        if spec == "exact":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got, unsharded, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"rank {rank}")
            np.testing.assert_array_equal(got, unsharded)
            np.testing.assert_array_equal(
                unsharded, repro_out[("float", spec, "unsharded")])


def test_sharded_stat_needs_divisible_k(ranks, repro_out):
    """K = 19 raises ``repro``'s message on every rank; at K = 32 within 4
    of ``repro``'s sharded result."""
    assert isinstance(repro_out[("stat", 19)], str)
    for out in ranks:
        assert out[("stat", 19)] == repro_out[("stat", 19)]
        got = out[("stat", 32)].numpy().astype(np.int64)
        assert np.abs(got - repro_out[("stat", 32)]).max() <= 4


def test_batch_dimensions_under_a_partitioning_raise(ranks):
    for out in ranks:
        for key in ("approx_lut", "exact", "exact_float"):
            assert "batch dimensions is not supported" in out[("batch", key)]
