"""Parity of the port's substrate registry (``repro_torch.nn.substrate``)
with ``repro.nn.substrate``: the spec grammar and its strictness, the
``approx_pallas`` alias, the kernel kinds of ``approx_cuda``, and the
unsharded ``dot_general`` cases of ``tests/test_dot_general.py`` on every
backend (CPU tensors; ``repro``'s Pallas kernels run in interpret mode)."""
import numpy as np
import pytest
import torch

from repro.nn import substrate as jsub
from repro.nn.substrate import ContractionSpec as JSpec
from repro.nn.substrate import QuantPolicy as JQuant
from repro_torch.core import multiplier as tm
from repro_torch.nn import substrate as sub
from repro_torch.nn.substrate import ContractionSpec, QuantPolicy

RNG = np.random.default_rng(7)

#: port spec → the reference spec it is held against
SPECS = {"exact": "exact", "approx_bitexact": "approx_bitexact",
         "approx_lut": "approx_lut", "approx_cuda": "approx_pallas"}

DIM_CASES = [
    ((5, 7), (7, 3), (((1,), (0,)), ((), ()))),
    ((5, 7), (7, 3), (((-1,), (0,)), ((), ()))),
    ((7, 5), (7, 3), (((0,), (0,)), ((), ()))),
    ((5, 7), (3, 7), (((1,), (1,)), ((), ()))),
    ((2, 5, 7), (2, 7, 3), (((2,), (1,)), ((0,), (0,)))),
    ((2, 5, 7), (7, 2, 3), (((2,), (0,)), ((0,), (1,)))),
    ((2, 3, 4, 9), (9, 1), (((3,), (0,)), ((), ()))),
    ((5, 2, 3), (2, 3, 4), (((1, 2), (0, 1)), ((), ()))),
    ((7,), (7, 3), (((0,), (0,)), ((), ()))),
]


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("bad", [
    "exact:", "approx_pallas:proposed@8 ", " approx_lut", "approx_lut :proposed",
    ":proposed", "", "approx_lut:@4"])
def test_malformed_specs_rejected(bad):
    for mod in (jsub, sub):
        with pytest.raises(ValueError, match="mult_name"):
            mod.parse_spec(bad)
        with pytest.raises(ValueError, match="mult_name"):
            mod.get_substrate(bad)


def test_empty_wiring_and_bad_width_rejected():
    with pytest.raises(ValueError, match="mult_name"):
        sub.get_substrate("approx_bitexact", mult_name="@4")
    for bad in ("proposed@ 8", "proposed@+8", "proposed@-8", "proposed@",
                "proposed@８"):
        with pytest.raises(ValueError, match="bad width suffix"):
            tm.split_width(bad)
        with pytest.raises(ValueError):
            sub.get_substrate(f"approx_lut:{bad}")
    with pytest.raises(ValueError, match="unknown product substrate"):
        sub.get_substrate("approx_tpu")
    with pytest.raises(ValueError, match="takes no multiplier wiring"):
        sub.get_substrate("exact:design_du2022")


@pytest.mark.parametrize("spec", ["approx_pallas:csp_axc1@4", "exact",
                                  "approx_lut:design_du2022",
                                  "approx_bitexact:proposed@16"])
def test_well_formed_specs_parse_like_reference(spec):
    assert tuple(sub.parse_spec(spec)) == tuple(jsub.parse_spec(spec))


def test_approx_pallas_alias_resolves_to_cuda_backend():
    s = sub.get_substrate("approx_pallas:design_du2022@4")
    assert isinstance(s, sub.CudaSubstrate)
    assert s.meta.spec == "approx_cuda:design_du2022@4"
    assert sub.get_substrate("approx_pallas:design_du2022@4") is s
    assert sub.get_substrate(s.meta.spec).meta == s.meta
    assert (s.meta.width, s._f00) == (4, jsub.get_substrate(
        "approx_pallas:design_du2022@4")._f00)
    with pytest.raises(ValueError, match="widths <= 8"):
        sub.get_substrate("approx_cuda:proposed@16")


#: backends and wirings whose contraction is a table or a statistical model:
#: port spec → reference spec, and the tolerance of ``dot_general`` on
#: integers. approx_stat adds a float32 sum of K per-operand corrections,
#: truncated to int32 once per output; XLA and torch sum in different orders,
#: so the float32 sums may differ by a few ulp (values ≪ 2^20 here, ulp
#: ≤ 1/16), and two floats less than 1 apart truncate at most 1 apart.
TABLE_SPECS = {"int8": ("int8", 0), "approx_stat": ("approx_stat", 1),
               "approx_cuda:exact": ("approx_pallas:exact", 0),
               "approx_pallas:exact@4": ("approx_pallas:exact@4", 0)}


@pytest.mark.parametrize("spec", sorted(TABLE_SPECS))
def test_later_slices_raise_not_implemented(spec):
    """These four specs raised NotImplementedError in the port's first
    slice; each now resolves and matches ``repro`` on ``scalar`` (in-range
    and wrapping operands) and on a ragged 2-D ``dot_int``."""
    ref_spec, tol = TABLE_SPECS[spec]
    s, js = sub.get_substrate(spec), jsub.get_substrate(ref_spec)
    assert (s.meta.width, s.meta.bit_exact, s.meta.scalar_faithful) == \
        (js.meta.width, js.meta.bit_exact, js.meta.scalar_faithful)
    a = RNG.integers(-300, 300, 4096).astype(np.int32)
    b = RNG.integers(-300, 300, 4096).astype(np.int32)
    if spec == "int8":  # an exact product, no wrapping: keep it in range
        a, b = a % 256 - 128, b % 256 - 128
    np.testing.assert_array_equal(s.scalar(_t(a), _t(b)).numpy(),
                                  np.asarray(js.scalar(a, b)), err_msg=spec)
    x = RNG.integers(-128, 128, (9, 37)).astype(np.int32)
    w = RNG.integers(-128, 128, (37, 5)).astype(np.int32)
    np.testing.assert_allclose(s.dot_int(_t(x), _t(w)).numpy(),
                               np.asarray(js.dot_int(x, w)), rtol=0, atol=tol,
                               err_msg=spec)


@pytest.mark.parametrize("spec", sorted(TABLE_SPECS))
@pytest.mark.parametrize("case", DIM_CASES,
                         ids=[str(i) for i in range(len(DIM_CASES))])
def test_table_backends_dot_general_dims_match_reference(case, spec):
    lhs_shape, rhs_shape, dims = case
    ref_spec, tol = TABLE_SPECS[spec]
    a = RNG.integers(-100, 100, lhs_shape).astype(np.int8)
    b = RNG.integers(-100, 100, rhs_shape).astype(np.int8)
    want = np.asarray(jsub.get_substrate(ref_spec).dot_general(
        a, b, JSpec(dims)))
    got = sub.get_substrate(spec).dot_general(_t(a), _t(b), ContractionSpec(dims))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol,
                               err_msg=spec)


@pytest.mark.parametrize("kernel", ["auto", "closed_form", "lut"])
@pytest.mark.parametrize("key", ["proposed", "design_strollo2020@4", "exact@4"])
def test_cuda_kernel_kinds_match_pallas_substrate(kernel, key):
    """``CudaSubstrate(kernel=)`` takes ``PallasSubstrate``'s three values:
    the same kind, the same cost hint, the same integers (K=19 leaves a K
    tail, so the f(0,0) of proposed@8 under the table kind shows), and the
    same refusal of ``closed_form`` for ``exact``."""
    if kernel == "closed_form" and key.startswith("exact"):
        with pytest.raises(ValueError):
            jsub.PallasSubstrate(key, kernel=kernel)
        with pytest.raises(ValueError):
            sub.CudaSubstrate(key, kernel=kernel)
        return
    js = jsub.PallasSubstrate(key, kernel=kernel)
    s = sub.CudaSubstrate(key, kernel=kernel)
    assert s._kernel_kind == js._kernel_kind
    assert s.meta.cost_hint == {"vpu": "int32-alu", "gather": "gather"}[
        js.meta.cost_hint]
    a = RNG.integers(-128, 128, (7, 19)).astype(np.int32)
    b = RNG.integers(-128, 128, (19, 3)).astype(np.int32)
    np.testing.assert_array_equal(s.dot_int(_t(a), _t(b)).numpy(),
                                  np.asarray(js.dot_int(a, b)))
    imgs = RNG.integers(-8, 8, (2, 9, 11)).astype(np.int32)
    from repro.nn import conv as jconv

    np.testing.assert_array_equal(
        s.fused_conv2d(_t(imgs), jconv.LAPLACIAN).numpy(),
        np.asarray(js.fused_conv2d(imgs, jconv.LAPLACIAN)))
    with pytest.raises(ValueError, match="known: auto, closed_form, lut"):
        sub.CudaSubstrate(key, kernel="tiled")


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("case", DIM_CASES,
                         ids=[str(i) for i in range(len(DIM_CASES))])
def test_dot_general_dims_match_reference(case, spec):
    lhs_shape, rhs_shape, dims = case
    a = RNG.integers(-100, 100, lhs_shape).astype(np.int8)
    b = RNG.integers(-100, 100, rhs_shape).astype(np.int8)
    want = np.asarray(jsub.get_substrate(SPECS[spec]).dot_general(
        a, b, JSpec(dims)))
    got = sub.get_substrate(spec).dot_general(_t(a), _t(b), ContractionSpec(dims))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want, err_msg=spec)


def test_dimension_number_validation():
    s = sub.get_substrate("exact")
    a = torch.zeros((4, 5), dtype=torch.int8)
    b = torch.zeros((6, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="contracting dimension mismatch"):
        s.dot_general(a, b, ContractionSpec((((1,), (0,)), ((), ()))))
    with pytest.raises(ValueError, match="out of range"):
        s.dot_general(a, a, ContractionSpec((((3,), (0,)), ((), ()))))
    with pytest.raises(ValueError, match="duplicate"):
        s.dot_general(a, a, ContractionSpec((((1, 1), (0, 0)), ((), ()))))
    with pytest.raises(ValueError, match="both contracting and batch"):
        s.dot_general(a, a, ContractionSpec((((0,), (0,)), ((0,), (1,)))))
    with pytest.raises(ValueError, match="must pair up"):
        s.dot_general(a, a, ContractionSpec((((1,), ()), ((), ()))))
    with pytest.raises(TypeError, match="integer-domain"):
        sub.get_substrate("approx_cuda").dot_general(
            torch.zeros((4, 5)), torch.zeros((5, 3)))
    with pytest.raises(TypeError, match="torch tensor"):
        s.dot_general(np.zeros((4, 5), np.int8), b)


POLICIES = [JQuant(), JQuant(x_mode="per_channel", w_mode="per_tensor"),
            JQuant(bits=4)]


@pytest.mark.parametrize("spec", ["approx_bitexact", "approx_lut", "approx_cuda",
                                  "int8"])
@pytest.mark.parametrize("pol", range(len(POLICIES)))
def test_quantized_float_path_matches_reference(spec, pol):
    """Integer contraction exact; the f32 scale product rounds the same way
    in both packages (half-to-even quantization), held to rtol 1e-6."""
    jq = POLICIES[pol]
    tq = QuantPolicy(bits=jq.bits, x_mode=jq.x_mode, w_mode=jq.w_mode)
    x = RNG.normal(size=(3, 5, 24)).astype(np.float32)
    w = RNG.normal(size=(24, 6)).astype(np.float32)
    want = np.asarray(jsub.get_substrate(SPECS.get(spec, spec)).dot_general(
        x, w, JSpec.matmul(quant=jq)))
    got = sub.get_substrate(spec).dot_general(_t(x), _t(w),
                                              ContractionSpec.matmul(quant=tq))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_pinned_scales_and_exact_float_reference():
    x = RNG.normal(size=(4, 16)).astype(np.float32)
    w = RNG.normal(size=(16, 3)).astype(np.float32)
    xs, ws = np.float32(0.02), np.full((3,), 0.03, np.float32)
    want = np.asarray(jsub.get_substrate("approx_lut").dot_general(
        x, w, JSpec.matmul(quant=JQuant(x_scale=xs, w_scale=ws))))
    got = sub.get_substrate("approx_lut").dot_general(
        _t(x), _t(w), ContractionSpec.matmul(
            quant=QuantPolicy(x_scale=_t(xs), w_scale=_t(ws))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # the exact backend's float path is a plain float32 product: summation
    # order differs between the two libraries, so it is held to float32
    # rounding over K=16 terms of magnitude ≲ 4
    want = np.asarray(jsub.get_substrate("exact").dot_general(
        x, w, JSpec.matmul(quant=JQuant())))
    got = sub.get_substrate("exact").dot_general(
        _t(x), _t(w), ContractionSpec.matmul(quant=QuantPolicy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_zero_activations_give_zero_output_and_scalar_faithful(spec):
    """Zero activations: the epsilon-guarded scale keeps the output finite
    and the compensation constant's f(0, b) below float precision (exactly
    zero on the exact backend), as in the reference."""
    s = sub.get_substrate(spec)
    w = RNG.normal(size=(8, 4)).astype(np.float32)
    out = s.dot_general(torch.zeros((3, 8)), _t(w),
                        ContractionSpec.matmul(quant=QuantPolicy()))
    want = np.asarray(jsub.get_substrate(SPECS[spec]).dot_general(
        np.zeros((3, 8), np.float32), w, JSpec.matmul(quant=JQuant())))
    assert torch.isfinite(out).all() and (out.abs() < 1e-6).all()
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=0)
    if spec == "exact":
        assert (out == 0).all()
    a = _t(RNG.integers(-128, 128, (4, 21)).astype(np.int32))
    b = _t(RNG.integers(-128, 128, (21, 3)).astype(np.int32))
    want = s.scalar(a[:, :, None], b[None, :, :]).to(torch.int64).sum(1)
    np.testing.assert_array_equal(s.dot_int(a, b).numpy(), want.numpy())


def test_quant_policy_validation():
    with pytest.raises(ValueError, match="x_mode"):
        QuantPolicy(x_mode="per_row")
    with pytest.raises(ValueError, match="bits"):
        QuantPolicy(bits=17)
    with pytest.raises(ValueError, match="eps"):
        QuantPolicy(eps=0.0)
    with pytest.raises(ValueError, match="exceeds the substrate operand width"):
        sub.get_substrate("approx_cuda:proposed@4").dot_general(
            torch.zeros((2, 3)), torch.zeros((3, 2)),
            ContractionSpec.matmul(quant=QuantPolicy(bits=8)))


def test_contraction_site_is_observational():
    """``ContractionSpec.site`` names the contraction; the result never
    depends on it, as in ``repro``."""
    a = _t(RNG.integers(-128, 128, (2, 5, 9)).astype(np.int32))
    w = _t(RNG.integers(-128, 128, (9, 3)).astype(np.int32))
    dims = (((2,), (0,)), ((), ()))
    spec = ContractionSpec(dims, site="conv.edge.ring")
    assert spec.site == "conv.edge.ring" and ContractionSpec().site is None
    assert ContractionSpec.matmul(site="x").site == "x"
    assert JSpec.matmul(site="x").site == "x"
    for name in ("approx_cuda:csp_axc1@6", "approx_stat", "int8"):
        s = sub.get_substrate(name)
        np.testing.assert_array_equal(
            s.dot_general(a, w, spec).numpy(),
            s.dot_general(a, w, ContractionSpec(dims)).numpy())
