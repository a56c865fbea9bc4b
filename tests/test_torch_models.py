"""The port's LM model stack (lm with its MoE configs, vlm) and every
registered config against ``repro``, on the CPU.

Sizes are ``tests/test_models_smoke.py``'s ``reduced`` configs at float32.
``repro`` draws the parameters from ``PRNGKey(0)`` and
``models.convert.lm_params_from_jax`` carries them across, so both packages
run the same numbers. Tolerances:

* ``dense`` under an integer substrate is bit-identical given the same
  float32 inputs (the same quantization codes, the same int32 sums, the same
  float32 rescale); under ``exact`` it is a float32 matmul, held to 1e-5
  (XLA and torch sum in another order).
* Whole-model logits are held to ``LOGIT_ATOL`` = 1e-4 (about 3e-5 of
  their range; the measured gap is below 1e-5): rms_norm, rope, softmax
  and silu round differently in XLA and torch by a few float32 ulps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.nn import plan as jplan
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.models import registry as reg
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.nn import plan as tplan
from repro_torch.nn import substrate as tsub
from tests.test_models_smoke import reduced

PORTED = ["edge-detect", "gemma3-27b", "internlm2-20b", "kimi-k2-1t-a32b",
          "llama4-maverick-400b-a17b", "minitron-8b", "paligemma-3b",
          "qwen1.5-32b", "whisper-large-v3", "xlstm-125m", "zamba2-1.2b"]
LOGIT_ATOL = 1e-4
PARAMS_MINITRON = 8_833_204_224
RNG = np.random.default_rng(7)


#: ``repro`` fields the port leaves out: XLA's cost-analysis switch
#: (``cost_unroll``: the port's dry run counts eagerly, every loop iteration
#: included, so it has no counterpart) and the deprecated ``dot_mode`` shim
#: (its spec lands in ``dot_plan``).
#: The ported configs hold ``repro``'s defaults there.
DROPPED = {"cost_unroll", "dot_mode"}


def port_cfg(jcfg) -> cm.ModelConfig:
    """The port's config from ``repro``'s: every field the port has, with
    ``repro``'s ``dot_plan`` (or, unset, its ``dot_mode`` spec) as the plan."""
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cm.ModelConfig)}
    d["dtype"] = getattr(torch, np.dtype(jcfg.dtype).name)
    d["dot_plan"] = jcfg.dot_mode if jcfg.dot_plan is None else \
        tplan.as_plan(jplan.as_plan(jcfg.dot_plan).to_dict())
    return cm.ModelConfig(**d)


def pair(name, **extra):
    """(repro config, repro params, port config, port params) at float32."""
    jcfg = reduced(name, **{"dtype": jnp.float32, **extra})
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    return jcfg, jparams, cfg, lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_registry_lists_the_ported_archs():
    assert reg.list_archs() == PORTED


@pytest.mark.parametrize("arch", PORTED)
def test_config_fields_match_repro(arch):
    jcfg, cfg = jreg.get_config(arch), reg.get_config(arch)
    assert port_cfg(jcfg) == cfg
    assert cfg.dtype == torch.bfloat16
    jfields = {f.name: f for f in dataclasses.fields(jcfg)}
    ported = {f.name for f in dataclasses.fields(cfg)}
    assert set(jfields) - ported == DROPPED
    for name in DROPPED - {"dot_mode"}:
        assert getattr(jcfg, name) == jfields[name].default, name


@pytest.mark.parametrize("arch", PORTED)
def test_param_counts_match_repro(arch):
    jcfg, cfg = jreg.get_config(arch), reg.get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def test_build_bundle_raises_for_a_family_repro_lacks():
    cfg = dataclasses.replace(reg.get_config("minitron-8b"), family="rwkv")
    with pytest.raises(KeyError, match="family 'rwkv'"):
        reg.build_bundle(cfg)


def test_minitron_param_count_and_bf16_size():
    cfg = reg.get_config("minitron-8b")
    assert cfg.param_count() == PARAMS_MINITRON  # 2 bytes each: 17.7 GB


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------


def test_rms_norm_matches_repro():
    x = RNG.normal(size=(2, 5, 48)).astype(np.float32)
    s = RNG.normal(size=(48,)).astype(np.float32)
    want = np.asarray(jcm.rms_norm(jnp.asarray(x), jnp.asarray(s)))
    got = cm.rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dh", [8, 7])
def test_rope_matches_repro(dh):
    x = RNG.normal(size=(2, 6, 3, dh)).astype(np.float32)
    pos = RNG.integers(0, 5000, (2, 6))
    want = np.asarray(jcm.rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 5e5))
    got = cm.rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", [
    dict(sq=20, skv=20, offset=0, window=0),   # causal, 2 chunks + rem 4
    dict(sq=20, skv=20, offset=0, window=5),   # windowed: masked chunks
    dict(sq=1, skv=20, offset=13, window=0),   # decode against a cache
    dict(sq=1, skv=20, offset=17, window=6),   # windowed decode
])
def test_attention_chunked_matches_repro(case):
    b, h, hkv, dh = 2, 4, 2, 8
    q = RNG.normal(size=(b, case["sq"], h, dh)).astype(np.float32)
    k = RNG.normal(size=(b, case["skv"], hkv, dh)).astype(np.float32)
    v = RNG.normal(size=(b, case["skv"], hkv, dh)).astype(np.float32)
    want = np.asarray(jcm.attention_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_offset=jnp.asarray(case["offset"], jnp.int32), window=case["window"],
        chunk=8))
    got = cm.attention_chunked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=case["offset"], window=case["window"], chunk=8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# port spec -> the repro spec computing the same integers
DENSE_SPECS = {"exact": "exact", "int8": "int8",
               "approx_bitexact:proposed@8": "approx_bitexact:proposed@8",
               "approx_cuda:proposed@8": "approx_pallas:proposed@8",
               "approx_cuda:exact": "approx_pallas:exact"}


@pytest.mark.parametrize("spec", sorted(DENSE_SPECS))
def test_dense_matches_repro(spec):
    """Under a plan that puts ``spec`` on ``layer.1.attn.wq`` (and exact
    elsewhere), at a bias and a (B, S, d) activation, as attn_block calls
    it."""
    site_rule = (("layer.1.attn.wq", spec),)
    jcfg = reduced("minitron-8b", dtype=jnp.float32, dot_plan=jplan.SubstratePlan(
        "exact", (("layer.1.attn.wq", DENSE_SPECS[spec]),)))
    cfg = dataclasses.replace(port_cfg(jcfg),
                              dot_plan=tplan.SubstratePlan("exact", site_rule))
    x = RNG.normal(size=(2, 8, 64)).astype(np.float32)
    w = (RNG.normal(size=(64, 128)) / 8).astype(np.float32)
    b = RNG.normal(size=(128,)).astype(np.float32)
    with jplan.site_scope("layer.1", "attn"):
        want = np.asarray(jcm.dense(jcfg, jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), site="wq"))
    with tplan.site_scope("layer.1", "attn"):
        got = cm.dense(cfg, torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), site="wq").numpy()
    assert got.dtype == np.float32 and got.shape == (2, 8, 128)
    if spec == "exact":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
        # the plan reached the site: an approximate product is not exact
        exact = x @ w + b
        assert np.abs(got - exact).max() > 1e-3


def test_dense_resolves_every_site_per_layer(monkeypatch):
    """The layer loop gives each layer its own assignment: every dense call
    of layer 1 runs int8 and every other runs exact, at the 7 sites of a
    layer, as repro's scan + switch resolves them."""
    seen = []

    def spy(orig):
        def dot_general(self, x, w, spec=None):
            seen.append((spec.site, self.meta.name))
            return orig(self, x, w, spec)
        return dot_general

    for cls in (tsub.Int8Substrate, tsub.ExactSubstrate):
        monkeypatch.setattr(cls, "dot_general", spy(cls.dot_general))
    plan = tplan.SubstratePlan("exact", (("layer.1.*", "int8"),))
    cfg = port_cfg(reduced("minitron-8b", dtype=jnp.float32))
    cfg = dataclasses.replace(cfg, dot_plan=plan)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    lm.forward(cfg, params, torch.zeros((1, 3), dtype=torch.int64))
    sites = [f"layer.{i}.{blk}.{w}" for i in range(2)
             for blk, ws in (("attn", ("wq", "wk", "wv", "wo")),
                             ("ffn", ("wg", "wi", "wo"))) for w in ws]
    assert sorted(s for s, _ in seen) == sorted(sites)
    for site, backend in seen:
        assert backend == ("int8" if site.startswith("layer.1.") else "exact")
        assert jplan.SubstratePlan("exact", (("layer.1.*", "int8"),)).resolve(
            site) == backend


def test_mixed_plan_loop_matches_repro_scan_switch():
    """As ``tests/test_plan.py``'s scan-vs-loop oracle: repro's lax.scan +
    switch over two stacked weights against the port's layer loop of site
    scopes, layer 1 approximate."""
    mixed = (("layer.1.*", "approx_bitexact:proposed@8"),)
    jcfg = dataclasses.replace(
        jreg.get_config("minitron-8b", n_layers=1, d_model=32, d_ff=64,
                        vocab=64, n_heads=2, n_kv_heads=2, dtype=jnp.float32),
        dot_plan=jplan.SubstratePlan("exact", mixed))
    cfg = port_cfg(jcfg)
    x = RNG.normal(size=(2, 8, 32)).astype(np.float32)
    w = RNG.normal(size=(2, 32, 32)).astype(np.float32)

    def body(c, xs):
        wi, i = xs
        with jplan.scan_site_scope(i, ("layer.0", "layer.1")):
            return jcm.dense(jcfg, c, wi, site="proj"), None

    want = np.asarray(jax.lax.scan(body, jnp.asarray(x),
                                   (jnp.asarray(w), jnp.arange(2)))[0])
    c = torch.from_numpy(x)
    for i in range(2):
        with tplan.site_scope(f"layer.{i}"):
            c = cm.dense(cfg, c, torch.from_numpy(w[i]), site="proj")
    np.testing.assert_allclose(c.numpy(), want, atol=1e-4, rtol=0)


def test_mixed_plan_prefill_matches_repro():
    plan = (("layer.1.*", "int8"),)
    jcfg, jparams, cfg, params = pair(
        "minitron-8b", dot_plan=jplan.SubstratePlan("exact", plan))
    toks = RNG.integers(1, cfg.vocab, (2, 16))
    want = np.asarray(jreg.build_bundle(jcfg).prefill(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)}), np.float32)
    got = reg.build_bundle(cfg).prefill(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["minitron-8b", "gemma3-27b"])
def test_logits_match_repro(arch):
    """forward / prefill at S = 40 (gemma3: local window 32 and one global
    layer, attention chunk 64), then 3 decode steps against KV caches."""
    jcfg, jparams, cfg, params = pair(arch)
    toks = RNG.integers(0, cfg.vocab, (2, 40))
    jt = jnp.asarray(toks, jnp.int32)
    np.testing.assert_allclose(
        lm.forward(cfg, params, torch.from_numpy(toks)).numpy(),
        np.asarray(jlm.forward(jcfg, jparams, jt)), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(
        lm.prefill(cfg, params, torch.from_numpy(toks)).numpy(),
        np.asarray(jlm.prefill(jcfg, jparams, jt)), atol=LOGIT_ATOL, rtol=0)
    jcaches = jlm.init_kv_caches(jcfg, 2, 16)
    caches = lm.init_kv_caches(cfg, 2, 16)
    step = jax.jit(lambda p, c, t, n: jlm.decode_step(jcfg, p, c, t, n))
    for i in range(3):
        want, jcaches = step(jparams, jcaches, jt[:, i:i + 1],
                             jnp.asarray(i, jnp.int32))
        got, caches = lm.decode_step(cfg, params, caches,
                                     torch.from_numpy(toks[:, i:i + 1]), i)
        assert got.shape == (2, 1, cfg.vocab) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, rtol=0)


def _with_qkv_biases(cfg, jparams, rng):
    """Random nonzero QKV biases in ``repro``'s parameters, carried across
    (the smoke configs draw zero biases)."""
    for unit in jparams["unit"]:
        for name in ("wq", "wk", "wv"):
            b = unit["attn"][name]["b"]
            unit["attn"][name]["b"] = jnp.asarray(
                rng.normal(size=b.shape).astype(np.float32) / 4)
    return jparams, lm_params_from_jax(cfg, jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("arch,spec,biases", [
    ("qwen1.5-32b", "exact", True), ("qwen1.5-32b", "int8", True),
    ("internlm2-20b", "int8", False),
    ("minitron-8b", "approx_bitexact", False),
])
def test_prefill_logits_match_repro(arch, spec, biases):
    """prefill at S = 24 through the dense path whose integer operands the
    contraction kernels take (int8 codes), per substrate; qwen1.5 with
    random nonzero QKV biases. Its own generator, so that the tokens do not
    depend on which tests ran before (a quantizing substrate can flip a
    code where XLA and torch round an input a few ulps apart across a
    rounding boundary: the header's caveat)."""
    rng = np.random.default_rng(16)
    jcfg, jparams, cfg, params = pair(arch, dot_plan=spec)
    if biases:
        assert cfg.qkv_bias
        jparams, params = _with_qkv_biases(cfg, jparams, rng)
        assert all(float(layer.attn.wq.b.abs().sum()) > 0 for layer in params.layers)
    toks = rng.integers(0, cfg.vocab, (2, 24))
    want = np.asarray(jlm.prefill(jcfg, jparams, jnp.asarray(toks, jnp.int32)))
    got = lm.prefill(cfg, params, torch.from_numpy(toks))
    assert got.shape == (2, 1, cfg.vocab) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


def test_int8_prefill_matches_repro():
    """Under a quantizing substrate: the same codes wherever the float32
    inputs of a ``dense`` agree to the rounding boundary, so the logits
    agree to ``LOGIT_ATOL``."""
    jcfg, jparams, cfg, params = pair("minitron-8b", dot_plan="int8")
    toks = RNG.integers(0, cfg.vocab, (2, 24))
    np.testing.assert_allclose(
        lm.prefill(cfg, params, torch.from_numpy(toks)).numpy(),
        np.asarray(jlm.prefill(jcfg, jparams, jnp.asarray(toks, jnp.int32))),
        atol=LOGIT_ATOL, rtol=0)


def test_decode_step_writes_caches_in_place():
    _, _, cfg, params = pair("minitron-8b")
    caches = lm.init_kv_caches(cfg, 1, 4)
    before = [k.data_ptr() for k, _ in caches]
    _, out = lm.decode_step(cfg, params, caches, torch.tensor([[3]]), 2)
    assert out is caches and [k.data_ptr() for k, _ in out] == before
    k0, v0 = caches[0]
    assert k0[:, 2].abs().sum() > 0 and v0[:, 2].abs().sum() > 0
    assert k0[:, :2].abs().sum() == 0 and k0[:, 3:].abs().sum() == 0
    with pytest.raises(ValueError, match="exceed"):
        lm.decode_step(cfg, params, caches, torch.tensor([[3]]), 4)


# ---------------------------------------------------------------------------
# parameters across the packages
# ---------------------------------------------------------------------------


def test_lm_params_from_jax_unstacks_units_and_keeps_bf16():
    """gemma3 at 8 layers: one unit of 6 (5 local + 1 global) stacked over
    one repeat, then a tail of 2; bfloat16 kept bit for bit."""
    jcfg = reduced("gemma3-27b", n_layers=8)
    assert jlm.unit_period(jcfg) == 6 and jcfg.dtype == jnp.bfloat16
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    cfg = port_cfg(jcfg)
    params = lm_params_from_jax(cfg, tree)
    assert len(params.layers) == 8
    assert [layer.window for layer in params.layers] == \
        [d["window"] for d in jlm.layer_plan(jcfg)]
    for i, layer in enumerate(params.layers):
        src = tree["unit"][i] if i < 6 else tree["tail"][i - 6]
        pick = (lambda a: a[0]) if i < 6 else (lambda a: a)
        for blk, names in (("attn", ("wq", "wk", "wv", "wo")),
                           ("ffn", ("wi", "wg", "wo"))):
            for n in names:
                w = getattr(getattr(layer, blk), n).w
                assert w.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    w.view(torch.int16).numpy(),
                    pick(src[blk][n]["w"]).view(np.int16))
            assert getattr(layer, blk).ln.dtype == torch.float32
    assert params.embed.emb.dtype == torch.bfloat16
    assert params.embed.emb_f32.dtype == torch.float32
    np.testing.assert_array_equal(params.embed.emb_f32.numpy(),
                                  tree["embed"]["emb"].astype(np.float32))


def test_init_params_is_seeded_and_shaped():
    cfg = port_cfg(reduced("qwen1.5-32b"))
    a = lm.init_params(cfg, torch.Generator().manual_seed(5))
    b = lm.init_params(cfg, torch.Generator().manual_seed(5))
    for (na, ta), (_, tb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(ta, tb), na
    layer = a.layers[0]
    assert layer.attn.wq.w.shape == (cfg.d_model, cfg.n_heads * cfg.dh)
    assert layer.attn.wk.b.shape == (cfg.n_kv_heads * cfg.dh,)  # qkv_bias
    assert layer.attn.wo.b is None and layer.ffn.wo.w.shape == (cfg.d_ff, cfg.d_model)
    assert sum(t.numel() for t in a.parameters()) == cfg.param_count() + \
        2 * cfg.d_model * cfg.n_layers + cfg.d_model + cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.dh


# ---------------------------------------------------------------------------
# the MoE configs and the vlm
# ---------------------------------------------------------------------------

#: port spec -> repro spec of the same numbers, for the whole-model checks
#: (``approx_cuda``'s plain versions compute the integers of repro's
#: ``approx_lut``, the bit-true model's product table, which XLA runs about
#: 3x faster than ``approx_bitexact`` at these sizes)
MODEL_SPECS = {"exact": "exact", "int8": "int8",
               "approx_cuda:proposed@8": "approx_lut:proposed@8"}
FAMILY_ARCHS = ["kimi-k2-1t-a32b", "llama4-maverick-400b-a17b", "paligemma-3b"]


@pytest.fixture(scope="module")
def family_pairs():
    """``pair(arch)`` once per module, shared by the cases below."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = pair(arch)
        return cache[arch]

    return get


@pytest.mark.parametrize("spec", sorted(MODEL_SPECS))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_moe_and_vlm_logits_and_loss_match_repro(family_pairs, arch, spec):
    """prefill at S = 16 (paligemma: after 8 projected patch embeddings, at
    the top-level site ``patch_proj``), two decode steps at batch 2 (the
    MoE layers at capacity 1: a token is dropped where both pick one
    expert) and ``loss_fn`` (paligemma: text positions only), within
    ``LOGIT_ATOL``. Its own generator, as ``test_prefill_logits_match_repro``,
    for the header's caveat: of the draws ``default_rng(20..31)``, three put
    one activation of one of the nine cases within a float32 ulp of a
    rounding boundary (maverick's decode under ``approx_cuda``, kimi-k2's
    loss under ``int8``, paligemma's prefill under ``approx_cuda``); XLA and
    torch round it 7e-7 apart, one int8 code moves, and the numbers differ
    by up to 0.1. Fed the same float input, each block agrees to 1e-6
    (``tests/test_torch_moe.py``); every other draw agrees to 2e-6. Draws
    20–31 are held block by block in ``tests/test_torch_blockwise_lm.py``."""
    rng = np.random.default_rng(22)
    jcfg, jparams, cfg, params = family_pairs(arch)
    jcfg = dataclasses.replace(jcfg, dot_plan=MODEL_SPECS[spec])
    cfg = dataclasses.replace(cfg, dot_plan=spec)
    jb, tb = jreg.build_bundle(jcfg), reg.build_bundle(cfg)
    toks = rng.integers(0, cfg.vocab, (2, 16))
    labels = rng.integers(0, cfg.vocab, (2, 16))
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
              "labels": jnp.asarray(labels, jnp.int32)}
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if cfg.family == "vlm":
        pe = rng.normal(size=(2, cfg.n_patches, cfg.d_model)).astype(np.float32)
        jbatch["patch_embeds"], batch["patch_embeds"] = jnp.asarray(pe), \
            torch.from_numpy(pe)
    got = tb.prefill(params, batch)
    assert got.shape == (2, 1, cfg.vocab) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(jb.prefill(jparams, jbatch)),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(float(tb.loss_fn(params, batch)),
                               float(jb.loss_fn(jparams, jbatch)),
                               atol=LOGIT_ATOL, rtol=0)
    jstate, state = jb.init_decode_state(2, 8), tb.init_decode_state(2, 8)
    step = jax.jit(jb.decode_step)
    for i in range(2):
        want, jstate = step(jparams, jstate, {
            "token": jnp.asarray(toks[:, i:i + 1], jnp.int32),
            "cache_len": jnp.asarray(i, jnp.int32)})
        got, state = tb.decode_step(params, state, {
            "token": torch.from_numpy(toks[:, i:i + 1]), "cache_len": i})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "llama4-maverick-400b-a17b"])
def test_moe_layer_plan_and_units_match_repro(arch):
    """Which layers are MoE, the unit period (the lcm of the interleave and
    the local:global period) and the layers' modules."""
    jcfg = reduced(arch, n_layers=4)
    cfg = port_cfg(jcfg)
    assert lm.layer_plan(cfg) == jlm.layer_plan(jcfg)
    assert lm.unit_period(cfg) == jlm.unit_period(jcfg)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    assert [layer.moe is not None for layer in params.layers] == \
        [d["moe"] for d in jlm.layer_plan(jcfg)]
    assert all((layer.ffn is None) == (layer.moe is not None)
               for layer in params.layers)
    n = sum(t.numel() for name, t in params.named_parameters()
            if not name.endswith(("ln", "ln_f")))
    assert n == cfg.param_count()
    assert lm.unit_period(dataclasses.replace(
        cfg, moe_interleave=2, local_global_ratio=2)) == 6


def test_vlm_patch_proj_site_and_param_count(family_pairs):
    """``patch_proj`` resolves at the top level, outside any layer scope,
    and ``param_count`` leaves it out, as ``repro``'s does."""
    jcfg, jparams, cfg, params = family_pairs("paligemma-3b")
    assert params.patch_proj.w.shape == (cfg.d_model, cfg.d_model)
    plan = tplan.SubstratePlan("exact", (("patch_proj", "int8"),))
    jplan_ = jplan.SubstratePlan("exact", (("patch_proj", "int8"),))
    toks = np.random.default_rng(21).integers(0, cfg.vocab, (1, 4))
    pe = np.random.default_rng(22).normal(size=(1, 8, cfg.d_model)).astype(np.float32)
    got = lm.prefill(dataclasses.replace(cfg, dot_plan=plan), params,
                     torch.from_numpy(toks), torch.from_numpy(pe))
    want = jlm.prefill(dataclasses.replace(jcfg, dot_plan=jplan_), jparams,
                       jnp.asarray(toks, jnp.int32), jnp.asarray(pe))
    exact = lm.prefill(cfg, params, torch.from_numpy(toks), torch.from_numpy(pe))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    assert float((got - exact).abs().max()) > 1e-4  # the rule reached the site
    n = sum(t.numel() for name, t in params.named_parameters()
            if not name.endswith(("ln", "ln_f")))
    assert n == cfg.param_count() + cfg.d_model ** 2
