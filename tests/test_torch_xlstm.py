"""The port's xLSTM family against ``repro``'s, on the CPU.

xlstm-125m at ``tests/test_models_smoke.py``'s reduced sizes (2 layers:
mLSTM then sLSTM, d_model 64, 2 heads, vocab 512) at float32; ``repro``
draws the parameters from ``PRNGKey(0)`` and
``models.convert.xlstm_params_from_jax`` carries them across. Each block
(``mlstm_scan``, ``mlstm_block``, ``slstm_block``) fed the same float input
and state agrees to ``BLOCK_ATOL`` = 1e-5; the sLSTM's ``associative_scan``
equals ``jax.lax.associative_scan`` bit for bit, as ``repro`` runs it
outside ``jit`` (XLA's compiled scan fuses the multiply-add and differs by
an ulp). Prefill logits, ``loss_fn`` and three decode steps (logits and
every state tensor) agree to ``LOGIT_ATOL`` under ``exact``, ``int8`` and
``approx_lut:proposed@8`` (``PORT_SPEC``), and ``dense`` is bit-identical
at the family's narrow gate sites under ``int8`` and ``approx_cuda`` (its
plain versions here, the integers of ``repro``'s ``approx_lut``). Each
reference result is computed once per module (:func:`run_once`);
``repro``'s prefill, loss and decode step run under ``jax.jit``, as its
engine runs the step. The helpers here serve ``tests/test_torch_zamba.py``
too. No draw is chosen: every case uses ``default_rng(0)``, and xlstm's
whole model holds at each of ``default_rng(0..5)`` under every substrate.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro.models import registry as jreg
from repro.models import xlstm as jx
from repro.models import zamba as jz
from repro.nn import plan as jplan
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import common as cm
from repro_torch.models import convert
from repro_torch.models import registry as reg
from repro_torch.models import xlstm
from repro_torch.nn import plan as tplan
from repro_torch.nn import substrate as tsub
from repro_torch.serving import Request, ServingEngine
from tests.test_models_smoke import reduced
from tests.test_torch_models import LOGIT_ATOL, MODEL_SPECS, port_cfg

ARCH = "xlstm-125m"
BLOCK_ATOL = 1e-5
PROMPTS = [[5, 9, 11], [1, 2], [7, 3, 3, 8], [60, 2, 17]]
#: per family: repro's model module, the port's convert functions
FAMILIES = {"xlstm": (jx, convert.xlstm_params_from_jax, convert.xlstm_params_to_jax),
            "zamba": (jz, convert.zamba_params_from_jax, convert.zamba_params_to_jax)}

#: the substrate the port's whole-model and block runs take for a key of
#: ``MODEL_SPECS``: ``approx_lut:proposed@8`` (``repro``'s spec too) computes
#: the integers of ``approx_cuda``'s plain versions (both held to
#: ``repro``'s: ``tests/test_torch_substrate.py``,
#: ``test_torch_models.py::test_dense_matches_repro``) about 12x faster on
#: the CPU; the ``dense`` and engine cases run ``approx_cuda`` itself
PORT_SPEC = {"approx_cuda:proposed@8": "approx_lut:proposed@8"}

_ONCE: dict = {}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module: its cases run many small ops, and
    the test runner's workers share the machine's cores, which intra-op
    threads would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def once(key, fn):
    """``fn()`` computed once per ``key`` in this process."""
    if key not in _ONCE:
        _ONCE[key] = fn()
    return _ONCE[key]


def pair(arch):
    """(repro config, repro params, port config, port params), float32,
    once per arch."""
    def make():
        jcfg = reduced(arch, dtype=jnp.float32)
        jm, from_jax, _ = FAMILIES[jcfg.family]
        jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
        cfg = port_cfg(jcfg)
        return jcfg, jparams, cfg, from_jax(cfg, jax.tree.map(np.asarray, jparams))
    return once(("pair", arch), make)


def _leaves(tree):
    """Copies of the state's tensors in ``jax.tree_util`` order, as float32
    numpy (the port writes its KV caches in place)."""
    return [np.array(t.float() if torch.is_tensor(t) else t, np.float32)
            for _, t in tree_leaves(tree)]


def run_once(arch, spec, seed=0, s=16, steps=3):
    """``repro``'s and the port's prefill, loss and ``steps`` decode steps
    (logits and every state tensor) under ``spec`` (the port runs
    ``PORT_SPEC.get(spec, spec)``, ``repro`` ``MODEL_SPECS[spec]``) at
    batch 2 and ``s`` tokens, once per
    arguments: ``{"repro": ..., "port": ...}`` of numpy results."""
    def make():
        jcfg, jparams, cfg, params = pair(arch)
        jb = jreg.build_bundle(dataclasses.replace(jcfg, dot_plan=MODEL_SPECS[spec]))
        tb = reg.build_bundle(dataclasses.replace(
            cfg, dot_plan=PORT_SPEC.get(spec, spec)))
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, cfg.vocab, (2, s))
        labels = rng.integers(0, cfg.vocab, (2, s))
        jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
                  "labels": jnp.asarray(labels, jnp.int32)}
        batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
        out = {"repro": {"prefill": np.asarray(jax.jit(jb.prefill)(jparams, jbatch)),
                         "loss": float(jax.jit(jb.loss_fn)(jparams, jbatch)),
                         "steps": []},
               "port": {"prefill": tb.prefill(params, batch).numpy(),
                        "loss": float(tb.loss_fn(params, batch)), "steps": []}}
        jstate, state = jb.init_decode_state(2, 8), tb.init_decode_state(2, 8)
        step = jax.jit(jb.decode_step)
        for i in range(steps):
            want, jstate = step(jparams, jstate, {
                "token": jnp.asarray(toks[:, i:i + 1], jnp.int32),
                "cache_len": jnp.asarray(i, jnp.int32)})
            got, state = tb.decode_step(params, state, {
                "token": torch.from_numpy(toks[:, i:i + 1]), "cache_len": i})
            out["repro"]["steps"].append((np.asarray(want), _leaves(jstate)))
            out["port"]["steps"].append((got.numpy(), _leaves(state)))
        return out
    return once(("run", arch, spec, seed, s, steps), make)


def check_run(res, vocab):
    """Every result of :func:`run_once` within ``LOGIT_ATOL``."""
    want, got = res["repro"], res["port"]
    assert got["prefill"].shape == (2, 1, vocab) and np.isfinite(got["prefill"]).all()
    np.testing.assert_allclose(got["prefill"], want["prefill"], atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(got["loss"], want["loss"], atol=LOGIT_ATOL, rtol=0)
    for (gl, gs), (wl, ws) in zip(got["steps"], want["steps"]):
        assert gl.shape == (2, 1, vocab)
        np.testing.assert_allclose(gl, wl, atol=LOGIT_ATOL, rtol=0)
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=LOGIT_ATOL, rtol=0)


def engine_outputs(arch, seed=1):
    """Greedy outputs of ``repro``'s engine (``approx_lut:proposed@8``) and
    the port's (``approx_cuda:proposed@8``, its plain versions) on the same
    parameters (d_model 32, vocab 64) and prompts, batch 2 with refills."""
    jcfg = reduced(arch, d_model=32, d_ff=64, vocab=64, dtype=jnp.float32)
    jb = jreg.build_bundle(jcfg)
    jparams = jb.init_params(jax.random.PRNGKey(seed))
    cfg = port_cfg(jcfg)
    tparams = FAMILIES[cfg.family][1](cfg, jax.tree.map(np.asarray, jparams))
    jeng = JServingEngine(jb, jparams, batch_size=2, max_len=32,
                          substrate="approx_lut:proposed@8")
    teng = ServingEngine(reg.build_bundle(cfg), tparams, batch_size=2, max_len=32,
                         substrate="approx_cuda:proposed@8", device="cpu")
    want = jeng.generate([JRequest(prompt=p, max_tokens=4) for p in PROMPTS])
    got = teng.generate([Request(prompt=p, max_tokens=4) for p in PROMPTS])
    return [r.output for r in want], [r.output for r in got], teng


def round_trip(arch):
    """``repro``'s bf16 tree → the port → ``repro``'s tree, and the port's
    own init → tree → the port: every leaf bit for bit, the same paths."""
    jcfg = reduced(arch)
    jm, from_jax, to_jax = FAMILIES[jcfg.family]
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    cfg = port_cfg(jcfg)
    params = from_jax(cfg, tree)
    back = to_jax(cfg, params)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    own = reg.build_bundle(cfg).init_params(torch.Generator().manual_seed(3))
    again = from_jax(cfg, to_jax(cfg, own))
    for (name, a), (_, b) in zip(own.named_parameters(), again.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    layout = reg.build_bundle(cfg).layout
    flat = convert.named_leaves(own)
    assert set(layout.from_tree(layout.to_tree(flat))) == set(flat)
    return params


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk,carried", [(24, 8, True), (16, 16, False),
                                             (1, 1, True)])
def test_mlstm_scan_matches_repro(s, chunk, carried):
    """Three chunks with a carried state, one chunk, a decode step."""
    rng = np.random.default_rng(0)
    b, h, dh = 2, 2, 8
    q, k, v = (rng.normal(size=(b, s, h, dh)).astype(np.float32) for _ in range(3))
    ig, fg = (rng.uniform(0.05, 0.99, (b, s, h)).astype(np.float32) for _ in range(2))
    st = (rng.normal(size=(b, h, dh, dh)) if carried
          else np.zeros((b, h, dh, dh))).astype(np.float32)
    wy, ws = jx.mlstm_scan(*map(jnp.asarray, (q, k, v, ig, fg, st)), chunk=chunk)
    gy, gs = xlstm.mlstm_scan(*map(torch.from_numpy, (q, k, v, ig, fg, st)),
                              chunk=chunk)
    assert gy.shape == (b, s, h, dh) and gy.dtype == torch.float32
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=BLOCK_ATOL, rtol=0)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=BLOCK_ATOL, rtol=0)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 16])
def test_associative_scan_is_jaxs_recursion(n):
    """Bit for bit ``jax.lax.associative_scan`` as ``repro`` runs it
    eagerly (odd and even lengths); within an ulp of the compiled one."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (n, 2, 7)).astype(np.float32)
    b = rng.normal(size=(n, 2, 7)).astype(np.float32)
    ja, jb = jax.lax.associative_scan(jx_compose, (jnp.asarray(a), jnp.asarray(b)))
    ta, tb = xlstm.associative_scan(xlstm._compose,
                                    (torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    _, jitted = jax.jit(lambda x, y: jax.lax.associative_scan(jx_compose, (x, y)))(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jitted), atol=1e-6, rtol=0)


def jx_compose(e1, e2):
    """``repro``'s sLSTM combine (a closure inside ``slstm_block``)."""
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("kind", ["m", "s"])
@pytest.mark.parametrize("s,carried", [(16, False), (16, True), (1, True)])
def test_blocks_match_repro(kind, s, carried):
    """``mlstm_block`` (layer 0) and ``slstm_block`` (layer 1) fed the same
    float input and state: output and new state within ``BLOCK_ATOL``."""
    jcfg, jparams, cfg, params = pair(ARCH)
    i = 0 if kind == "m" else 1
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    d, h = cfg.d_model, cfg.n_heads
    shape = (2, h, d // h, d // h) if kind == "m" else (2, d)
    st = rng.normal(size=shape).astype(np.float32) if carried else None
    jblock, tblock = ((jx.mlstm_block, xlstm.mlstm_block) if kind == "m"
                      else (jx.slstm_block, xlstm.slstm_block))
    wy, ws = jblock(jcfg, jparams["layers"][i], jnp.asarray(x),
                    None if st is None else jnp.asarray(st))
    gy, gs = tblock(cfg, params.layers[i], torch.from_numpy(x),
                    None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=BLOCK_ATOL, rtol=0)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=BLOCK_ATOL, rtol=0)


@pytest.mark.parametrize("spec", ["int8", "approx_cuda:proposed@8"])
@pytest.mark.parametrize("site,n", [("layer.0.mlstm.wi", 2), ("layer.1.slstm.wz", 64)])
def test_dense_at_the_family_sites_is_bit_identical(spec, site, n):
    """``dense`` at the mLSTM gate (N = n_heads) and an sLSTM projection,
    the same float input: the same bits as ``repro``'s."""
    jcfg, _, cfg, _ = pair(ARCH)
    jcfg = dataclasses.replace(jcfg, dot_plan=MODEL_SPECS[spec])
    cfg = dataclasses.replace(cfg, dot_plan=spec)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = (rng.normal(size=(64, n)) / 8).astype(np.float32)
    scope = site.rsplit(".", 1)
    with jplan.site_scope(*scope[0].rsplit(".", 1)):
        want = np.asarray(jcm.dense(jcfg, jnp.asarray(x), jnp.asarray(w),
                                    site=scope[1]))
    with tplan.site_scope(*scope[0].rsplit(".", 1)):
        got = cm.dense(cfg, torch.from_numpy(x), torch.from_numpy(w), site=scope[1])
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", sorted(MODEL_SPECS))
def test_prefill_decode_and_loss_match_repro(spec):
    """Prefill at S = 16, ``loss_fn`` and three decode steps from zero
    states, logits and every state tensor, within ``LOGIT_ATOL``."""
    check_run(run_once(ARCH, spec), pair(ARCH)[2].vocab)


def test_sites_match_repro(monkeypatch):
    """Every contraction of a prefill at ``repro``'s site:
    ``layer.0.mlstm.{wq,wk,wv,wi,wf,wo_gate,wo}``,
    ``layer.1.slstm.{wz,wi,wf,wo_gate,wo}``; a rule on ``*.slstm.*`` reaches
    them."""
    _, _, cfg, params = pair(ARCH)
    seen = []
    orig = tsub.ExactSubstrate.dot_general

    def spy(self, x, w, spec=None):
        seen.append(spec.site)
        return orig(self, x, w, spec)

    monkeypatch.setattr(tsub.ExactSubstrate, "dot_general", spy)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, 4)))
    exact = xlstm.prefill(cfg, params, toks)
    assert seen == [f"layer.0.mlstm.{w}" for w in xlstm.MLSTM_LEAVES[:5]] + \
        ["layer.0.mlstm.wo_gate", "layer.0.mlstm.wo"] + \
        [f"layer.1.slstm.{w}" for w in ("wz", "wi", "wf", "wo_gate", "wo")]
    monkeypatch.undo()
    planned = dataclasses.replace(cfg, dot_plan=tplan.SubstratePlan(
        "exact", (("*.slstm.*", "int8"),)))
    got = xlstm.prefill(planned, params, toks)
    assert float((got - exact).abs().max()) > 1e-4


def test_engine_greedy_outputs_match_repro():
    """Batch 2 with refills: a refilled slot starts from the previous
    occupant's recurrent state in both engines, and every greedy token is
    equal."""
    want, got, teng = engine_outputs(ARCH)
    assert got == want and all(len(o) == 4 for o in got)
    assert teng.metrics.requests_served == len(PROMPTS)


def test_convert_round_trips():
    params = round_trip(ARCH)
    assert [type(layer) for layer in params.layers] == [xlstm.MLSTM, xlstm.SLSTM]
    assert params.layers[0].wi.w.shape == (64, 2)
    assert params.layers[0].ln.dtype == torch.float32
    with pytest.raises(ValueError, match="holds 2 layers"):
        convert.xlstm_params_from_jax(
            dataclasses.replace(pair(ARCH)[2], n_layers=3),
            jax.tree.map(np.asarray, pair(ARCH)[1]))


def test_init_and_decode_state_shapes_match_repro():
    """The port's init draws ``repro``'s tree (names, shapes, dtypes) at
    the config's bf16, and its decode state ``repro``'s per-layer states."""
    jcfg = reduced(ARCH)
    cfg = port_cfg(jcfg)
    want = jax.eval_shape(lambda: jx.init_params(jcfg, jax.random.PRNGKey(0)))
    got = convert.xlstm_params_to_jax(cfg, xlstm.init_params(
        cfg, torch.Generator().manual_seed(0)))
    assert jax.tree.map(lambda a: (a.shape, np.dtype(a.dtype).name), got) == \
        jax.tree.map(lambda a: (a.shape, np.dtype(a.dtype).name), want)
    jst = jx.init_decode_state(jcfg, 3)
    st = reg.build_bundle(cfg).init_decode_state(3, 99)
    assert [tuple(t.shape) for t in st] == [a.shape for a in jst]
    assert all(t.dtype == torch.float32 and not t.any() for t in st)


def test_launchers(tmp_path):
    """``launch/serve.py`` serves the family on the CPU, and
    ``launch/train.py`` trains it (AdamW, as ``repro``'s launcher)."""
    small = ["--device", "cpu", "--n-layers", "2", "--d-model", "32",
             "--vocab", "64", "--n-heads", "2", "--n-kv-heads", "2"]
    out = launch_serve.main(["--arch", ARCH, "--requests", "3", "--max-tokens",
                             "3", *small])
    assert [len(r.output) for r in out] == [3, 3, 3]
    loop, _ = launch_train.main(["--arch", ARCH, "--steps", "2", "--batch", "2",
                                 "--seq-len", "16", "--ckpt-dir", str(tmp_path), *small])
    assert len(loop.metrics["losses"]) == 2 and all(
        np.isfinite(loop.metrics["losses"]))
