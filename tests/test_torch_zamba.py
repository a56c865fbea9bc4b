"""The port's Zamba2 hybrid against ``repro``'s, on the CPU.

zamba2-1.2b at ``tests/test_models_smoke.py``'s reduced sizes (6 mamba
layers, the shared block after layers 2 and 5, d_model 64, 4 heads,
ssm_state 8, vocab 512) at float32; ``repro`` draws the parameters from
``PRNGKey(0)`` and ``models.convert.zamba_params_from_jax`` carries them
across. ``_causal_conv1d``, ``mamba_scan`` and ``mamba_block`` fed the same
float input and state agree to ``BLOCK_ATOL`` = 1e-5; prefill logits,
``loss_fn`` and three decode steps (logits, every mamba state and the
shared block's caches) agree to ``LOGIT_ATOL`` under ``exact``, ``int8``
and the approximate substrate, with ``dense`` bit-identical at
``in_proj``'s ragged width. The shared block's two places hold caches of
their own. Reference results come once per module and ``repro`` runs under
``jax.jit`` (``tests/test_torch_xlstm.py``'s helpers). The whole-model
case takes a fixed draw, ``DRAW``, for the caveat of
``tests/test_torch_models.py``'s header (why: at ``DRAW``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro.models import zamba as jz
from repro.nn import plan as jplan
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import common as cm
from repro_torch.models import convert
from repro_torch.models import registry as reg
from repro_torch.models import zamba
from repro_torch.nn import plan as tplan
from repro_torch.nn import substrate as tsub
from tests.test_models_smoke import reduced
from tests.test_torch_models import MODEL_SPECS, port_cfg
from tests.test_torch_xlstm import one_torch_thread  # noqa: F401 (the module's fixture)
from tests.test_torch_xlstm import (BLOCK_ATOL, PROMPTS, check_run, engine_outputs,
                                    pair, round_trip, run_once)

ARCH = "zamba2-1.2b"
#: the whole-model case's draw. Of ``default_rng(0..5)``, draws 0, 1 and 5
#: under the approximate substrate and 1 and 3 under ``int8`` put a
#: ``dense`` activation within a float32 ulp of an int8 rounding boundary
#: (the logits then differ by up to 0.15); 2 and 4 hold under all three.
#: ``tests/test_torch_blockwise.py`` holds the others block by block.
DRAW = 2


def _close(got, want, atol=BLOCK_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,carried", [(7, False), (7, True), (1, True)])
def test_causal_conv1d_matches_repro(dtype, s, carried):
    """The depthwise conv in the input's dtype, with and without the
    carried state; the new state is the last W - 1 inputs. bfloat16 runs
    each product and sum rounded to bfloat16 in both (equal within one
    bfloat16 ulp of the outputs' scale)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, s, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if carried else None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    wy, ws = jz._causal_conv1d(jnp.asarray(x, jd), jnp.asarray(w, jd),
                               None if st is None else jnp.asarray(st))
    gy, gs = zamba._causal_conv1d(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                                  None if st is None else torch.from_numpy(st))
    assert gy.dtype == td and gs.dtype == td and gs.shape == (2, 3, 12)
    atol = BLOCK_ATOL if dtype == "float32" else 0.05
    _close(gy.float().numpy(), np.asarray(wy, np.float32), atol)
    _close(gs.float().numpy(), np.asarray(ws, np.float32), atol)


@pytest.mark.parametrize("s,chunk,carried", [(24, 8, True), (16, 16, False),
                                             (1, 1, True)])
def test_mamba_scan_matches_repro(s, chunk, carried):
    """Three chunks with a carried state, one chunk, a decode step."""
    rng = np.random.default_rng(1)
    b, h, dh, n = 2, 4, 8, 6
    xh = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    dt = rng.uniform(0.01, 1.5, (b, s, h)).astype(np.float32)
    bm, cm_ = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    a = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    st = (rng.normal(size=(b, h, dh, n)) if carried
          else np.zeros((b, h, dh, n))).astype(np.float32)
    wy, ws = jz.mamba_scan(*map(jnp.asarray, (xh, dt, bm, cm_, a, st)), chunk=chunk)
    gy, gs = zamba.mamba_scan(*map(torch.from_numpy, (xh, dt, bm, cm_, a, st)),
                              chunk=chunk)
    assert gy.shape == (b, s, h, dh) and gs.shape == (b, h, dh, n)
    _close(gy.numpy(), wy)
    _close(gs.numpy(), ws)


@pytest.mark.parametrize("s,carried", [(16, False), (16, True), (1, True)])
def test_mamba_block_matches_repro(s, carried):
    """Layer 1 fed the same float input, SSM and conv state."""
    jcfg, jparams, cfg, params = pair(ARCH)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    h, n, di = cfg.n_heads, cfg.ssm_state, 2 * cfg.d_model
    st = rng.normal(size=(2, h, di // h, n)).astype(np.float32) if carried else None
    cst = rng.normal(size=(2, cfg.conv_width - 1, di)).astype(np.float32) \
        if carried else None
    wy, (ws, wc) = jz.mamba_block(jcfg, jparams["mamba"][1], jnp.asarray(x),
                                  None if st is None else jnp.asarray(st),
                                  None if cst is None else jnp.asarray(cst))
    gy, (gs, gc) = zamba.mamba_block(cfg, params.mamba[1], torch.from_numpy(x),
                                     None if st is None else torch.from_numpy(st),
                                     None if cst is None else torch.from_numpy(cst))
    _close(gy.numpy(), wy)
    _close(gs.numpy(), ws)
    _close(gc.numpy(), wc)


def test_softplus_is_jaxs_past_the_threshold():
    """dt's softplus is ``jax.nn.softplus`` (logaddexp(x, 0)) on both
    sides of 20, where ``F.softplus`` would return x itself."""
    x = np.linspace(-30.0, 40.0, 2001).astype(np.float32)
    got = zamba._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=2e-7, atol=0)


@pytest.mark.parametrize("spec", ["int8", "approx_cuda:proposed@8"])
def test_dense_at_in_proj_is_bit_identical(spec):
    """``in_proj``'s width 2·d_inner + 2·n + H (276 here; 8352 at the
    published widths, no multiple of a 128-wide tile): the same bits as
    ``repro``'s given the same float input."""
    jcfg, _, cfg, _ = pair(ARCH)
    n = 2 * 2 * cfg.d_model + 2 * cfg.ssm_state + cfg.n_heads
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    w = (rng.normal(size=(cfg.d_model, n)) / 8).astype(np.float32)
    with jplan.site_scope("layer.3", "mamba"):
        want = np.asarray(jcm.dense(dataclasses.replace(jcfg, dot_plan=MODEL_SPECS[spec]),
                                    jnp.asarray(x), jnp.asarray(w), site="in_proj"))
    with tplan.site_scope("layer.3", "mamba"):
        got = cm.dense(dataclasses.replace(cfg, dot_plan=spec), torch.from_numpy(x),
                       torch.from_numpy(w), site="in_proj")
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", sorted(MODEL_SPECS))
def test_prefill_decode_and_loss_match_repro(spec):
    """Prefill at S = 16, ``loss_fn`` and three decode steps from zero
    states (the shared block's caches written at positions 0..2), every
    logit and state tensor within ``LOGIT_ATOL``."""
    check_run(run_once(ARCH, spec, DRAW), pair(ARCH)[2].vocab)


def test_shared_positions_and_sites_match_repro(monkeypatch):
    """The shared block after layers 2 and 5 (``repro``'s
    ``_shared_positions``), its contractions at ``shared.attn.w*`` and
    ``shared.ffn.w*`` with no layer index, each mamba layer's at
    ``layer.<i>.mamba.{in,out}_proj``; a rule on ``shared.*`` reaches them."""
    jcfg, _, cfg, params = pair(ARCH)
    assert zamba._shared_positions(cfg) == jz._shared_positions(jcfg) == [2, 5]
    seen = []
    orig = tsub.ExactSubstrate.dot_general

    def spy(self, x, w, spec=None):
        seen.append(spec.site)
        return orig(self, x, w, spec)

    monkeypatch.setattr(tsub.ExactSubstrate, "dot_general", spy)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, 4)))
    exact = zamba.prefill(cfg, params, toks)
    shared = [f"shared.attn.w{c}" for c in "qkvo"] + [f"shared.ffn.w{c}" for c in "gio"]
    want = []
    for i in range(cfg.n_layers):
        want += [f"layer.{i}.mamba.in_proj", f"layer.{i}.mamba.out_proj"]
        if i in (2, 5):
            want += shared
    assert seen == want
    monkeypatch.undo()
    got = zamba.prefill(dataclasses.replace(cfg, dot_plan=tplan.SubstratePlan(
        "exact", (("shared.*", "int8"),))), params, toks)
    assert float((got - exact).abs().max()) > 1e-4


def test_decode_state_per_place_and_in_place():
    """``init_decode_state``: ``repro``'s shapes and dtypes (conv state in
    the config's dtype), one (K, V) per place of the shared block, never
    aliased; a decode step writes both places' caches in place at
    ``cache_len`` and returns new mamba states."""
    jcfg = reduced(ARCH)
    cfg = port_cfg(jcfg)
    jst = jz.init_decode_state(jcfg, 3, 10)
    st = reg.build_bundle(cfg).init_decode_state(3, 10)
    flat = lambda t: [a for part in ("mamba", "shared_kv") for pair_ in t[part]
                      for a in pair_]
    assert [(tuple(a.shape), str(a.dtype).split(".")[-1]) for a in flat(st)] == \
        [(a.shape, np.dtype(a.dtype).name) for a in flat(jst)]
    assert st["mamba"][0][1].dtype == torch.bfloat16
    ptrs = [t.data_ptr() for kv in st["shared_kv"] for t in kv]
    assert len(st["shared_kv"]) == 2 and len(set(ptrs)) == 4
    _, _, cfg32, params = pair(ARCH)
    st = zamba.init_decode_state(cfg32, 1, 4)
    before = [t.data_ptr() for kv in st["shared_kv"] for t in kv]
    _, out = zamba.decode_step(cfg32, params, st, torch.tensor([[3]]), 2)
    assert [t.data_ptr() for kv in out["shared_kv"] for t in kv] == before
    for k, v in out["shared_kv"]:
        assert k[:, 2].abs().sum() > 0 and v[:, 2].abs().sum() > 0
        assert k[:, :2].abs().sum() == 0 and k[:, 3:].abs().sum() == 0
    assert not torch.equal(out["shared_kv"][0][0], out["shared_kv"][1][0])
    assert out["mamba"] is not st["mamba"] and out["mamba"][0][0].abs().sum() > 0


def test_engine_greedy_outputs_match_repro():
    """Batch 2 with refills (a refilled slot keeps the previous occupant's
    mamba state and attends over its cache prefix, in both engines): every
    greedy token equal."""
    want, got, teng = engine_outputs(ARCH)
    assert got == want and all(len(o) == 4 for o in got)
    assert teng.metrics.requests_served == len(PROMPTS)


def test_convert_round_trips():
    params = round_trip(ARCH)
    cfg = port_cfg(reduced(ARCH))
    assert len(params.mamba) == cfg.n_layers
    m = params.mamba[0]
    assert m.in_proj.w.shape == (64, 2 * 128 + 2 * 8 + 4)
    assert m.conv_w.dtype == torch.bfloat16 and m.a_log.dtype == torch.float32
    names = dict(params.named_parameters())
    assert {"shared.attn.wq.w", "shared.ffn.wo.w", "mamba.5.out_proj.w",
            "embed.emb"} <= set(names)
    with pytest.raises(ValueError, match="holds 6 mamba layers"):
        convert.zamba_params_from_jax(dataclasses.replace(cfg, n_layers=4),
                                      jax.tree.map(np.asarray, pair(ARCH)[1]))


def test_init_params_match_repros_tree():
    """The port's init draws ``repro``'s tree: names, shapes, dtypes."""
    jcfg = reduced(ARCH)
    cfg = port_cfg(jcfg)
    want = jax.eval_shape(lambda: jz.init_params(jcfg, jax.random.PRNGKey(0)))
    got = convert.zamba_params_to_jax(cfg, zamba.init_params(
        cfg, torch.Generator().manual_seed(0)))
    assert jax.tree.map(lambda a: (a.shape, np.dtype(a.dtype).name), got) == \
        jax.tree.map(lambda a: (a.shape, np.dtype(a.dtype).name), want)


def test_launchers(tmp_path):
    """``launch/serve.py`` serves zamba on the CPU (6 layers at d_model 32:
    the shared block after the sixth, at the published period), and
    ``launch/train.py`` trains it (AdamW, as ``repro``'s launcher)."""
    small = ["--device", "cpu", "--n-layers", "6", "--d-model", "32",
             "--d-ff", "64", "--vocab", "64", "--n-heads", "2", "--n-kv-heads", "2"]
    out = launch_serve.main(["--arch", ARCH, "--requests", "3", "--max-tokens",
                             "3", *small])
    assert [len(r.output) for r in out] == [3, 3, 3]
    loop, _ = launch_train.main(["--arch", ARCH, "--steps", "2", "--batch", "2",
                                 "--seq-len", "16", "--ckpt-dir", str(tmp_path), *small])
    assert len(loop.metrics["losses"]) == 2 and all(
        np.isfinite(loop.metrics["losses"]))
