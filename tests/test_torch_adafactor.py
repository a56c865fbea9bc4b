"""The port's Adafactor on an LM's per-layer parameters against ``repro``'s
``adafactor`` on its stacked tree, on the CPU.

llama4-maverick cut to d_model 16 (MoE every second layer, 4 experts, a
shared expert: unit period 2), at 2, 4 and 6 layers (1, 2 and 3 stacked
units) and at 5 (2 units and a tail layer). The port draws the parameters
and ``repro`` takes them as its tree (``layout.to_tree``); each step's
gradients are one seeded numpy tree given to both, the port's through
``layout.from_tree``; ``repro``'s update runs under ``jax.jit`` in
float32.
Cauchy gradients, so that the RMS clip binds on stacked leaves (checked).
After 3 steps every parameter and every statistic of the state in
``repro``'s tree (``layout.state_to_tree``) is held to ``repro``'s.

Tolerances: float32 parameters within rtol 1e-6 plus ``CLIP_RTOL`` = 3e-5
of the leaf's largest move over the 3 steps. The statistics and the update
are ``repro``'s operations in float32, which XLA and torch round a few ulps
apart; the clip scales a whole leaf's step by its RMS, whose float32 mean
of squares XLA computes 1.5e-5 (relative) away from float64's on these
Cauchy tails, torch within 2e-7 (measured on a (2, 4, 16, 32) draw; here
the stacked leaf's mean square is also summed layer by layer). Statistics
within rtol 1e-6 and an absolute 1e-12 near zero. In bfloat16 (``cfg.dtype``
of the weights; norm scales and the router stay float32) a float32 update a
few ulps apart can round to the neighbouring bfloat16 value: each element
is allowed one bfloat16 ulp, and the count of such flips is reported and
held under 1% of the bfloat16 elements. ``repro``'s update runs eagerly
there, as op by op as the port's: compiled, XLA fuses the bfloat16 update
``g * rsqrt(denom).astype(bf16)`` without its rounding to bfloat16, which
moves a parameter by several ulps (measured: 14 of 1024 elements of one
step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as jadafactor
from repro_torch.checkpoint.ckpt import tree_leaves, tree_map
from repro_torch.models import convert, lm
from repro_torch.models import registry as reg
from repro_torch.optim import adafactor
from tests.test_torch_xlstm import one_torch_thread  # noqa: F401  (autouse)

ARCH = "llama4-maverick-400b-a17b"
SIZE = dict(d_model=16, d_ff=32, n_heads=2, n_kv_heads=1, head_dim=0, vocab=64,
            n_experts=4)
LR = 1e-2
CLIP_RTOL = 3e-5


def _t(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _unclipped_rms(g: np.ndarray) -> float:
    """RMS of ``repro``'s first update of a leaf of two or more dimensions
    (zero state), before the clip."""
    beta = 1.0 - 2.0 ** -0.8
    sq = np.square(g.astype(np.float64))
    vr, vc = (1 - beta) * sq.mean(-1), (1 - beta) * sq.mean(-2)
    denom = vr[..., None] * vc[..., None, :] / vr.mean(-1)[..., None, None]
    return float(np.sqrt(np.mean(sq / denom)))


def _run(n_layers, dtype, steps=3, jit=True):
    """``steps`` updates in both packages from the port's seeded init (its
    tree given to ``repro``): (config, layout, the first gradients, the
    initial tree, repro's params and state, the port's)."""
    cfg = reg.get_config(ARCH, n_layers=n_layers, dtype=dtype, **SIZE)
    layout = convert.lm_layout(cfg)
    tp = convert.named_leaves(lm.init_params(cfg, torch.Generator().manual_seed(0)))
    jp = tree_map(layout.to_tree(tp), convert._numpy)
    jopt, topt = jadafactor(), adafactor(layout)
    jparams = jax.tree.map(jnp.asarray, jp)
    js, ts = jopt.init(jparams), topt.init(tp)
    jupdate = jax.jit(jopt.update) if jit else jopt.update
    rng = np.random.default_rng(3)
    first = None
    for _ in range(steps):
        grads = jax.tree.map(lambda a: rng.standard_cauchy(a.shape).astype(a.dtype), jp)
        first = first or grads
        jparams, js = jupdate(jax.tree.map(jnp.asarray, grads), js, jparams,
                              jnp.float32(LR))
        tp2, ts2 = topt.update(layout.from_tree(tree_map(grads, _t)), ts, tp, LR)
        assert tp2 is tp and ts2 is ts  # in place
    return cfg, layout, first, jp, jparams, js, tp, ts


def _check_params(jp0, jparams, layout, tp, bf16_ulps=False):
    """Every parameter against ``repro``'s (see the module's tolerances);
    bfloat16 leaves to one ulp where asked → (one-ulp flips, bf16
    elements)."""
    flips = n_bf16 = 0
    for (path, want), (_, got), (_, p0) in zip(
            tree_leaves(jax.tree.map(np.asarray, jparams)),
            tree_leaves(layout.to_tree(tp)), tree_leaves(jp0)):
        if bf16_ulps and got.dtype == torch.bfloat16:
            w = want.view(np.int16).astype(np.int32)
            ulps = np.abs(w - got.contiguous().view(torch.int16).numpy())
            assert ulps.max() <= 1, (path, int(ulps.max()))
            flips += int((ulps == 1).sum())
            n_bf16 += w.size
            continue
        move = np.abs(_f32(want) - _f32(p0)).max()
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6,
                                   atol=CLIP_RTOL * move + 1e-7, err_msg=str(path))
    return flips, n_bf16


@pytest.mark.parametrize("n_layers", [2, 4, 6, 5],
                         ids=["1-unit", "2-units", "3-units", "2-units+tail"])
def test_adafactor_on_the_stacked_tree_matches_repro(n_layers):
    jcfg, layout, grads, jp0, jparams, js, tp, ts = _run(n_layers, torch.float32)
    n_units = n_layers // 2
    # the state is keyed by repro's leaves: stacked units, tail layers, embed
    assert convert.keyed_by_path(ts)
    ln = ts["mv"][("unit", 0, "attn", "ln")]
    assert set(ln) == {"vr", "vc"} and ln["vr"].shape == (n_units,) \
        and ln["vc"].shape == (jcfg.d_model,)  # a stacked scale, factored
    wi = ts["mv"][("unit", 1, "moe", "wi")]
    assert wi["vr"].shape == (n_units, 4, jcfg.d_model)  # the expert stacks
    assert set(ts["mv"][("embed", "ln_f")]) == {"v"}
    if n_layers % 2:
        assert set(ts["mv"][("tail", 0, "attn", "ln")]) == {"v"}  # per tensor
    # the clip binds on stacked leaves at the first step
    assert max(_unclipped_rms(g) for _, g in tree_leaves(grads["unit"])) > 1.0
    _check_params(jp0, jparams, layout, tp)
    want_state, got_state = jax.tree.map(np.asarray, js), layout.state_to_tree(ts)
    assert int(got_state["step"]) == int(want_state["step"]) == 3
    wl, gl = list(tree_leaves(want_state["mv"])), list(tree_leaves(got_state["mv"]))
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, want), (_, got) in zip(wl, gl):
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_allclose(_f32(got), want, rtol=1e-6, atol=1e-12,
                                   err_msg=str(path))


def test_adafactor_on_the_stacked_tree_in_bfloat16():
    """2 units and a tail layer in bfloat16, ``repro`` eager: one bfloat16
    ulp allowed per element, the flips counted."""
    _, layout, _, jp0, jparams, js, tp, ts = _run(5, torch.bfloat16, jit=False)
    flips, n_bf16 = _check_params(jp0, jparams, layout, tp, bf16_ulps=True)
    assert n_bf16 > 0 and flips <= n_bf16 // 100, (flips, n_bf16)
    print(f"bf16 one-ulp flips: {flips} of {n_bf16}")
    for (path, want), (_, got) in zip(tree_leaves(jax.tree.map(np.asarray, js["mv"])),
                                      tree_leaves(layout.state_to_tree(ts)["mv"])):
        np.testing.assert_allclose(_f32(got), want, rtol=1e-6, atol=1e-12,
                                   err_msg=str(path))


def test_state_round_trips_through_repros_tree():
    """``state_to_tree`` / ``state_from_tree(by_path=True)``: the same
    tensors under the same keys; ``groups`` lists each stacked leaf's layers
    in stack order."""
    _, layout, _, _, _, _, tp, ts = _run(5, torch.float32, steps=1)
    back = layout.state_from_tree(layout.state_to_tree(ts), by_path=True)
    assert set(back["mv"]) == set(ts["mv"])
    for k, d in ts["mv"].items():
        assert set(back["mv"][k]) == set(d)
        assert all(back["mv"][k][s] is t for s, t in d.items())
    groups = layout.groups(tp)
    assert groups[("unit", 1, "moe", "wi")] == (["layers.1.moe.wi", "layers.3.moe.wi"],
                                                True)
    assert groups[("tail", 0, "attn", "wq", "w")] == (["layers.4.attn.wq.w"], False)
    assert groups[("embed", "emb")] == (["embed.emb"], False)
