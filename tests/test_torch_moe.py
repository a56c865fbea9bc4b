"""The port's MoE layer against ``repro``'s, on the CPU.

The routing first: ``_top_k`` against ``jax.lax.top_k`` on the same gates
(ties included: the lower expert index first), then ``_dispatch_local``'s
routing on the same tokens and router (``keep``, ``slot`` and the
dispatched slots equal, ``topw`` to 1e-6: XLA and torch round the float32
router product and softmax a few ulps apart), ``_combine_local`` on the
same expert outputs, and ``moe_block`` (the experts, the shared expert under
the substrate) within ``LOGIT_ATOL``. Cases: top-1 and top-2, a forced
capacity overflow, tied gates, with and without a shared expert; at float32
with ``tests/test_models_smoke.py``'s reduced widths (d 64, f 128, E 4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro.nn import plan as jplan
from repro_torch.models import common as cm
from repro_torch.models import convert
from repro_torch.nn import plan as tplan
from tests.test_models_smoke import reduced
from tests.test_torch_models import LOGIT_ATOL, port_cfg

D, F, E = 64, 128, 4


def _cfgs(top_k=1, shared=True, capacity_factor=1.25, n_experts=E,
          plan="exact"):
    """(repro config, port config): llama4-maverick reduced, float32."""
    jcfg = reduced("llama4-maverick-400b-a17b", dtype=jnp.float32, top_k=top_k,
                   shared_expert=shared, capacity_factor=capacity_factor,
                   n_experts=n_experts, dot_plan=plan)
    return jcfg, port_cfg(jcfg)


def _moe_tree(rng, n_experts=E, shared=True, router=None):
    """A random MoE parameter dict in repro's layout (numpy, float32)."""
    t = {"router": (rng.normal(size=(D, n_experts)) / 8).astype(np.float32)
         if router is None else router,
         "wi": (rng.normal(size=(n_experts, D, F)) / 8).astype(np.float32),
         "wg": (rng.normal(size=(n_experts, D, F)) / 8).astype(np.float32),
         "wo": (rng.normal(size=(n_experts, F, D)) / 11).astype(np.float32),
         "ln": (1 + rng.normal(size=(D,)) / 10).astype(np.float32)}
    if shared:
        t["shared"] = {k: {"w": (rng.normal(size=s) / 8).astype(np.float32)}
                       for k, s in (("wi", (D, F)), ("wg", (D, F)), ("wo", (F, D)))}
        t["shared"]["ln"] = np.ones((D,), np.float32)
    return t


def _both(tree):
    return jax.tree.map(jnp.asarray, tree), convert._moe(tree, "cpu")


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_keeps_the_lower_index_among_ties(k):
    """Gates with exact ties (equal rows, equal entries) and without: the
    same values and indices as ``jax.lax.top_k``."""
    rng = np.random.default_rng(k)
    g = rng.random((6, 8)).astype(np.float32)
    g[0] = 0.125                      # every expert tied
    g[1, [1, 4, 6]] = g[1].max() + 1  # a three-way tie at the top
    g[2, [0, 7]] = 0.99               # a tie across the ends
    want_v, want_i = jax.lax.top_k(jnp.asarray(g), k)
    got_v, got_i = cm._top_k(torch.from_numpy(g), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


ROUTING = ["top1", "top2", "overflow", "tied", "tied_columns", "decode"]


def _routing_case(name):
    """(config kwargs, tokens (t, d), router) of one routing case."""
    rng = np.random.default_rng(ROUTING.index(name))
    xn = rng.normal(size=(48, D)).astype(np.float32)
    router = (rng.normal(size=(D, E)) / 8).astype(np.float32)
    if name == "top1":
        return dict(top_k=1), xn, router
    if name == "top2":
        return dict(top_k=2), xn, router
    if name == "overflow":  # cap = ceil(48 * 2 * 0.25 / 4) = 6 of 24 a side
        return dict(top_k=2, capacity_factor=0.25), xn, router
    if name == "tied":      # every gate 1/E: all tokens pick experts 0, 1
        return dict(top_k=2), xn, np.zeros((D, E), np.float32)
    if name == "tied_columns":  # experts 1 and 3 identical
        router[:, 3] = router[:, 1]
        return dict(top_k=2), xn, router
    if name == "decode":    # t = 8 tokens, 16 experts: cap 1, drops on repeats
        xn = rng.normal(size=(8, D)).astype(np.float32)
        return (dict(top_k=1, n_experts=16), xn,
                (rng.normal(size=(D, 16)) / 2).astype(np.float32))
    raise KeyError(name)


@pytest.mark.parametrize("name", ROUTING)
def test_dispatch_routing_matches_repro(name):
    kw, xn, router = _routing_case(name)
    jcfg, cfg = _cfgs(**kw)
    jbuf, (jslot, jtopw, jkeep, jcap) = jcm._dispatch_local(
        jcfg, jnp.asarray(xn), jnp.asarray(router))
    buf, (slot, topw, keep, cap) = cm._dispatch_local(
        cfg, torch.from_numpy(xn), torch.from_numpy(router))
    assert cap == jcap
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_allclose(topw.numpy(), np.asarray(jtopw), rtol=0, atol=1e-6)
    e = cfg.n_experts
    if name == "overflow":
        assert (~keep).sum() > 0 and (slot[~keep] == e * cap).all()
    if name == "tied":  # the lower indices win every tie, first tokens kept
        assert (slot[keep] // cap).unique().tolist() == [0, 1]
        assert keep.reshape(48, 2)[:cap].all() and not keep.reshape(48, 2)[cap:].any()
    if name == "decode":
        assert cap == 1
        picked = (slot[keep] // cap).tolist()
        assert len(picked) == len(set(picked)) and keep.sum() < 8


@pytest.mark.parametrize("name", ["top2", "overflow"])
def test_combine_matches_repro(name):
    kw, xn, router = _routing_case(name)
    jcfg, cfg = _cfgs(**kw)
    _, jinfo = jcm._dispatch_local(jcfg, jnp.asarray(xn), jnp.asarray(router))
    _, info = cm._dispatch_local(cfg, torch.from_numpy(xn), torch.from_numpy(router))
    out = np.random.default_rng(5).normal(
        size=(cfg.n_experts, info[3], D)).astype(np.float32)
    want = np.asarray(jcm._combine_local(jnp.asarray(out), jinfo, 48))
    got = cm._combine_local(torch.from_numpy(out), info, 48).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_expert_ffn_matches_repro():
    tree = _moe_tree(np.random.default_rng(2))
    jp, p = _both(tree)
    buf = np.random.default_rng(3).normal(size=(E, 5, D)).astype(np.float32)
    want = np.asarray(jcm._expert_ffn(jp, jnp.asarray(buf)))
    got = cm._expert_ffn(p, torch.from_numpy(buf)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top_k,shared,capacity_factor,plan", [
    (1, True, 1.25, "exact"), (2, True, 1.25, "exact"),
    (1, False, 1.25, "exact"), (2, False, 0.25, "exact"),
    (1, True, 1.25, "int8"), (2, True, 1.25, "approx_cuda:proposed@8"),
], ids=["top1-shared", "top2-shared", "top1", "top2-overflow",
        "top1-shared-int8", "top2-shared-approx"])
def test_moe_block_matches_repro(top_k, shared, capacity_factor, plan):
    """``moe_block`` at (2, 24, 64) under ``layer.1``: the shared expert
    runs on the substrate at ``layer.1.moe.shared.ffn.w*`` (``approx_cuda``
    here is its kernels' plain versions: the integers of ``repro``'s
    ``approx_lut``)."""
    jplan_spec = plan.replace("approx_cuda", "approx_lut")
    jcfg, cfg = _cfgs(top_k=top_k, shared=shared,
                      capacity_factor=capacity_factor, plan=jplan_spec)
    cfg = dataclasses.replace(cfg, dot_plan=plan)
    rng = np.random.default_rng(top_k * 10 + shared)
    jp, p = _both(_moe_tree(rng, shared=shared))
    x = rng.normal(size=(2, 24, D)).astype(np.float32)
    with jplan.site_scope("layer.1"):
        want = np.asarray(jcm.moe_block(jcfg, jp, jnp.asarray(x)))
    with tplan.site_scope("layer.1"):
        got = cm.moe_block(cfg, p, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)


def test_shared_expert_sites(monkeypatch):
    """The shared expert's contractions resolve at
    ``layer.<i>.moe.shared.ffn.w{g,i,o}``, the routed experts at none."""
    from repro_torch.nn import substrate as tsub

    seen = []
    orig = tsub.ExactSubstrate.dot_general

    def spy(self, x, w, spec=None):
        seen.append(spec.site)
        return orig(self, x, w, spec)

    monkeypatch.setattr(tsub.ExactSubstrate, "dot_general", spy)
    _, cfg = _cfgs()
    _, p = _both(_moe_tree(np.random.default_rng(0)))
    with tplan.site_scope("layer.3"):
        cm.moe_block(cfg, p, torch.zeros((1, 2, D)))
    assert sorted(seen) == [f"layer.3.moe.shared.ffn.{w}" for w in ("wg", "wi", "wo")]


def test_init_moe_shapes_dtypes_and_seed():
    _, cfg = _cfgs(top_k=2)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    a = cm.init_moe(torch.Generator().manual_seed(4), cfg)
    b = cm.init_moe(torch.Generator().manual_seed(4), cfg)
    assert a.router.dtype == torch.float32 and a.router.shape == (D, E)
    assert a.wi.shape == a.wg.shape == (E, D, F) and a.wo.shape == (E, F, D)
    assert a.wi.dtype == torch.bfloat16 and a.shared.wi.w.shape == (D, F)
    for (n, ta), (_, tb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(ta, tb), n
    # drawn per expert at std 1/sqrt(d) (wo: 1/sqrt(f)), not all equal
    assert 0.8 < float(a.wi.float().std() * D ** 0.5) < 1.2
    assert 0.8 < float(a.wo.float().std() * F ** 0.5) < 1.2
    assert not torch.equal(a.wi[0], a.wi[1])
