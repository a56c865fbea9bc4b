"""Draws 20–31 of ``tests/test_torch_models.py``'s
``test_moe_and_vlm_logits_and_loss_match_repro`` (which takes draw 22),
block by block (ROADMAP.md, fault F1): the lm families' MoE configs and
the vlm, with the harness and tolerances of
``tests/test_torch_blockwise.py``. A file of their own, so that the test
runner can place them beside the other walks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import common as jcm
from repro.models import lm as jlm
from repro.nn import plan as jplan
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.nn import plan as tplan
from tests.test_torch_blockwise import (Walk, _head_and_loss, _positions,
                                        _step_positions)
from tests.test_torch_models import FAMILY_ARCHS, MODEL_SPECS
from tests.test_torch_models import pair as lm_pair
from tests.test_torch_xlstm import once, one_torch_thread  # noqa: F401


def _layer_tree(jcfg, jparams, i):
    """``repro``'s params of LM layer ``i`` (unit stacks or tail)."""
    period = jlm.unit_period(jcfg)
    n_units = jcfg.n_layers // period
    if i < n_units * period:
        return jax.tree.map(lambda a: a[i // period], jparams["unit"][i % period])
    return jparams["tail"][i - n_units * period]


def lm_walk(arch, spec, draw):
    """The draw's prefill (2 × 16 tokens; paligemma after 8 patches), loss
    and two decode steps, block by block."""
    jcfg, jparams, cfg, params = once(("lm_pair", arch), lambda: lm_pair(arch))
    w = Walk(("lm", arch, spec), jcfg, cfg, spec)
    jcfg, cfg = w.jcfg, w.cfg
    rng = np.random.default_rng(draw)
    toks = rng.integers(0, cfg.vocab, (2, 16))
    labels = rng.integers(0, cfg.vocab, (2, 16))
    jemb = jparams["embed"]
    x = np.asarray(jcm.embed(jcfg, jemb, jnp.asarray(toks, jnp.int32)))
    npatch = 0
    if cfg.family == "vlm":
        pe = rng.normal(size=(2, cfg.n_patches, cfg.d_model)).astype(np.float32)
        pw = jparams["patch_proj"]["w"]
        pe = w.block("patch_proj",
                     lambda w_, p_: jcm.dense(jcfg, p_, w_, site="patch_proj"), pw,
                     lambda p_: cm.dense(cfg, p_, params.patch_proj.w, site="patch_proj"),
                     pe)
        x = np.concatenate([pe, x], axis=1)
        npatch = cfg.n_patches
    plan = jlm.layer_plan(jcfg)
    jpos, tpos = _positions(x.shape[1])
    for i in range(cfg.n_layers):
        p_i, layer = _layer_tree(jcfg, jparams, i), params.layers[i]

        def jf(p_, xx, i=i):
            with jplan.site_scope(f"layer.{i}"):
                return jlm._apply_layer(jcfg, p_, xx, plan[i], jpos)[0]

        def tf(xx, layer=layer, i=i):
            with tplan.site_scope(f"layer.{i}"):
                return lm._apply_layer(cfg, layer, xx, tpos)[0]
        x = w.block(f"layer.{i}", jf, p_i, tf, x)
    _head_and_loss(w, jcfg, jemb, cfg, params.embed, x[:, npatch:] if npatch else x,
                   labels)
    jn, tn = _step_positions()
    kv = [(np.zeros((2, 8, cfg.n_kv_heads, cfg.dh), np.float32),) * 2
          for _ in range(cfg.n_layers)]
    for step in range(2):
        x = np.asarray(jcm.embed(jcfg, jemb, jnp.asarray(toks[:, step:step + 1],
                                                          jnp.int32)))
        for i in range(cfg.n_layers):
            p_i, layer = _layer_tree(jcfg, jparams, i), params.layers[i]

            def jf(p_, xx, k, v, n, i=i):
                with jplan.site_scope(f"layer.{i}"):
                    return jlm._apply_layer(jcfg, p_, xx, plan[i], jn(n),
                                            kv_cache=(k, v), cache_len=n)

            def tf(xx, k, v, n, layer=layer, i=i):
                with tplan.site_scope(f"layer.{i}"):
                    return lm._apply_layer(cfg, layer, xx, tn(n), kv_cache=(k, v),
                                           cache_len=n)
            x, kv[i] = w.block(f"step.layer.{i}", jf, p_i, tf, x, *kv[i], step)
        w.block("logits", lambda e, xx: jcm.lm_logits(jcfg, e, xx), jemb,
                lambda xx: cm.lm_logits(cfg, params.embed, xx), x)
    return w


@pytest.mark.parametrize("draw", range(20, 32))
@pytest.mark.parametrize("spec", sorted(MODEL_SPECS))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_moe_and_vlm_draws_block_by_block(arch, spec, draw):
    """Draws 20–31 of ``test_moe_and_vlm_logits_and_loss_match_repro``
    (which takes draw 22)."""
    lm_walk(arch, spec, draw)
