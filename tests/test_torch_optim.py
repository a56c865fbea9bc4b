"""The port's optimizers, schedule, clipping and synthetic LM stream against
``repro``'s, on the CPU.

The same numpy inputs go to both. Tolerances:

* AdamW / Adafactor updates: the same elementwise rule in float32, but XLA
  fuses and may contract a multiply-add, and ``b ** step`` / ``rsqrt`` are
  not bit-identical between the two; held to rtol 1e-6 on float32 leaves
  (a few ulps), and to one bf16 ulp (rtol 2^-7) on bf16 leaves, where a
  float32 ulp apart can round to neighbouring bf16 values.
* The schedule and the global norm: float32 rounding (rtol 1e-6).
* ``SyntheticLMStream``: bit for bit (the same numpy generator calls).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLMStream as JStream
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import warmup_cosine as jwarmup
from repro.optim import grad_utils as jgu
from repro_torch.data import SyntheticLMStream
from repro_torch.optim import adafactor, adamw, warmup_cosine
from repro_torch.optim.grad_utils import clip_by_global_norm, global_norm

RNG = np.random.default_rng(5)


def _params(dtype=np.float32):
    return {"w": RNG.normal(size=(6, 5)).astype(dtype),
            "stack": RNG.normal(size=(2, 4, 3)).astype(dtype),
            "b": RNG.normal(size=(5,)).astype(dtype)}


def _t(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.int16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(x):
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _run(jopt, topt, params, n_steps, lr=1e-2):
    """``n_steps`` updates on the same parameters and gradients in both."""
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(n_steps):
        grads = {k: RNG.normal(size=v.shape).astype(v.dtype) for k, v in params.items()}
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp,
                             jnp.float32(lr))
        tp2, ts2 = topt.update({k: _t(v) for k, v in grads.items()}, ts, tp, lr)
        assert tp2 is tp and ts2 is ts  # in place
    return jp, js, tp, ts


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_matches_repro(dtype, wd):
    jp, js, tp, ts = _run(jadamw(weight_decay=wd), adamw(weight_decay=wd),
                          _params(dtype), n_steps=3)
    rtol = 1e-6 if dtype == np.float32 else 2.0 ** -7
    assert int(ts["step"]) == int(js["step"]) == 3
    for k in jp:
        assert tp[k].dtype == (torch.float32 if dtype == np.float32 else torch.bfloat16)
        np.testing.assert_allclose(_f32(tp[k]), _f32(jp[k]), rtol=rtol, atol=1e-7)
        for s in ("m", "v"):
            assert ts["mv"][k][s].dtype == torch.float32
            np.testing.assert_allclose(_f32(ts["mv"][k][s]), _f32(js["mv"][k][s]),
                                       rtol=1e-6, atol=1e-9)


def test_adafactor_matches_repro():
    """Factored moments for 2-D and 3-D leaves, a full one for 1-D."""
    jp, js, tp, ts = _run(jadafactor(), adafactor(), _params(), n_steps=3)
    assert set(ts["mv"]["w"]) == {"vr", "vc"} and set(ts["mv"]["b"]) == {"v"}
    assert ts["mv"]["stack"]["vc"].shape == (2, 3)
    for k in jp:
        np.testing.assert_allclose(_f32(tp[k]), _f32(jp[k]), rtol=1e-6, atol=1e-7)
        for s in ts["mv"][k]:
            np.testing.assert_allclose(_f32(ts["mv"][k][s]), _f32(js["mv"][k][s]),
                                       rtol=1e-6, atol=1e-12)


def test_schedule_matches_repro():
    for args in ((3e-4, 5, 50), (1.0, 0, 10), (2e-3, 10, 10), (0.1, 1, 3)):
        j, t = jwarmup(*args), warmup_cosine(*args)
        for step in range(0, args[2] + 3):
            assert t(step) == pytest.approx(float(j(step)), rel=1e-6, abs=1e-12)
            assert isinstance(t(step), float)


def test_clip_by_global_norm():
    """tests/test_infra.py's case, then against repro on a mixed tree."""
    clipped, norm = clip_by_global_norm({"a": torch.full((10,), 10.0)}, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(1000.0), rel=1e-5)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, rel=1e-4)
    tree = {"a": RNG.normal(size=(7, 3)).astype(np.float32),
            "b": RNG.normal(size=(4,)).astype(jnp.bfloat16)}
    for max_norm in (0.5, 1e6):
        jc, jn = jgu.clip_by_global_norm({k: jnp.asarray(v) for k, v in tree.items()},
                                         max_norm)
        tc, tn = clip_by_global_norm({k: _t(v) for k, v in tree.items()}, max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        assert float(global_norm({k: _t(v) for k, v in tree.items()})) == \
            pytest.approx(float(jgu.global_norm(tree)), rel=1e-6)
        for k in tree:
            assert tc[k].dtype == _t(tree[k]).dtype
            np.testing.assert_allclose(_f32(tc[k]), _f32(jc[k]), rtol=2.0 ** -7)


# ---------------------------------------------------------------------------
# SyntheticLMStream (tests/test_infra.py's data cases, and bit for bit)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(vocab=97, batch=4, seq_len=16, seed=3),
                                dict(vocab=64, batch=8, seq_len=8, seed=0,
                                     host_id=1, n_hosts=2),
                                dict(vocab=256000, batch=2, seq_len=5, seed=9)])
def test_stream_batches_equal_repro(kw):
    j, t = JStream(**kw), SyntheticLMStream(**kw)
    assert (t._a, t._c) == (j._a, j._c)
    j.seek(2)
    t.seek(2)
    for _ in range(3):
        a, b = j.next(), t.next()
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_data_deterministic_and_seekable():
    s1 = SyntheticLMStream(vocab=97, batch=4, seq_len=16, seed=3)
    batches = [s1.next() for _ in range(5)]
    s2 = SyntheticLMStream(vocab=97, batch=4, seq_len=16, seed=3)
    s2.seek(3)
    np.testing.assert_array_equal(s2.next()["tokens"], batches[3]["tokens"])


def test_data_host_sharding_disjoint():
    a = SyntheticLMStream(vocab=97, batch=8, seq_len=8, seed=0, host_id=0, n_hosts=2)
    b = SyntheticLMStream(vocab=97, batch=8, seq_len=8, seed=0, host_id=1, n_hosts=2)
    assert a.next()["tokens"].shape == (4, 8)
    assert not np.array_equal(a._batch_at(0)["tokens"], b._batch_at(0)["tokens"])


def test_data_labels_shifted():
    s = SyntheticLMStream(vocab=50, batch=2, seq_len=12, seed=1)
    b = s.next()
    structured = (b["tokens"].astype(np.int64) * s._a + s._c) % 50
    assert (structured == b["labels"]).mean() > 0.4


def test_data_prefetch():
    s = SyntheticLMStream(vocab=31, batch=2, seq_len=8, seed=5)
    ref = [s._batch_at(i)["tokens"] for i in range(3)]
    s.seek(0)
    s.start_prefetch()
    try:
        got = [s.next_prefetched()["tokens"] for _ in range(3)]
    finally:
        s.stop()
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
