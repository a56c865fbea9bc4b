"""The port's examples (``examples/torch_*.py``) against ``repro``'s, on the
CPU.

Each example is loaded by path and run with ``device="cpu"`` (its kernels'
plain versions). Bars:

* ``torch_edge_detection``: every edge map equals ``repro``'s bit for bit
  (``approx_lut`` on the ``repro`` side: the same integers as the
  bit-exact products), its ASCII renders are ``repro``'s, and every PSNR
  equals ``repro``'s within ``PSNR_ATOL_DB``;
* ``torch_quickstart``: its printout is ``repro``'s line for line, the
  energy figures equal as floats, and under a plan JSON ``repro`` wrote the
  planned maps equal ``repro``'s;
* ``torch_serve_edge``: the images are ``repro``'s, every served map equals
  ``repro``'s direct pipeline bit for bit, at 1 and 2 workers, and the
  metrics dump carries ``repro``'s metric families; ``--sharded`` raises;
* ``torch_serve_lm``: on ``repro``'s ``PRNGKey(0)`` parameters (carried
  across by ``models/convert.py``), at float32, every greedy request
  equals ``repro``'s engine token for token; the sampled ones stay in the
  vocabulary and at their length;
* ``torch_train_lm``: from the same initial parameters its losses track
  ``repro``'s ``TrainLoop`` within ``TRAIN_LOSS_RTOL``, and a second run
  on the same checkpoint directory resumes from the checkpoint and repeats
  the first run's last losses exactly.
"""
import contextlib
import copy
import importlib.util
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import image_batch as jimage_batch
from repro.data import mixed_shape_batch as jmixed_shape_batch
from repro.data import photo_like as jphoto_like
from repro.data import test_image as jtest_image
from repro.nn import conv as jconv
from repro.nn import plan as jplan
from repro.nn import substrate as jsub
from repro_torch.models import convert
from repro_torch.models import registry as reg

ROOT = Path(__file__).resolve().parents[1]
#: relative tolerance of the training losses: both packages train in
#: bfloat16, whose matmuls XLA and torch round in different orders; over
#: the 12 steps they differ by up to 1.7e-4 relative
TRAIN_LOSS_RTOL = 1e-3
#: PSNRs: both packages take the mean squared error in float32, summed in
#: their own orders (torch's and XLA's reductions): they differ by an ulp
#: or a few (9.5e-7 dB at 10 dB for one 96 × 96 map, 1.4e-5 dB over
#: 6 × 64 × 64); the maps they are taken from are equal bit for bit
PSNR_ATOL_DB = 1e-4
_ONCE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module: the test runner's workers share the
    machine's cores, which intra-op threads would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def once(key, fn):
    """``fn()`` computed once per ``key`` in this process."""
    if key not in _ONCE:
        _ONCE[key] = fn()
    return _ONCE[key]


def load(rel: str):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quiet(fn, *args, **kw):
    """``fn(*args, **kw)`` and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


# ---------------------------------------------------------------------------
# torch_edge_detection
# ---------------------------------------------------------------------------


def _edge_example():
    return once("edge", lambda: quiet(load("examples/torch_edge_detection.py")
                                      .main, device="cpu"))


def test_edge_detection_maps_equal_repro():
    got, printed = _edge_example()
    img = jtest_image(96, 96)
    exact = np.asarray(jconv.edge_detect(img, "exact"))
    approx = np.asarray(jconv.edge_detect(img, "proposed"))
    np.testing.assert_array_equal(got["exact"], exact)
    np.testing.assert_array_equal(got["approx"], approx)
    assert abs(got["psnr_approx_db"] - jconv.psnr(exact, approx)) <= PSNR_ATOL_DB
    imgs = jimage_batch(8, 96, 96)
    np.testing.assert_array_equal(
        got["batched"], np.asarray(jconv.edge_detect_batched(imgs, "approx_lut")))
    px = np.asarray(img, np.int32) >> 1
    np.testing.assert_array_equal(got["fused"], np.asarray(jconv.conv2d_int(
        px, jconv.LAPLACIAN, jsub.get_substrate("approx_lut").scalar)))
    ref_mod = load("examples/edge_detection.py")
    for m in (img, exact, approx):
        assert ref_mod.ascii_render(m) in printed
    for line in ("batched edge detection (8 images) == single-image loop: OK",
                 "approx_pallas (= approx_cuda) substrate output == core model: OK",
                 "fused_conv kernel output (cpu) == core model: OK"):
        assert line in printed


def test_edge_detection_psnr_table_equals_repro():
    got, _ = _edge_example()
    photo = jphoto_like(128, 128)[None]
    ref = np.asarray(jconv.edge_detect_batched(photo, "exact"))[0]
    for name, db in got["psnr_db"].items():
        out = np.asarray(jconv.edge_detect_batched(
            photo, jsub.get_substrate("approx_lut", mult_name=name)))[0]
        assert abs(db - jconv.psnr(ref, out)) <= PSNR_ATOL_DB, name
    assert list(got["psnr_db"]) == list(load(
        "examples/torch_edge_detection.py").PSNR_DESIGNS)


# ---------------------------------------------------------------------------
# torch_quickstart
# ---------------------------------------------------------------------------


def test_quickstart_prints_what_repro_prints():
    got, printed = quiet(load("examples/torch_quickstart.py").main, device="cpu")
    _, want = quiet(load("examples/quickstart.py").main)
    assert printed.splitlines() == want.splitlines()
    from repro.core import energy as jenergy

    assert got["savings"] == jenergy.savings_vs("proposed", "design_du2022")
    assert got["f00"] == 192 and got["product"] == -4416


def test_quickstart_loads_a_plan_repro_wrote(tmp_path):
    plan = jplan.SubstratePlan(default="approx_lut:proposed@8",
                               rules=(("conv.edge.ring", "approx_lut:csp_axc1@6"),))
    path = tmp_path / "plan.json"
    path.write_text(plan.to_json())
    drv = load("examples/torch_quickstart.py")
    got, printed = quiet(drv.main, plan_path=str(path), device="cpu")
    img = jtest_image(96, 96)[None]
    want = np.asarray(jconv.edge_detect_planned(img, plan))
    np.testing.assert_array_equal(got["planned"], want)
    ref = np.asarray(jconv.edge_detect_batched(img, "exact"))
    assert abs(got["planned_psnr_db"] - jconv.psnr(ref, want)) <= PSNR_ATOL_DB
    assert "  conv.edge.ring -> approx_lut:csp_axc1@6" in printed


# ---------------------------------------------------------------------------
# torch_serve_edge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv,repro_spec", [
    ([], "approx_lut"),
    (["--substrate", "approx_lut:design_du2022", "--workers", "2"],
     "approx_lut:design_du2022"),
], ids=["approx_cuda", "lut_2_workers"])
def test_serve_edge_maps_equal_repro(argv, repro_spec, tmp_path):
    metrics = tmp_path / "serve.json"
    trace = tmp_path / "trace.json"
    got, printed = quiet(load("examples/torch_serve_edge.py").main,
                         ["--smoke", "--device", "cpu", "--metrics-out",
                          str(metrics), "--trace-out", str(trace), *argv])
    want_imgs = jmixed_shape_batch(6, shapes=((16, 16), (24, 31), (32, 32)))
    assert len(got["images"]) == len(want_imgs)
    for im, want_im, out in zip(got["images"], want_imgs, got["outputs"]):
        np.testing.assert_array_equal(im, want_im)
        np.testing.assert_array_equal(out, np.asarray(
            jconv.edge_detect_batched(want_im[None], repro_spec))[0])
    assert "served == direct edge_detect_batched (bit-identical) across 3 " \
        "shapes: OK" in printed
    assert got["stats"]["requests_served"] == 6
    assert json.loads(metrics.read_text()) and json.loads(trace.read_text())


def test_serve_edge_metrics_dump_has_repros_families(tmp_path, monkeypatch):
    got_path, want_path = tmp_path / "port.json", tmp_path / "repro.json"
    quiet(load("examples/torch_serve_edge.py").main,
          ["--smoke", "--device", "cpu", "--substrate", "approx_lut",
           "--metrics-out", str(got_path)])
    monkeypatch.setattr("sys.argv", ["serve_edge.py", "--smoke", "--substrate",
                                     "approx_lut", "--metrics-out", str(want_path)])
    quiet(load("examples/serve_edge.py").main)
    got, want = json.loads(got_path.read_text()), json.loads(want_path.read_text())
    assert set(got) == set(want)
    assert set(got["metrics"]) == set(want["metrics"])
    assert got["substrate_meter"].keys() == want["substrate_meter"].keys()


def test_serve_edge_sharded_raises():
    """Named when ``--sharded`` raised; at a world of one it now serves
    sharded and checks every map against the direct pipeline itself."""
    out, printed = quiet(load("examples/torch_serve_edge.py").main,
                         ["--sharded", "--smoke", "--device", "cpu"])
    assert "sharded over 1 rank(s), backend gloo" in printed
    assert len(out["outputs"]) == len(out["images"]) == 6


def test_serve_edge_sharded_on_two_ranks(tmp_path):
    """Two gloo ranks: rank 0 serves the smoke stream (its own check of
    every map against the direct pipeline passes), rank 1 follows every
    batch and prints nothing."""
    from repro_torch.nn import conv
    from tests import test_torch_ranks as tr

    ranks = tr.spawn("driver_program", 2, tmp_path, "serve_edge", str(tmp_path))
    lead, follow = ranks
    assert follow["outputs"] is None and follow["followed"] >= 1
    assert follow["printed"] == "" and "sharded over 2 rank(s)" in lead["printed"]
    for im, got in zip(lead["images"], lead["outputs"]):
        want = conv.edge_detect_batched(torch.from_numpy(im[None]),
                                        "approx_cuda")[0].numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# torch_serve_lm
# ---------------------------------------------------------------------------


def test_serve_lm_greedy_requests_equal_repro():
    """At float32 (the example's config otherwise): in bfloat16 the two
    packages round the activations of a float matmul differently, and a
    greedy argmax a few tokens in can take another branch."""
    from repro.models import registry as jreg
    from repro.serving import ServingEngine as JServingEngine
    from repro.serving.engine import Request as JRequest

    drv = load("examples/torch_serve_lm.py")
    jcfg = jreg.get_config("minitron-8b", **drv.OVERRIDES, dtype=jnp.float32)
    jb = jreg._BUILDERS[jcfg.family](jcfg)
    jparams = jb.init_params(jax.random.PRNGKey(0))
    cfg = reg.get_config("minitron-8b", **drv.OVERRIDES, dtype=torch.float32)
    params = convert.lm_params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    got, printed = quiet(drv.main, device="cpu", params=params,
                         dtype=torch.float32)
    reqs = drv.requests()
    want = JServingEngine(jb, jparams, batch_size=4, max_len=96).generate(
        [JRequest(prompt=r.prompt, max_tokens=r.max_tokens,
                  temperature=r.temperature) for r in reqs])
    assert [r.prompt for r in got] == [r.prompt for r in want]
    greedy = [i for i, r in enumerate(reqs) if r.temperature == 0.0]
    assert greedy == [1, 3, 5, 7]
    assert [got[i].output for i in greedy] == [want[i].output for i in greedy]
    for r in got:
        assert len(r.output) == 12 and all(0 <= t < 1024 for t in r.output)
    assert "served 8 requests, 96 tokens (continuous batching, 4 slots)" in printed


# ---------------------------------------------------------------------------
# torch_train_lm
# ---------------------------------------------------------------------------

TRAIN_STEPS = 12  # a checkpoint at step 10, two steps after it


def _repro_losses(tmp_path):
    """``repro``'s example loop (its reduced config) for TRAIN_STEPS, and
    its initial parameters."""
    from repro.data import SyntheticLMStream as JStream
    from repro.models import registry as jreg
    from repro.optim import adamw as jadamw
    from repro.optim import warmup_cosine as jwarmup
    from repro.train import TrainLoop as JTrainLoop
    from repro.train import TrainLoopConfig as JTrainLoopConfig

    drv = load("examples/torch_train_lm.py")
    jcfg = jreg.get_config("minitron-8b", dot_mode="exact", **drv.REDUCED)
    jb = jreg._BUILDERS[jcfg.family](jcfg)
    steps = TRAIN_STEPS
    loop = JTrainLoop(
        jb.loss_fn, jadamw(),
        JTrainLoopConfig(total_steps=steps, ckpt_every=max(10, steps // 5),
                         ckpt_dir=str(tmp_path / "repro_ckpt"), lr=3e-3),
        lr_schedule=jwarmup(3e-3, steps // 10, steps))
    stream = JStream(vocab=jcfg.vocab, batch=8, seq_len=64, seed=0)
    init = jb.init_params(jax.random.PRNGKey(0))
    params, opt_state, start = loop.init_or_restore(lambda: init)
    loop.run(params, opt_state, stream, start)
    # copies: the port trains its parameters in place, and a tensor made
    # from a numpy view would write into repro's buffers
    return loop.metrics["losses"], jax.tree.map(np.array, init)


def test_train_lm_tracks_repro_and_resumes(tmp_path):
    drv = load("examples/torch_train_lm.py")
    want, tree = _repro_losses(tmp_path)

    def init(bundle, device):  # a fresh copy a run: training is in place
        return convert.lm_params_from_jax(bundle.cfg, copy.deepcopy(tree)).to(device)

    argv = ["--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt")]
    loop, printed = quiet(drv.main, argv, init_params=init, steps=TRAIN_STEPS)
    got = loop.metrics["losses"]
    assert len(got) == len(want) == TRAIN_STEPS
    np.testing.assert_allclose(got, want, rtol=TRAIN_LOSS_RTOL)
    assert got[-1] < got[0]
    assert "from step 0" in printed
    resumed, printed = quiet(drv.main, argv, init_params=init, steps=TRAIN_STEPS)
    assert resumed.metrics["resumed_from"] == 10
    assert "from step 10" in printed
    assert resumed.metrics["losses"] == got[10:]


def test_train_lm_dot_mode_maps_to_a_uniform_plan(tmp_path):
    """``--dot-mode`` sets ``dot_plan``: one step under approx_stat on the
    2-layer model."""
    drv = load("examples/torch_train_lm.py")
    loop, printed = quiet(drv.main, [
        "--device", "cpu", "--dot-mode", "approx_stat",
        "--ckpt-dir", str(tmp_path / "ckpt")], steps=1)
    assert "dot_plan=plan(approx_stat)" in printed
    assert len(loop.metrics["losses"]) == 1 and np.isfinite(loop.metrics["losses"][0])
