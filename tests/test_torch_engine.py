"""The port's LM serving engine against ``repro``'s, on the CPU.

``SlotScheduler`` as in ``tests/test_serving.py``; ``ServingEngine`` on the
same parameters (``repro``'s ``PRNGKey(0)`` tree carried across by
``lm_params_from_jax``) and prompts, greedy outputs token for token; the
substrate-override cases; an MoE config and the encoder-decoder against
``repro``'s engine; truncation counted as failed; first-wave identity at 1
and 2 workers; and the launcher once with ``--device cpu`` (and once for
each other family). Models are
float32 so that both packages quantize the same float32 activations.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jreg
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.launch import serve as launch_serve
from repro_torch.models import convert
from repro_torch.models import registry as reg
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.nn import plan as tplan
from repro_torch.nn import substrate as sub
from repro_torch.serving import Request, ServingEngine, SlotScheduler
from tests.test_models_smoke import reduced
from tests.test_torch_models import port_cfg

PROMPTS = [[5, 9, 11], [1, 2], [7, 3, 3, 8], [60, 2, 17]]


def _pair(seed=0, **extra):
    """(repro bundle, repro params, port bundle, port params): minitron-8b
    reduced to 1 layer, d_model 32, vocab 64, at float32."""
    jcfg = reduced("minitron-8b", n_layers=1, d_model=32, d_ff=64, vocab=64,
                   n_heads=2, n_kv_heads=2, dtype=jnp.float32, **extra)
    jb = jreg.build_bundle(jcfg)
    jparams = jb.init_params(jax.random.PRNGKey(seed))
    cfg = port_cfg(jcfg)
    return jb, jparams, reg.build_bundle(cfg), lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams))


def _engine(bundle, params, **kw):
    return ServingEngine(bundle, params, device="cpu", **kw)


# ---------------------------------------------------------------------------
# SlotScheduler
# ---------------------------------------------------------------------------


def test_slot_scheduler_refill_release_cycle():
    s = SlotScheduler(2)
    s.extend(["a", "b", "c"])
    assert s.refill() == [(0, "a"), (1, "b")]
    assert s.occupancy == 2 and s.busy and s.refill() == []
    s.release(0)
    assert s.refill() == [(0, "c")]
    assert [i for i, _ in s.occupied()] == [0, 1]
    s.release(0)
    s.release(1)
    assert not s.busy and s.occupancy == 0


def test_slot_scheduler_rejects_zero_slots():
    with pytest.raises(ValueError, match="n_slots"):
        SlotScheduler(0)


# ---------------------------------------------------------------------------
# ServingEngine against repro's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    ("exact", "exact"),
    ("approx_cuda:proposed@8", "approx_bitexact:proposed@8"),
], ids=["exact", "approx_cuda"])
def test_greedy_outputs_match_repro_engine(spec):
    """The same parameters and prompts, batch 2 with refills: every greedy
    token equal. ``approx_cuda`` runs its kernels' plain versions here,
    which compute the integers of ``repro``'s ``approx_bitexact``."""
    port_spec, repro_spec = spec
    jb, jparams, tb, tparams = _pair()
    jeng = JServingEngine(jb, jparams, batch_size=2, max_len=32,
                          substrate=repro_spec)
    teng = _engine(tb, tparams, batch_size=2, max_len=32, substrate=port_spec)
    want = jeng.generate([JRequest(prompt=p, max_tokens=5) for p in PROMPTS])
    got = teng.generate([Request(prompt=p, max_tokens=5) for p in PROMPTS])
    assert [r.output for r in got] == [r.output for r in want]
    assert all(len(r.output) == 5 for r in got)
    assert teng.metrics.requests_served == len(PROMPTS)
    assert teng.metrics.batches_by_reason.keys() == {"decode"}
    assert teng.metrics.latency_percentile(50) > 0


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "whisper-large-v3"])
def test_other_families_greedy_outputs_match_repro_engine(arch):
    """An MoE config (batch 2 at capacity 1: a token is dropped where both
    pick one expert) and the encoder-decoder (``enc_out`` zeros, as
    ``repro``'s engine sets them): every greedy token equal, under
    ``approx_cuda`` (its plain versions: the integers of ``repro``'s
    ``approx_lut``)."""
    jcfg = reduced(arch, d_model=32, d_ff=64, vocab=64, n_heads=2,
                   n_kv_heads=2, dtype=jnp.float32)
    jb = jreg.build_bundle(jcfg)
    jparams = jb.init_params(jax.random.PRNGKey(1))
    cfg = port_cfg(jcfg)
    tb = reg.build_bundle(cfg)
    tree = jax.tree.map(np.asarray, jparams)
    tparams = (convert.encdec_params_from_jax(cfg, tree) if cfg.family == "encdec"
               else convert.lm_params_from_jax(cfg, tree))
    jeng = JServingEngine(jb, jparams, batch_size=2, max_len=32,
                          substrate="approx_lut:proposed@8")
    teng = _engine(tb, tparams, batch_size=2, max_len=32,
                   substrate="approx_cuda:proposed@8")
    want = jeng.generate([JRequest(prompt=p, max_tokens=4) for p in PROMPTS])
    got = teng.generate([Request(prompt=p, max_tokens=4) for p in PROMPTS])
    assert [r.output for r in got] == [r.output for r in want]
    assert teng.metrics.requests_served == len(PROMPTS)


def test_greedy_output_matches_a_manual_decode_loop():
    _, _, bundle, params = _pair(seed=3)
    prompt = [5, 9, 11]
    out = _engine(bundle, params, batch_size=1, max_len=32).generate(
        [Request(prompt=prompt, max_tokens=4)])[0].output
    state = bundle.init_decode_state(1, 32)
    outs = []
    for i in range(len(prompt) + 3):
        tok = prompt[i] if i < len(prompt) else outs[-1]
        logits, state = bundle.decode_step(
            params, state, {"token": torch.tensor([[tok]]), "cache_len": i})
        if i >= len(prompt) - 1:
            outs.append(int(logits[0, 0].argmax()))
    assert out == outs[:4]


def test_traced_spans_are_profiler_ranges():
    """Under a tracer, the decode step's spans are ``record_function``
    ranges in a ``torch.profiler`` trace (the card's trace splits device
    time by them); with no tracer the step opens none."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import Tracer, tracing_scope

    _, _, bundle, params = _pair()
    eng = _engine(bundle, params, batch_size=1, max_len=16,
                  substrate="approx_cuda:proposed@8")
    spans = {"serve.decode_step", "substrate.dot_general",
             "kernel.closed_form_matmul", "lm.attention", "lm.logits"}
    for tracer in (Tracer(), None):
        with tracing_scope(tracer), profile(
                activities=[ProfilerActivity.CPU]) as prof:
            eng.generate([Request(prompt=[1, 2], max_tokens=1)])
        names = {e.name for e in prof.events()}
        assert (spans <= names) if tracer else not (spans & names)


def test_temperature_requests_sample_in_range():
    _, _, bundle, params = _pair()
    eng = _engine(bundle, params, batch_size=2, max_len=64)
    out = eng.generate([Request(prompt=[1, 2, 3], max_tokens=5),
                        Request(prompt=[4, 5], max_tokens=4, temperature=0.7)])
    assert len(out[0].output) == 5 and len(out[1].output) == 4
    assert all(0 <= t < 64 for t in out[0].output + out[1].output)


def test_first_wave_identical_at_one_and_two_workers():
    """Worker 0 at workers=2 serves requests 0, 2, 4, ... in its first wave;
    workers=1 seats the same requests in the same slots when they come
    first, so their greedy outputs are identical (quantized activations are
    scaled per batch, so a request's numbers depend on its co-seated
    requests)."""
    _, _, bundle, params = _pair()
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, 64, 4))) for _ in range(8)]

    def serve(order, workers):
        eng = _engine(bundle, params, batch_size=4, max_len=64,
                      substrate="approx_cuda:proposed@8")
        reqs = [Request(prompt=prompts[i], max_tokens=4) for i in order]
        eng.generate(reqs, workers=workers)
        assert eng.metrics.requests_served == len(order)
        return {i: r.output for i, r in zip(order, reqs)}

    two = serve(range(8), workers=2)
    one = serve([0, 2, 4, 6, 1, 3, 5, 7], workers=1)
    assert all(one[i] == two[i] for i in (0, 2, 4, 6))


def test_redundant_generate_is_noop():
    _, _, bundle, params = _pair()
    eng = _engine(bundle, params, batch_size=2, max_len=64)
    reqs = [Request(prompt=[1, 2], max_tokens=3)]
    eng.generate(reqs)
    steps = eng.metrics.batches_flushed
    eng.generate(reqs)                   # all requests already done
    assert eng.metrics.batches_flushed == steps


def test_truncated_request_counts_failed():
    _, _, bundle, params = _pair()
    eng = _engine(bundle, params, batch_size=1, max_len=8)
    out = eng.generate([Request(prompt=[1, 2, 3], max_tokens=50)])[0]
    assert 0 < len(out.output) < 50      # truncated, not fully served
    assert eng.metrics.requests_failed == 1
    assert eng.metrics.requests_served == 0


def test_workers_must_be_positive():
    _, _, bundle, params = _pair()
    with pytest.raises(ValueError, match="workers"):
        _engine(bundle, params).generate([Request(prompt=[1])], workers=0)


# ---------------------------------------------------------------------------
# substrate overrides (as tests/test_serving.py)
# ---------------------------------------------------------------------------


def test_substrate_override_spec():
    _, _, bundle, params = _pair()
    assert bundle.cfg.dot_plan == "exact"
    eng = _engine(bundle, params, batch_size=1, max_len=32, substrate="int8")
    assert eng.cfg.dot_plan == tplan.SubstratePlan.uniform("int8")
    assert eng.bundle.substrate is sub.get_substrate("int8")
    out = eng.generate([Request(prompt=[1, 2, 3], max_tokens=4)])
    assert len(out[0].output) == 4
    assert all(0 <= t < eng.cfg.vocab for t in out[0].output)


def test_substrate_override_registry_instance_and_custom_subclass():
    _, _, bundle, params = _pair()
    eng = _engine(bundle, params, batch_size=1, max_len=16,
                  substrate=sub.get_substrate("approx_lut"))
    assert eng.bundle.plan == tplan.SubstratePlan.uniform("approx_lut:proposed")

    class Custom(sub.LutSubstrate):
        pass

    with pytest.raises(ValueError, match="does not match the registered"):
        _engine(bundle, params, batch_size=1, max_len=16,
                substrate=Custom("proposed"))


def test_substrate_override_plan_dict():
    _, _, bundle, params = _pair()
    d = {"version": 1, "default": "int8",
         "rules": [{"site": "layer.0.ffn.*", "spec": "approx_cuda:exact"}]}
    eng = _engine(bundle, params, batch_size=1, max_len=16, substrate=d)
    assert eng.bundle.plan == tplan.as_plan(d)
    assert eng.bundle.substrate is sub.get_substrate("int8")


def test_params_on_another_device_raise():
    _, _, bundle, params = _pair()
    with pytest.raises(ValueError, match="params lie on"):
        ServingEngine(bundle, params.to("meta"), device="cpu")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_serves_on_the_cpu(tmp_path, capsys):
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(
        {"version": 1, "default": "approx_cuda:proposed@8",
         "rules": [{"site": "layer.0.*", "spec": "approx_cuda:exact"}]}))
    out = launch_serve.main([
        "--arch", "minitron-8b", "--device", "cpu", "--n-layers", "2",
        "--d-model", "32", "--d-ff", "64", "--vocab", "64", "--n-heads", "2",
        "--n-kv-heads", "2", "--requests", "3", "--max-tokens", "3",
        "--workers", "2", "--plan", str(plan),
        "--metrics-out", str(tmp_path / "m.json"),
        "--trace-out", str(tmp_path / "t.json")])
    assert [len(r.output) for r in out] == [3, 3, 3]
    text = capsys.readouterr().out
    assert "plan(approx_cuda:proposed@8+1 rules)" in text and "on cpu" in text
    metrics = json.loads((tmp_path / "m.json").read_text())["metrics"]
    assert "serving_batch_size_total" in metrics
    names = {e["name"] for e in json.loads(
        (tmp_path / "t.json").read_text())["traceEvents"]}
    assert {"serve.generate", "serve.decode_step",
            "kernel.closed_form_matmul", "kernel.lut_matmul"} <= names
    # a plan bundle directory (no params: the seeded init serves)
    from repro_torch.checkpoint import save_plan_bundle

    save_plan_bundle(str(tmp_path / "bundle"), json.loads(plan.read_text()))
    out = launch_serve.main(["--arch", "minitron-8b", "--device", "cpu",
                             "--n-layers", "1", "--d-model", "32", "--d-ff",
                             "64", "--vocab", "64", "--n-heads", "2",
                             "--n-kv-heads", "2", "--requests", "1",
                             "--max-tokens", "2", "--plan",
                             str(tmp_path / "bundle")])
    assert [len(r.output) for r in out] == [2]


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "paligemma-3b",
                                  "whisper-large-v3"])
def test_launcher_serves_the_other_families(arch, tmp_path):
    """An MoE (``--n-experts``), the vlm and the encoder-decoder through the
    launcher, the last with a bundle of its params written in ``repro``'s
    tree and restored through ``bundle.layout``."""
    from repro_torch.checkpoint import save_plan_bundle

    flags = ["--arch", arch, "--device", "cpu", "--n-layers", "2", "--d-model",
             "32", "--d-ff", "64", "--vocab", "64", "--n-heads", "2",
             "--n-kv-heads", "1", "--requests", "1", "--max-tokens", "2"]
    if arch.startswith("kimi"):
        flags += ["--n-experts", "16"]  # at least top_k = 8
    cfg = reg.get_config(arch, n_layers=2, d_model=32, d_ff=64, vocab=64,
                         n_heads=2, n_kv_heads=1,
                         **({"n_experts": 16} if arch.startswith("kimi") else {}))
    bundle = reg.build_bundle(cfg)
    params = bundle.init_params(torch.Generator().manual_seed(9))
    save_plan_bundle(str(tmp_path / "b"), "approx_cuda:proposed@8",
                     bundle.layout.to_tree(convert.named_leaves(params)))
    out = launch_serve.main(flags + ["--plan", str(tmp_path / "b")])
    assert [len(r.output) for r in out] == [2]
    eng = _engine(bundle, params, batch_size=2, max_len=128,
                  substrate="approx_cuda:proposed@8")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=list(rng.integers(1, 64, size=4)), max_tokens=2)]
    eng.generate(reqs)
    assert reqs[0].output == out[0].output  # the restored params served
