"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a),
holds the closed-form device function exhaustively and every kernel exactly
against its plain torch version, then serves 56 images (full-HD frames,
512×512 test images, ragged shapes) through
``EdgeDetectService("approx_cuda")`` in five timed windows and checks every
served map byte for byte against the plain pipeline. One more window runs
under ``torch.profiler`` and the port's span tracer; its Chrome trace goes to
``chiprun_out/chip_smoke_trace.json``. The same mix is then served under a
per-site substrate plan (the center tap on the ``exact`` product table, the
ring taps on csp_axc1@6) and checked against the planned pipeline built from
the plain twins; one planned window is traced the same way
(``chiprun_out/chip_smoke_planned_trace.json``). The planned path must
launch only the narrow design of the two contraction kernels; a wide
contraction through ``dot_general`` (a dense layer's shape) drives their
tile design. The 512×512 set is served once more under uniform
``approx_cuda:exact``. The fused conv's stencil design must be the only one
the uniform paths launch (both product kinds); its generic design runs on
the paths that take it (the closed form at width 12, a 7×7 kernel). Both
designs of the fused conv and of the contraction kernels are checked and
timed at the shapes the served paths give them.

Then the LM path: minitron-8b at its published widths. Both tile designs
are checked exactly against their plain versions (and ``torch._int_mm`` at
``exact``) and timed at the dense layers' four (K, N) shapes, at M = 8 (a
decode step at batch 8) and M = 256 (a prefill of 4 × 64 tokens). The
model, cut to 4 layers, serves 16 requests through ``ServingEngine`` under
``approx_cuda:proposed@8`` at 2 workers (only tile launches, 7 per
layer-step; worker 0's first wave equal to a 1-worker run) and under a
per-site plan (layer 0 on the exact table, the FFNs at csp_axc1@6), whose
prefill of 4 × 64 tokens through ``bundle.prefill`` (M = 256; the engine
prefills token by token) must equal the same plan on ``approx_lut``; one
decode step's logits must equal, bit for bit, those of the plain substrates
on the card; 4 decode steps are traced (``chiprun_out/
chip_smoke_lm_trace.json``); and two timed decode steps and one prefill
of 8 × 32 tokens run at all 32 layers. Every phase prints one JSON line;
the line before the last lists the kernels with their launches on the path
that runs them, their times and least-work bounds, and the last line is
``{"ok": true, "device": ...}``.
Any failed check raises, so the exit code is non-zero and no result line is
printed. Needs CUDA; exits non-zero without it. Imports no JAX.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 at 3.35 TB/s; INT32 at
# 16.75 TOP/s = the 67 TFLOP/s fp32 rate / 2 (an FMA counts two) / 2 (Hopper
# SMs have 64 INT32 lanes beside 128 FP32 lanes, Hopper white paper); dense
# INT8 tensor cores at 1979 TOP/s (a multiply-add counts two), which compute
# the exact wiring's int8 x int8 -> int32 contraction.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2 / 2
INT8_TC_OPS_PER_S = 1979e12
SLEEP_CYCLES = 20_000_000  # ~11 ms at 1.755 GHz: time to enqueue 10 calls
WINDOWS = 5  # timed passes over the served mix, within one run
PLANNED_WINDOWS = 3  # timed passes of the planned path
#: the per-site plan the planned path serves (schema v1, as repro writes it)
PLAN = {"version": 1, "default": "approx_cuda:proposed@8",
        "rules": [{"site": "conv.edge.center", "spec": "approx_cuda:exact"},
                  {"site": "conv.edge.ring", "spec": "approx_cuda:csp_axc1@6"}]}
#: the LM path: minitron-8b at its published widths, depth cut to
#: LM_LAYERS for the serving phases (the full 32 layers in lm_full_depth_step)
LM_ARCH = "minitron-8b"
LM_LAYERS = 4
LM_BATCH = 8
LM_MAX_LEN = 64
LM_PROMPT = 8  # tokens per prompt, and max_tokens per request
LM_REQUESTS = 16
LM_PREFILL = (4, 64)  # (batch, tokens) of the kernel shapes' prefill: M = 256
LM_FULL_PREFILL = (8, 32)  # the full-depth prefill, also M = 256
INT_MM_MIN_M = 17  # torch._int_mm takes M > 16: M = 8 is zero-padded to 17
#: the LM plan: layer 0 on the exact product table, every other FFN at
#: csp_axc1@6, the rest proposed@8 ("layer.0.*" is the more literal match)
LM_PLAN = {"version": 1, "default": "approx_cuda:proposed@8",
           "rules": [{"site": "layer.0.*", "spec": "approx_cuda:exact"},
                     {"site": "*.ffn.*", "spec": "approx_cuda:csp_axc1@6"}]}
#: the same plan on the plain substrates (the same integers, plain torch)
LM_PLAN_PLAIN = {"version": 1, "default": "approx_bitexact:proposed@8",
                 "rules": [{"site": "layer.0.*", "spec": "approx_lut:exact"},
                           {"site": "*.ffn.*", "spec": "approx_bitexact:csp_axc1@6"}]}
#: the same plan on the table substrate alone (plain torch gathers into the
#: exact product tables): fast enough to hold a prefill of 256 rows to
LM_PLAN_TABLE = {"version": 1, "default": "approx_lut:proposed@8",
                 "rules": [{"site": "layer.0.*", "spec": "approx_lut:exact"},
                           {"site": "*.ffn.*", "spec": "approx_lut:csp_axc1@6"}]}
#: the (K, N) of minitron-8b's dense layers and their launches per layer-step
LM_SHAPES = {"attn.wq,wo": (4096, 4096, 2), "attn.wk,wv": (4096, 1024, 2),
             "ffn.wg,wi": (4096, 16384, 2), "ffn.wo": (16384, 4096, 1)}
#: the port's spans that split a traced decode step on the device
LM_SPANS = ("kernel.closed_form_matmul", "kernel.lut_matmul",
            "substrate.dot_general", "lm.attention", "lm.logits",
            "serve.decode_step")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
            f"{tuple(want.shape)} {want.dtype}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls. The
    stream first sleeps on the card while the host enqueues every call, so
    that the calls run back to back and the host's launch cost (Python,
    ctypes, allocations) does not show in a kernel's time."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: int, n_ops: int,
             ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    """Least time on the card: the larger of the bytes over the HBM rate and
    the integer operations over their peak rate (INT32 unless given), and
    which of the two it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def table_ops(coeffs, n_bits: int) -> tuple[int, int]:
    """(distinct coefficients, operations to tabulate them). With a
    coefficient c fixed at launch, the product f(x, c) is a function of x
    alone: a table of 2^N entries per distinct c, counted at one operation
    per entry (a lower count than any closed form, so the bound stays a
    least time)."""
    distinct = len({int(c) for c in np.asarray(coeffs).ravel()})
    return distinct, distinct << n_bits


def device_busy(trace_path: Path) -> tuple[float, dict]:
    """(union of device activity in µs, µs per kernel/copy name) from a
    ``torch.profiler`` Chrome trace; both empty if it holds no device event."""
    events = json.loads(trace_path.read_text()).get("traceEvents", [])
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name: dict = {}
    for e in dev:
        # ATen's templated kernel names → the op inside, e.g. rshift_kernel_cuda
        m = re.search(r"::(\w+_cuda|launch_\w+)\(", e["name"])
        name = m.group(1) if m else e["name"].split("(int")[0]
        by_name[name] = by_name.get(name, 0.0) + float(e["dur"])
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                         for e in dev):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy, by_name


def timed_once(fn):
    """(result, device ms) of one call, from CUDA events around it (for the
    plain versions, whose one call takes seconds at the LM shapes)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def contraction_work(m: int, k: int, n: int, table_bytes: int = 0):
    """(bytes, operations) of the least work of an (m × k) @ (k × n)
    contraction of int8 codes into int32 where both operands vary: one
    operation per entry of the 2^16-entry product table, per table read and
    per add; each int8 input and the table read once, each int32 output
    written once."""
    ops = (1 << 16) + m * k * n + m * n * (k - 1)
    return m * k + k * n + table_bytes + 4 * m * n, ops


def exact_contraction_work(m: int, k: int, n: int):
    """(bytes, operations) of the least work of the exact wiring's (m × k) @
    (k × n) contraction of int8 codes into int32: an int8 tensor-core
    product (two operations per multiply-add, at ``INT8_TC_OPS_PER_S``); each
    input read once, each output written once."""
    return m * k + k * n + 4 * m * n, 2 * m * k * n


def device_ms_by_span(prof, spans) -> dict:
    """Device ms of a profile's kernels and copies launched by torch ops,
    split by the innermost of ``spans`` (the port's trace spans, profiler
    ranges while it records) around the op. The contraction kernels, which
    ctypes launches outside any op, are left to the by-name totals; what a
    ``kernel.*`` span holds besides them is ``blocking.as3``'s int32 casts."""
    out: dict = {}
    for e in prof.events():
        for kern in getattr(e, "kernels", ()):
            if "matmul_kernel" in kern.name:
                continue
            label, p = "outside the spans", e
            while p is not None:
                if p.name in spans:
                    label = p.name
                    break
                p = p.cpu_parent
            out[label] = out.get(label, 0.0) + kern.duration / 1e3
    return out


def lm_phases(dev, card: str, out_dir: Path, emit_trace) -> tuple:
    """The LM path: minitron-8b through ServingEngine on the tile designs of
    both contraction kernels. Returns (rows of the kernels line, least work
    by row name)."""
    import dataclasses

    from repro_torch.kernels.approx_matmul import ops as am
    from repro_torch.kernels.approx_matmul.ops import (closed_form_matmul,
                                                       closed_form_matmul_plain)
    from repro_torch.kernels.lut_matmul import ops as lm
    from repro_torch.kernels.lut_matmul.ops import (device_table, lut_matmul,
                                                    lut_matmul_plain)
    from repro_torch.models import registry as reg
    from repro_torch.nn import plan as plan_mod
    from repro_torch.nn import substrate as sub
    from repro_torch.obs.trace import Tracer, tracing_scope
    from repro_torch.serving import Request, ServingEngine
    from torch.profiler import ProfilerActivity, profile

    counters = (closed_form_matmul.launches, closed_form_matmul.narrow_launches,
                lut_matmul.launches, lut_matmul.narrow_launches)

    def reset():
        for c in counters:
            c.reset()

    def counts() -> dict:
        torch.cuda.synchronize()
        return dict(zip(("closed_form_tile", "closed_form_narrow", "lut_tile",
                         "lut_narrow"), (c.value for c in counters)))

    # -- lm_kernel_shapes: the dense operands of one decode step (M = 8) and
    # of one prefill of 4 x 64 tokens (M = 256), quantized as dense does
    cfg = reg.get_config(LM_ARCH)
    gen = torch.Generator(dev).manual_seed(1)
    t_exact = device_table("exact", dev)
    q = sub.QuantPolicy()
    shape_rows: dict = {}
    for m in (LM_BATCH, LM_PREFILL[0] * LM_PREFILL[1]):
        for site, (k, n, per_step) in LM_SHAPES.items():
            x = torch.randn((1, m, k), generator=gen, device=dev).to(cfg.dtype)
            w = (torch.randn((1, k, n), generator=gen, device=dev)
                 / k ** 0.5).to(cfg.dtype)
            qa, _ = sub._quantize_operand(x, q.x_mode, None, 2, 8, q.eps)
            qb, _ = sub._quantize_operand(w, q.w_mode, None, 1, 8, q.eps)
            a32, b32 = qa.to(torch.int32), qb.to(torch.int32)
            iters = 10 if m == LM_BATCH else 3
            cf_plain, cf_plain_ms = timed_once(
                lambda: closed_form_matmul_plain(a32, b32, "proposed@8"))
            lut_plain, lut_plain_ms = timed_once(
                lambda: lut_matmul_plain(a32, b32, t_exact))
            cf_err = max_abs_err(am._launch(a32, b32, "proposed@8",
                                            design="tile"), cf_plain)
            lut_tile = lm._launch(a32, b32, t_exact, 8, design="tile")
            lut_err = max_abs_err(lut_tile, lut_plain)
            # torch._int_mm: int8 x int8 -> int32, exact (the exact wiring's
            # product), M zero-padded to its shape rule where below it
            a2 = qa[0]
            if m < INT_MM_MIN_M:
                a2 = F.pad(a2, (0, 0, 0, INT_MM_MIN_M - m))
            b2 = qb[0].contiguous()
            lib_err = max_abs_err(torch._int_mm(a2, b2)[:m], lut_tile[0])
            require(cf_err == 0 and lut_err == 0 and lib_err == 0,
                    f"tile designs at ({m} x {k}) @ ({k} x {n}): closed form "
                    f"{cf_err}, lut {lut_err}, _int_mm {lib_err}")
            ms = {"closed_form_tile": time_ms(lambda: am._launch(
                      a32, b32, "proposed@8", design="tile"), iters=iters),
                  "lut_tile": time_ms(lambda: lm._launch(
                      a32, b32, t_exact, 8, design="tile"), iters=iters),
                  "int_mm": time_ms(lambda: torch._int_mm(a2, b2), iters=iters),
                  "closed_form_plain": cf_plain_ms, "lut_plain": lut_plain_ms}
            cf_work = contraction_work(m, k, n)
            lut_work = exact_contraction_work(m, k, n)
            shape_rows[(m, site)] = {"k": k, "n": n, "per_layer_step": per_step,
                                     "ms": ms, "work": {"closed_form": cf_work,
                                                        "lut": lut_work},
                                     "err": {"closed_form": cf_err, "lut": lut_err}}
            emit("lm_kernel_shapes", m=m, site=site, shape=[1, m, k, n],
                 max_abs_err={"closed_form_tile": cf_err, "lut_tile": lut_err,
                              "int_mm": lib_err}, tolerance=0, ms=ms,
                 int_mm_rows=a2.shape[0],
                 bound_ms={"closed_form": bound_ms(*cf_work)[0],
                           "lut": bound_ms(*lut_work, INT8_TC_OPS_PER_S)[0]})
            del x, w, qa, qb, a32, b32, cf_plain, lut_plain, lut_tile, a2, b2
    torch.cuda.empty_cache()

    # -- lm_serving_path: minitron-8b at its published widths, depth cut
    bundle = reg.get_bundle(LM_ARCH, n_layers=LM_LAYERS)
    params = bundle.init_params(torch.Generator(dev).manual_seed(0), dev)
    vocab = bundle.cfg.vocab
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, vocab, LM_PROMPT)))
               for _ in range(LM_REQUESTS)]

    def requests(order):
        return [Request(prompt=prompts[i], max_tokens=LM_PROMPT,
                        temperature=0.0 if i % 2 == 0 else 0.8) for i in order]

    def serve(substrate, order, workers: int) -> tuple:
        """One generate() on a warmed engine, counters reset just before it
        and read just after: (requests, counts, readings)."""
        eng = ServingEngine(bundle, params, batch_size=LM_BATCH,
                            max_len=LM_MAX_LEN, substrate=substrate, device=dev)
        eng.generate([Request(prompt=[1, 2], max_tokens=1)])  # warm-up
        torch.cuda.synchronize()
        eng.metrics.reset()
        reqs = requests(order)
        reset()
        t0 = time.perf_counter()
        eng.generate(reqs, workers=workers)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts()
        st = eng.metrics.snapshot()
        require(all(r.done and len(r.output) == LM_PROMPT
                    and all(0 <= t < vocab for t in r.output) for r in reqs)
                and st["requests_served"] == len(reqs)
                and st["requests_failed"] == 0, f"served {st}")
        busy = eng.metrics.worker_busy_seconds
        batches = eng.metrics.worker_batches
        tokens = sum(len(r.output) for r in reqs)
        return reqs, c, {
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "latency_p50_ms": st["latency_p50_ms"],
            "latency_p99_ms": st["latency_p99_ms"],
            "decode_steps": eng.metrics.batches_flushed,
            "decode_step_ms_by_worker": {w: 1e3 * busy[w] / batches[w]
                                         for w in sorted(batches)}}

    reduced = {"n_layers": [bundle.cfg.n_layers, cfg.n_layers]}
    reqs2, c2, r2 = serve("approx_cuda:proposed@8", range(LM_REQUESTS), 2)
    steps = r2["decode_steps"]
    require(c2 == {"closed_form_tile": 7 * LM_LAYERS * steps,
                   "closed_form_narrow": 0, "lut_tile": 0, "lut_narrow": 0},
            f"lm serving launches {c2} over {steps} steps")
    # workers=1 with the requests of worker 0 first: its first wave seats
    # the same requests in the same slots as worker 0 did
    order1 = list(range(0, LM_REQUESTS, 2)) + list(range(1, LM_REQUESTS, 2))
    reqs1, _, r1 = serve("approx_cuda:proposed@8", order1, 1)
    first_wave = {i: r.output for i, r in zip(order1[:LM_BATCH], reqs1)}
    same = all(first_wave[i] == reqs2[i].output for i in first_wave)
    require(same, "first-wave greedy outputs differ between 1 and 2 workers")
    emit("lm_serving_path", arch=LM_ARCH, reduced=reduced,
         widths={"d_model": cfg.d_model, "n_heads": cfg.n_heads,
                 "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
                 "vocab": cfg.vocab},
         substrate="approx_cuda:proposed@8", batch=LM_BATCH,
         requests=LM_REQUESTS, prompt_tokens=LM_PROMPT, max_tokens=LM_PROMPT,
         workers_2=r2, workers_1=r1, launches=c2,
         launches_expected="7 x layers x decode steps",
         first_wave_identical=same, card=card)

    # -- lm_planned_path: layer 0 on the exact table, FFNs at csp_axc1@6
    reqs_p, cp, rp = serve(LM_PLAN, range(LM_REQUESTS), 2)
    sp = rp["decode_steps"]
    require(cp == {"closed_form_tile": 7 * (LM_LAYERS - 1) * sp,
                   "closed_form_narrow": 0, "lut_tile": 7 * sp,
                   "lut_narrow": 0}, f"lm planned launches {cp} over {sp} steps")
    # one prefill of 4 x 64 tokens under the plan through the prefill entry
    # point (ServingEngine prefills through decode_step): M = 256 on both
    # kernels, the logits bit for bit those of the table substrate's plan
    def planned(plan):
        return reg.build_bundle(dataclasses.replace(
            bundle.cfg, dot_plan=plan_mod.as_plan(plan)))

    pbundle = planned(LM_PLAN)
    toks = torch.from_numpy(rng.integers(1, vocab, LM_PREFILL)).to(dev)
    reset()
    (logits_pf, prefill_ms) = timed_once(
        lambda: pbundle.prefill(params, {"tokens": toks}))
    cpf = counts()
    require(cpf == {"closed_form_tile": 7 * (LM_LAYERS - 1), "closed_form_narrow": 0,
                    "lut_tile": 7, "lut_narrow": 0}, f"planned prefill {cpf}")
    table_pf, table_pf_ms = timed_once(
        lambda: planned(LM_PLAN_TABLE).prefill(params, {"tokens": toks}))
    pf_same = logits_pf.shape == (LM_PREFILL[0], 1, vocab) \
        and bool(torch.isfinite(logits_pf).all()) \
        and torch.equal(logits_pf.view(torch.int32), table_pf.view(torch.int32))
    require(pf_same, "planned prefill logits differ from the table substrate's")
    emit("lm_planned_path", plan=LM_PLAN, reduced=reduced, serving=rp,
         launches=cp, prefill={"entry_point": "bundle.prefill",
                               "tokens": list(LM_PREFILL), "ms": prefill_ms,
                               "launches": cpf, "bit_identical_to": LM_PLAN_TABLE,
                               "bit_identical": pf_same,
                               "table_substrate_ms": table_pf_ms}, card=card)
    del table_pf

    # -- lm_bit_identity: one decode step, the kernels against the plain
    # substrates on the same card: the same integers, the same float ops
    tok = torch.from_numpy(rng.integers(1, vocab, (LM_BATCH, 1))).to(dev)

    def step_logits(plan) -> torch.Tensor:
        b = reg.build_bundle(dataclasses.replace(
            bundle.cfg, dot_plan=plan_mod.as_plan(plan)))
        caches = b.init_decode_state(LM_BATCH, LM_MAX_LEN, dev)
        return b.decode_step(params, caches, {"token": tok, "cache_len": 0})[0]

    identity = {}
    for kern, plain in (("approx_cuda:proposed@8", "approx_bitexact:proposed@8"),
                        ("approx_cuda:exact", "approx_lut:exact"),
                        (LM_PLAN, LM_PLAN_PLAIN)):
        a, (b, plain_ms) = step_logits(kern), timed_once(lambda: step_logits(plain))
        same = bool(torch.isfinite(a).all()) and torch.equal(
            a.view(torch.int32), b.view(torch.int32))
        name = kern if isinstance(kern, str) else "lm_plan"
        identity[name] = {"against": plain if isinstance(plain, str)
                          else "lm_plan on approx_bitexact / approx_lut",
                          "bit_identical": same,
                          "plain_step_ms": plain_ms}
        require(same, f"lm logits {name} differ from {identity[name]['against']}")
    emit("lm_bit_identity", reduced=reduced, decode_steps=1, batch=LM_BATCH,
         logits_shape=list(a.shape), cases=identity)
    del a, b, logits_pf

    # -- lm_trace: 4 decode steps of the cut model under torch.profiler
    eng = ServingEngine(bundle, params, batch_size=LM_BATCH, max_len=LM_MAX_LEN,
                        substrate="approx_cuda:proposed@8", device=dev)
    eng.generate([Request(prompt=[1, 2], max_tokens=1)])  # warm-up
    torch.cuda.synchronize()
    eng.metrics.reset()
    tracer = Tracer()
    treqs = [Request(prompt=prompts[i][:2], max_tokens=3) for i in range(LM_BATCH)]
    with tracing_scope(tracer), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(treqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace_path = out_dir / "chip_smoke_lm_trace.json"
    prof.export_chrome_trace(str(trace_path))
    n_steps = eng.metrics.batches_flushed
    emit_trace("lm_trace", trace_path, {"wall_s": wall, "decode_steps": n_steps},
               tracer)
    busy_us, by_name = device_busy(trace_path)
    split = device_ms_by_span(prof, LM_SPANS)
    split["tile kernels (by name)"] = sum(
        v for k, v in by_name.items() if "matmul_kernel" in k) / 1e3
    emit("lm_trace_split", decode_steps=n_steps,
         device_ms_per_step={k: v / n_steps for k, v in split.items()},
         device_busy_ms_per_step=busy_us / 1e3 / n_steps,
         unattributed_ms_per_step=(busy_us / 1e3 - sum(split.values())) / n_steps,
         wall_ms_per_step=1e3 * wall / n_steps,
         spans={"kernel.*": "int32 casts (blocking.as3)",
                "substrate.dot_general": "quantization and rescale",
                "lm.attention": "attention", "lm.logits": "lm_logits",
                "serve.decode_step": "the rest: embedding, norms, rope, "
                                     "silu, cache writes, logits to host"})
    del eng, params, bundle, pbundle
    torch.cuda.empty_cache()

    # -- lm_full_depth_step: all 32 layers, one decode step and one prefill
    full = reg.get_bundle(LM_ARCH, dot_plan="approx_cuda:proposed@8")
    torch.cuda.reset_peak_memory_stats()
    params = full.init_params(torch.Generator(dev).manual_seed(0), dev)
    caches = full.init_decode_state(LM_BATCH, LM_MAX_LEN, dev)
    full.decode_step(params, caches, {"token": tok, "cache_len": 0})  # warm-up
    torch.cuda.synchronize()
    reset()
    step_ms = []
    for i in (1, 2):
        t0 = time.perf_counter()
        logits, step_dev_ms = timed_once(lambda: full.decode_step(
            params, caches, {"token": tok, "cache_len": i})[0])
        step_ms.append({"device_events_ms": step_dev_ms,
                        "host_ms": 1e3 * (time.perf_counter() - t0)})
    cdec = counts()
    toks = torch.from_numpy(rng.integers(1, vocab, LM_FULL_PREFILL)).to(dev)
    reset()
    pf_logits, pf_ms = timed_once(lambda: full.prefill(params, {"tokens": toks}))
    cfull = counts()
    for what, c, n_calls in (("decode", cdec, 2), ("prefill", cfull, 1)):
        require(c == {"closed_form_tile": 7 * cfg.n_layers * n_calls,
                      "closed_form_narrow": 0, "lut_tile": 0, "lut_narrow": 0},
                f"full-depth {what} launches {c}")
    require(logits.shape == (LM_BATCH, 1, vocab) and bool(torch.isfinite(logits).all())
            and pf_logits.shape == (LM_FULL_PREFILL[0], 1, vocab)
            and bool(torch.isfinite(pf_logits).all()), "full-depth logits")
    emit("lm_full_depth_step", arch=LM_ARCH, layers=cfg.n_layers,
         params=cfg.param_count(), batch=LM_BATCH, cache_len=[1, 2],
         decode_step=step_ms, prefill={"tokens": list(LM_FULL_PREFILL),
                                       "device_events_ms": pf_ms},
         launches={"decode": cdec, "prefill": cfull}, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         card=card)
    del params, caches, logits, pf_logits
    torch.cuda.empty_cache()

    # rows of the kernels line: each tile design at each LM shape
    src = {"closed_form": ("approx_matmul", "src/repro_torch/csrc/approx_matmul.cu",
                           "src/repro/kernels/approx_matmul/kernel.py:59",
                           "closed_form_matmul", "proposed@8"),
           "lut": ("lut_matmul", "src/repro_torch/csrc/lut_matmul.cu",
                   "src/repro/kernels/lut_matmul/kernel.py:74", "lut_matmul",
                   "exact")}
    m_pf = LM_PREFILL[0] * LM_PREFILL[1]
    # M = 8 rows: decode steps served by ServingEngine.generate (the main
    # path); M = 256 rows: the prefill entry point, which the engine does not
    # call (it prefills token by token through decode_step)
    served, prefill = "ServingEngine.generate", "bundle.prefill"
    launched = {("closed_form", LM_BATCH): (c2["closed_form_tile"],
                                           "lm_serving_path", served),
                ("closed_form", m_pf): (cpf["closed_form_tile"],
                                       "lm_planned_path (prefill)", prefill),
                ("lut", LM_BATCH): (cp["lut_tile"], "lm_planned_path", served),
                ("lut", m_pf): (cpf["lut_tile"], "lm_planned_path (prefill)",
                                prefill)}
    rows, work = [], {}
    for (m, site), r in shape_rows.items():
        for kind, (_, source, tpu, name, key) in src.items():
            b_ms, by = bound_ms(*r["work"][kind], INT8_TC_OPS_PER_S
                                if kind == "lut" else INT32_OPS_PER_S)
            n_launch, where, entry = launched[(kind, m)]
            row_name = f"{name}[tile,{site},M={m}]"
            rows.append({"name": row_name, "route": "cuda", "source": source,
                         "replaces": tpu, "launches": n_launch,
                         "max_abs_err": r["err"][kind],
                         "ms": r["ms"][f"{kind}_tile"],
                         "plain_ms": r["ms"][f"{kind}_plain"],
                         "bound_ms": b_ms, "bound_by": by,
                         "library_ms": r["ms"]["int_mm"] if kind == "lut" else None,
                         "shape": [1, m, r["k"], r["n"]], "mult": key,
                         "design": "tile", "launches_on": where,
                         "entry_point": entry,
                         "launches_per_layer_step_at_shape": r["per_layer_step"]})
            work[row_name] = r["work"][kind]
    return rows, work


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import lut as lut_lib
    from repro_torch.core import multiplier as mult
    from repro_torch.data import image_batch, mixed_shape_batch, photo_like
    from repro_torch.kernels import blocking, build
    from repro_torch.kernels.approx_matmul import ops as am
    from repro_torch.kernels.approx_matmul.ops import (closed_form_matmul,
                                                       closed_form_matmul_plain)
    from repro_torch.kernels.approx_mul.ops import approx_mul, approx_mul_plain
    from repro_torch.kernels.closed_form import approx_product_i32
    from repro_torch.kernels.fused_conv import ops as fc
    from repro_torch.kernels.fused_conv.ops import (fused_conv2d,
                                                    fused_conv2d_plain,
                                                    fused_conv_columns,
                                                    stencil_conv_plain)
    from repro_torch.kernels.lut_matmul import ops as lm
    from repro_torch.kernels.lut_matmul.ops import (device_table, lut_matmul,
                                                    lut_matmul_plain)
    from repro_torch.nn import conv
    from repro_torch.nn import plan as plan_mod
    from repro_torch.nn import substrate as sub
    from repro_torch.obs.trace import Tracer, tracing_scope
    from repro_torch.serving import EdgeDetectService
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    # -- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    paths = build.build(build.SOURCES)
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         libraries={k: str(v.name) for k, v in paths.items()},
         ptxas={k: [ln.strip() for ln in build.build_log(k).splitlines()
                    if "registers" in ln or "spill" in ln]
                for k in build.SOURCES})

    # -- 3. closed form, exhaustive: 9 wirings x widths 3..8 ----------------
    n_pairs = 0
    for name in sorted(mult.WIRINGS):
        for n in range(3, 9):
            key = f"{name}@{n}"
            v = torch.arange(-(1 << (n - 1)), 1 << (n - 1), dtype=torch.int32,
                             device=dev)
            got = closed_form_matmul(v[:, None], v[None, :], key)
            want = torch.from_numpy(lut_lib.build_lut(key).copy()).to(dev)
            require(torch.equal(got, want), f"closed form {key} vs build_lut")
            n_pairs += v.numel() ** 2
    torch.cuda.synchronize()
    emit("closed_form_exhaustive", wirings=len(mult.WIRINGS), widths=[3, 8],
         pairs=n_pairs, max_abs_err=0)

    # -- 4. kernels vs plain ------------------------------------------------
    lap = conv.LAPLACIAN
    taps_lap = tuple(tuple(int(c) for c in row) for row in lap)
    k5 = rng.integers(-8, 9, (5, 5)).astype(np.int32)
    # W % 4 != 0 at 47, 129 and 70 (the stencil design's scalar path), a
    # 5x5 kernel, and proposed@12, which only the generic design takes
    conv_cases = [((8, 1088, 1920), lap, "proposed"),
                  ((3, 33, 47), lap, "proposed"),
                  ((5, 17, 129), lap, "proposed"),
                  ((2, 40, 70), k5, "proposed"),
                  ((3, 33, 47), lap, "design_strollo2020@4"),
                  ((3, 33, 47), lap, "csp_axc5@4"),
                  ((2, 37, 70), lap, "proposed@12")]
    errs = {"fused_conv[stencil]": 0, "fused_conv[generic]": 0,
            "approx_matmul": 0}

    def conv_designs(x, kern, key: str, kind: str) -> dict:
        """Both designs of one product kind at one shape: the public entry
        point (the stencil design wherever it takes the shape) and the
        stencil design against its plain twin, the generic design (private
        ``design=``) against fused_conv2d_plain; each error in the int32
        ring."""
        key = mult.canonical_key(key)
        n = mult.split_width(key)[1]
        taps = tuple(tuple(int(c) for c in row) for row in kern)
        plain = fused_conv2d_plain(x, taps, key, kind)
        err = {"generic": max_abs_err(
            fc._launch(x, taps, key, kind, design="generic"), plain)}
        public = fused_conv2d(x, kern, key, kernel_kind=kind)
        if fc.conv_design(taps, key) == "stencil":
            slots, cols = fused_conv_columns(taps, key, kind, dev)
            twin = stencil_conv_plain(x, slots, cols, n, *np.shape(kern))
            err["stencil"] = max(max_abs_err(public, twin),
                                 max_abs_err(public, plain))
        else:
            err["generic"] = max(err["generic"], max_abs_err(public, plain))
        torch.cuda.synchronize()
        return err

    for shape, kern, key in conv_cases:
        hi = 1 << (mult.split_width(key)[1] - 1)
        x = torch.from_numpy(rng.integers(-hi, hi, shape).astype(np.int32)).to(dev)
        e = conv_designs(x, kern, key, "closed_form")
        for design, v in e.items():
            errs[f"fused_conv[{design}]"] = max(errs[f"fused_conv[{design}]"], v)
        emit("fused_conv_vs_plain", shape=list(shape), kernel=list(kern.shape),
             mult=key, kind="closed_form", max_abs_err=e, tolerance=0)
        require(set(e.values()) == {0}, f"fused conv {shape} {key}: {e}")
    mm_cases = [(1, 1000, 777, 333, "proposed"), (4, 65, 9, 3, "proposed"),
                (1, 8 * 1088 * 1920, 9, 1, "proposed"),
                (1, 17, 33, 9, "design_strollo2020@4")]
    for b, m, k, n, key in mm_cases:
        hi = 1 << (mult.split_width(key)[1] - 1)
        a = torch.from_numpy(rng.integers(-hi, hi, (b, m, k)).astype(np.int32)).to(dev)
        w = torch.from_numpy(rng.integers(-hi, hi, (b, k, n)).astype(np.int32)).to(dev)
        e = max_abs_err(closed_form_matmul(a, w, key),
                        closed_form_matmul_plain(a, w, mult.canonical_key(key)))
        errs["approx_matmul"] = max(errs["approx_matmul"], e)
        emit("approx_matmul_vs_plain", shape=[b, m, k, n], mult=key,
             max_abs_err=e, tolerance=0)
        require(e == 0, f"approx matmul {(b, m, k, n)} {key}")
    torch.cuda.synchronize()

    # -- 4b. the LUT kernels and approx_mul vs plain (every check exact) ----
    lut_errs = {"lut_matmul": 0, "fused_conv_lut[stencil]": 0,
                "fused_conv_lut[generic]": 0, "approx_mul": 0}
    pairs = 0
    for name in sorted(mult.WIRINGS) + ["exact"]:
        key = f"{name}@4"
        v = torch.arange(-8, 8, dtype=torch.int32, device=dev)
        t = device_table(key, dev)
        got = lut_matmul(v[:, None], v[None, :], t)
        want = torch.from_numpy(lut_lib.build_lut(key).copy()).to(dev)
        e = max(max_abs_err(got, lut_matmul_plain(v[None, :, None],
                                                  v[None, None, :], t)[0]),
                max_abs_err(got, want))
        lut_errs["lut_matmul"] = max(lut_errs["lut_matmul"], e)
        require(e == 0, f"lut_matmul exhaustive {key}")
        pairs += 256
    # ragged with a K tail (proposed@8: f(0,0) = 192 would show), batched and
    # unbatched, and the plan's full-HD center-group shape
    hd_m = 8 * 1088 * 1920
    lut_cases = [(None, 1000, 777, 333, "proposed"), (4, 65, 9, 3, "exact"),
                 (None, 17, 33, 9, "design_strollo2020@4"),
                 (2, 40, 100, 70, "csp_axc1@6"),
                 (None, hd_m, 1, 1, "proposed"), (None, hd_m, 1, 1, "exact")]
    for b, m, k, n, key in lut_cases:
        hi = 1 << (mult.split_width(key)[1] - 1)
        bb = b or 1
        a = torch.from_numpy(rng.integers(-hi, hi, (bb, m, k)).astype(np.int32)).to(dev)
        w = torch.from_numpy(rng.integers(-hi, hi, (bb, k, n)).astype(np.int32)).to(dev)
        t = device_table(key, dev)
        got = lut_matmul(a, w, t) if b else lut_matmul(a[0], w[0], t)[None]
        e = max_abs_err(got, lut_matmul_plain(a, w, t))
        lut_errs["lut_matmul"] = max(lut_errs["lut_matmul"], e)
        emit("lut_matmul_vs_plain", shape=[b, m, k, n], mult=key, max_abs_err=e,
             tolerance=0)
        require(e == 0, f"lut_matmul {(b, m, k, n)} {key}")
    x_hd = torch.from_numpy(rng.integers(0, 128, (8, 1088, 1920))
                            .astype(np.int32)).to(dev)
    lut_conv_cases = [(x_hd, lap, "exact"), (x_hd, lap, "proposed")] + [
        (torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int32)).to(dev),
         kern, key) for shape, kern, key in conv_cases[1:]
        if mult.split_width(key)[1] <= 8] + [
        (torch.from_numpy(rng.integers(-128, 128, (3, 33, 47)).astype(np.int32))
         .to(dev), lap, "exact")]
    for x_l, kern, key in lut_conv_cases:
        e = conv_designs(x_l, kern, key, "lut")
        if key == "proposed" and x_l is x_hd:  # the table kind = the closed form
            e["stencil"] = max(e["stencil"], max_abs_err(
                fused_conv2d(x_l, lap, key, kernel_kind="lut"),
                fused_conv2d(x_l, lap, key, kernel_kind="closed_form")))
        for design, v in e.items():
            lut_errs[f"fused_conv_lut[{design}]"] = max(
                lut_errs[f"fused_conv_lut[{design}]"], v)
        emit("fused_conv_lut_vs_plain", shape=list(x_l.shape),
             kernel=list(np.shape(kern)), mult=key, kind="lut", max_abs_err=e,
             tolerance=0)
        require(set(e.values()) == {0}, f"fused conv lut kind {key}: {e}")
    v = torch.arange(-128, 128, dtype=torch.int32, device=dev)
    ga, gb = torch.meshgrid(v, v, indexing="ij")
    e = max_abs_err(approx_mul(ga, gb), approx_product_i32(ga, gb))
    am_a = torch.from_numpy(rng.integers(-128, 128, (4096, 4096))
                            .astype(np.int32)).to(dev)
    am_b = torch.from_numpy(rng.integers(-128, 128, (4096, 4096))
                            .astype(np.int32)).to(dev)
    e = max(e, max_abs_err(approx_mul(am_a, am_b), approx_product_i32(am_a, am_b)))
    wide = torch.from_numpy(rng.integers(-2**31, 2**31, (2, 1 << 19),
                                         dtype=np.int64).astype(np.int32)).to(dev)
    e = max(e, max_abs_err(approx_mul(wide[0], wide[1]),
                           approx_product_i32(wide[0], wide[1])))
    lut_errs["approx_mul"] = e
    require(e == 0, "approx_mul vs approx_product_i32")
    torch.cuda.synchronize()
    emit("lut_kernels", exhaustive_n4_pairs=pairs, max_abs_err=lut_errs,
         approx_mul_pairs=65536, approx_mul_shape=list(am_a.shape), tolerance=0)

    # -- 5. main path: EdgeDetectService("approx_cuda") ---------------------
    hd = [photo_like(1080, 1920, seed=i) for i in range(32)]
    tiles = list(image_batch(16, 512, 512, seed=0))
    ragged = mixed_shape_batch(8, seed=0)
    images = hd + tiles + ragged
    s = sub.get_substrate("approx_cuda")

    def plain_map(img: np.ndarray) -> np.ndarray:
        """The plain twins called by name, on the card."""
        px = conv.to_signed_pixels(torch.from_numpy(img)[None].to(dev), 8)
        raw = fused_conv2d_plain(px, taps_lap, "proposed")
        return torch.clamp(raw, 0, 255).to(torch.uint8)[0].cpu().numpy()

    def window(svc) -> tuple[list, dict]:
        """Serve the whole mix once, all requests queued at once."""
        svc.metrics.reset()
        t0 = time.perf_counter()
        maps = svc.detect(images, timeout=300.0)
        wall = time.perf_counter() - t0
        st = svc.metrics.snapshot()
        require(st["requests_served"] == len(images) and
                st["requests_failed"] == 0, f"served {st}")
        return maps, {"wall_s": wall, "images_per_s": len(images) / wall,
                      "latency_p50_ms": st["latency_p50_ms"],
                      "latency_p99_ms": st["latency_p99_ms"],
                      "batches": st["batches_flushed"]}

    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    svc = EdgeDetectService("approx_cuda", max_batch_size=8,
                            bucket_granularity=16, n_workers=2)
    try:
        svc.detect(hd[:8] + tiles[:8] + ragged)  # warm-up: every bucket shape
        torch.cuda.synchronize()
        for counter in (fused_conv2d.launches, fused_conv2d.lut_launches,
                        fused_conv2d.stencil_launches,
                        closed_form_matmul.launches,
                        closed_form_matmul.narrow_launches):
            counter.reset()
        served, first = window(svc)
        windows = [first]
        for _ in range(WINDOWS - 1):
            maps, w = window(svc)
            require(all(np.array_equal(a, b) for a, b in zip(maps, served)),
                    "served maps differ between windows")
            windows.append(w)
        # kernel 2 on the main path: one im2col batch of the 512x512 set
        tile_dev = torch.from_numpy(np.stack(tiles)).to(dev)
        im2col_raw = conv.conv2d_batched(conv.to_signed_pixels(tile_dev, 8),
                                         lap, s, fused=False)
        torch.cuda.synchronize()
        # every fused launch here is the closed-form kind; those that are
        # not stencil launches are the generic design's
        launches = {"fused_conv_stencil": fused_conv2d.stencil_launches.value,
                    "fused_conv_generic": fused_conv2d.launches.value
                        - fused_conv2d.stencil_launches.value,
                    "fused_conv_lut": fused_conv2d.lut_launches.value,
                    "approx_matmul": closed_form_matmul.launches.value,
                    "approx_matmul_narrow":
                        closed_form_matmul.narrow_launches.value}
        # one more window under torch.profiler (device activity) and the
        # port's span tracer (host phases); not counted in `windows`
        tracer = Tracer()
        with tracing_scope(tracer), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, traced = window(svc)
            torch.cuda.synchronize()
        trace_path = out_dir / "chip_smoke_trace.json"
        prof.export_chrome_trace(str(trace_path))
    finally:
        svc.close()
    # the fused conv runs only its stencil design; the im2col batch is
    # (B*H*W x 9) @ (9 x 1): the narrow design
    require(launches["fused_conv_stencil"] > 0
            and launches["fused_conv_generic"] == 0
            and launches["fused_conv_lut"] == 0
            and launches["approx_matmul_narrow"] > 0
            and launches["approx_matmul"] == 0, f"launches {launches}")
    for img, out in zip(images, served):
        require(out.shape == img.shape and out.dtype == np.uint8,
                f"served map shape {out.shape} {out.dtype}")
        require(np.array_equal(out, plain_map(img)),
                f"served map differs from the plain pipeline at {img.shape}")
    im2col_maps = torch.clamp(im2col_raw, 0, 255).to(torch.uint8).cpu().numpy()
    require(np.array_equal(im2col_maps, np.stack(served[32:48])),
            "im2col (approx_matmul) maps differ from the served maps")
    # reference on small inputs: the core multiplier model's tap loop (CPU)
    for img, out in zip(ragged, served[48:]):
        ref = conv.edge_detect(torch.from_numpy(img), "proposed").numpy()
        require(np.array_equal(out, ref), f"ragged {img.shape} vs tap loop")
    exact = conv.edge_detect_batched(tile_dev, "exact").cpu().numpy()
    psnr = float(np.mean([conv.psnr(exact[i], served[32 + i])
                          for i in range(len(tiles))]))
    rates = sorted(w["images_per_s"] for w in windows)
    emit("main_path", images=len(images), windows=windows,
         images_per_s_median=rates[len(rates) // 2],
         images_per_s_min=rates[0], images_per_s_max=rates[-1],
         launches=launches, psnr_proposed8_vs_exact_512_db=round(psnr, 4),
         byte_identical=True)

    def emit_trace(phase: str, path: Path, traced: dict, tracer) -> None:
        """Device busy/idle share and time per kernel or copy of one traced
        window, and the port's host spans summed over the worker threads."""
        busy_us, by_name = device_busy(path)
        spans: dict = {}
        for e in tracer.events():
            spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e3
        emit(phase, trace=str(path.relative_to(out_dir.parent)),
             window=traced,
             device_busy_ms=busy_us / 1e3 if by_name else None,
             device_idle_share=(1 - busy_us / 1e6 / traced["wall_s"]
                                if by_name else None),
             device_ms_by_name={k: v / 1e3 for k, v in sorted(
                 by_name.items(), key=lambda kv: -kv[1])[:10]},
             host_span_ms_summed_over_threads=spans)

    emit_trace("main_path_trace", trace_path, traced, tracer)

    # -- 5b. planned path: EdgeDetectService(PLAN) ---------------------------
    plan = plan_mod.as_plan(PLAN)
    groups = {name: (taps, plan.resolve(f"{conv.EDGE_SITE}.{name}"))
              for name, taps in conv._EDGE_TAP_GROUPS}
    lap_flat = lap.reshape(-1)

    def planned_plain_map(img: np.ndarray) -> np.ndarray:
        """The planned pipeline from the plain twins called by name, on the
        card: the center group through lut_matmul_plain (exact@8), the ring
        group through closed_form_matmul_plain (csp_axc1@6), each at its own
        width, rescaled and summed."""
        x = torch.from_numpy(img)[None].to(dev)
        total = 0
        for name, (taps, spec) in groups.items():
            key = sub.get_substrate(spec).meta.mult_key
            n = mult.split_width(key)[1]
            px = conv.to_signed_pixels(x, n)
            patches = conv._im2col(px, 3, 3, taps).reshape(1, -1, len(taps))
            coeffs = torch.from_numpy(lap_flat[list(taps)].reshape(
                1, len(taps), 1)).to(dev)
            if name == "center":
                raw = lut_matmul_plain(patches, coeffs, device_table(key, dev))
            else:
                raw = closed_form_matmul_plain(patches, coeffs,
                                               mult.canonical_key(key))
            total = total + conv._rescale_raw(raw.reshape(px.shape), n)
        return torch.clamp(total, 0, 255).to(torch.uint8)[0].cpu().numpy()

    def planned_tap_loop(img: np.ndarray) -> np.ndarray:
        """The same on the CPU from the core multiplier model: per group, one
        1x1 ``conv2d_int`` per tap on the shifted zero-padded image."""
        total = 0
        for taps, spec in groups.values():
            _, fn, n = mult.resolve_multiplier(sub.get_substrate(spec).meta.mult_key)
            px = conv.to_signed_pixels(torch.from_numpy(img), n)
            xp = F.pad(px, (1, 1, 1, 1))
            h, w = px.shape
            raw = sum(conv.conv2d_int(xp[t // 3:t // 3 + h, t % 3:t % 3 + w],
                                      [[int(lap_flat[t])]], fn) for t in taps)
            total = total + conv._rescale_raw(raw, n)
        return torch.clamp(total, 0, 255).to(torch.uint8).numpy()

    svc = EdgeDetectService(PLAN, max_batch_size=8, bucket_granularity=16,
                            n_workers=2)
    try:
        svc.detect(hd[:8] + tiles[:8] + ragged)  # warm-up: every bucket shape
        torch.cuda.synchronize()
        for counter in (lut_matmul.launches, closed_form_matmul.launches,
                        lut_matmul.narrow_launches,
                        closed_form_matmul.narrow_launches,
                        fused_conv2d.launches, fused_conv2d.lut_launches):
            counter.reset()
        p_served, first = window(svc)
        p_windows = [first]
        for _ in range(PLANNED_WINDOWS - 1):
            maps, w = window(svc)
            require(all(np.array_equal(a, b) for a, b in zip(maps, p_served)),
                    "planned maps differ between windows")
            p_windows.append(w)
        torch.cuda.synchronize()
        p_launches = {"lut_matmul": lut_matmul.launches.value,
                      "closed_form_matmul": closed_form_matmul.launches.value,
                      "lut_matmul_narrow": lut_matmul.narrow_launches.value,
                      "closed_form_matmul_narrow":
                          closed_form_matmul.narrow_launches.value,
                      "fused_conv2d": fused_conv2d.launches.value,
                      "fused_conv2d_lut": fused_conv2d.lut_launches.value}
        # one more planned window under torch.profiler and the span tracer
        p_tracer = Tracer()
        with tracing_scope(p_tracer), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p_prof:
            _, p_traced = window(svc)
            torch.cuda.synchronize()
        p_trace_path = out_dir / "chip_smoke_planned_trace.json"
        p_prof.export_chrome_trace(str(p_trace_path))
    finally:
        svc.close()
    # the planned path launches only the narrow design of both kernels
    require(p_launches["lut_matmul_narrow"] > 0
            and p_launches["closed_form_matmul_narrow"] > 0
            and p_launches["lut_matmul"] == 0
            and p_launches["closed_form_matmul"] == 0,
            f"planned path launches {p_launches}")
    for img, out in zip(images, p_served):
        require(out.shape == img.shape and out.dtype == np.uint8,
                f"planned map shape {out.shape} {out.dtype}")
        require(np.array_equal(out, planned_plain_map(img)),
                f"planned map differs from the plain pipeline at {img.shape}")
    for img, out in zip(ragged, p_served[48:]):
        require(np.array_equal(out, planned_tap_loop(img)),
                f"planned ragged {img.shape} vs tap loop")
    p_psnr = float(np.mean([conv.psnr(exact[i], p_served[32 + i])
                            for i in range(len(tiles))]))
    rates = sorted(w["images_per_s"] for w in p_windows)
    emit("planned_path", plan=PLAN, images=len(images), windows=p_windows,
         images_per_s_median=rates[len(rates) // 2],
         images_per_s_min=rates[0], images_per_s_max=rates[-1],
         launches=p_launches, psnr_plan_vs_exact_512_db=round(p_psnr, 4),
         byte_identical=True)
    emit_trace("planned_path_trace", p_trace_path, p_traced, p_tracer)

    # uniform approx_cuda:exact: the fused conv's LUT kind on every batch
    svc = EdgeDetectService("approx_cuda:exact", max_batch_size=8,
                            bucket_granularity=16, n_workers=2)
    try:
        svc.detect(tiles[:8])  # warm-up
        torch.cuda.synchronize()
        for counter in (fused_conv2d.launches, fused_conv2d.lut_launches,
                        fused_conv2d.stencil_launches):
            counter.reset()
        e_served = svc.detect(tiles, timeout=300.0)
        torch.cuda.synchronize()
        e_launches = {"fused_conv2d_lut_stencil": fused_conv2d.stencil_launches.value,
                      "fused_conv2d_lut_generic": fused_conv2d.lut_launches.value
                          - fused_conv2d.stencil_launches.value,
                      "fused_conv2d": fused_conv2d.launches.value}
    finally:
        svc.close()
    require(e_launches["fused_conv2d_lut_stencil"] > 0
            and e_launches["fused_conv2d_lut_generic"] == 0
            and e_launches["fused_conv2d"] == 0,
            f"uniform exact: fused launches {e_launches}")
    require(np.array_equal(np.stack(e_served), exact),
            "uniform approx_cuda:exact maps differ from the exact backend's")
    emit("uniform_exact_path", images=len(tiles), launches=e_launches,
         byte_identical=True)

    # the fused conv's generic design, on the paths that take it: the closed
    # form at width 12 (fused_conv2d serves widths to 16) and a 7x7 kernel,
    # beyond the stencil design's 5x5, through conv2d_batched in both kinds
    k7 = rng.integers(-100, 100, (7, 7)).astype(np.int32)
    taps_k7 = tuple(tuple(int(c) for c in row) for row in k7)
    for counter in (fused_conv2d.launches, fused_conv2d.lut_launches,
                    fused_conv2d.stencil_launches):
        counter.reset()
    g_err = max(
        max_abs_err(fused_conv2d(conv.to_signed_pixels(tile_dev, 12), lap,
                                 "proposed@12"),
                    fused_conv2d_plain(conv.to_signed_pixels(tile_dev, 12),
                                       taps_lap, "proposed@12")),
        max_abs_err(conv.conv2d_batched(conv.to_signed_pixels(tile_dev, 8), k7, s),
                    fused_conv2d_plain(conv.to_signed_pixels(tile_dev, 8),
                                       taps_k7, "proposed")),
        max_abs_err(conv.conv2d_batched(conv.to_signed_pixels(tile_dev, 8), k7,
                                        sub.get_substrate("approx_cuda:exact")),
                    fused_conv2d_plain(conv.to_signed_pixels(tile_dev, 8),
                                       taps_k7, "exact", "lut")))
    torch.cuda.synchronize()
    g_launches = {"fused_conv2d": fused_conv2d.launches.value,
                  "fused_conv2d_lut": fused_conv2d.lut_launches.value,
                  "fused_conv2d_stencil": fused_conv2d.stencil_launches.value}
    require(g_launches["fused_conv2d"] > 0 and g_launches["fused_conv2d_lut"] > 0
            and g_launches["fused_conv2d_stencil"] == 0,
            f"generic conv path launches {g_launches}")
    require(g_err == 0, "generic conv path vs plain")
    emit("generic_conv_path", shape=list(tile_dev.shape),
         cases=["proposed@12 3x3", "proposed 7x7", "exact 7x7"],
         launches=g_launches, max_abs_err=g_err, tolerance=0)

    # the tile design of both contraction kernels, on the path that takes
    # it: dot_general at a dense layer's shape, (8 x 128 tokens x 64) @
    # (64 x 256), K = 64 and N = 256 beyond the narrow design's limits
    tokens = torch.from_numpy(rng.integers(-128, 128, (8, 128, 64))
                              .astype(np.int32)).to(dev)
    weight = torch.from_numpy(rng.integers(-128, 128, (64, 256))
                              .astype(np.int32)).to(dev)
    dense_dims = (((2,), (0,)), ((), ()))
    a_w, b_w = tokens.reshape(1, -1, 64), weight[None]
    wide_plain = {"approx_cuda": closed_form_matmul_plain(a_w, b_w, "proposed@8"),
                  "approx_cuda:exact": lut_matmul_plain(
                      a_w, b_w, device_table("exact", dev))}
    for counter in (closed_form_matmul.launches, lut_matmul.launches,
                    closed_form_matmul.narrow_launches, lut_matmul.narrow_launches):
        counter.reset()
    w_err = 0
    for spec, want in wide_plain.items():
        got = sub.get_substrate(spec).dot_general(
            tokens, weight, sub.ContractionSpec(dense_dims))
        w_err = max(w_err, max_abs_err(got, want[0].reshape(got.shape)))
    torch.cuda.synchronize()
    w_launches = {"closed_form_matmul": closed_form_matmul.launches.value,
                  "lut_matmul": lut_matmul.launches.value,
                  "closed_form_matmul_narrow": closed_form_matmul.narrow_launches.value,
                  "lut_matmul_narrow": lut_matmul.narrow_launches.value}
    require(w_launches["closed_form_matmul"] > 0 and w_launches["lut_matmul"] > 0,
            f"wide contraction launches {w_launches}")
    require(w_err == 0, "wide contraction vs plain")
    emit("wide_contraction_path", shape=[8, 128, 64, 256], specs=list(wide_plain),
         launches=w_launches, max_abs_err=w_err, tolerance=0)

    # the elementwise entry point, called as its users call it: one array of
    # multipliers over a (4096, 4096) operand pair
    approx_mul.launches.reset()
    am_out = approx_mul(am_a, am_b)
    torch.cuda.synchronize()
    am_launches = approx_mul.launches.value
    require(am_launches > 0 and am_out.shape == am_a.shape,
            f"approx_mul launches {am_launches}")
    emit("approx_mul_path", shape=list(am_a.shape), launches=am_launches)

    # -- 6. kernel times at the shapes the main path gives them -------------
    # bound: the least work at these inputs (see table_ops), every int32
    # input read once and every int32 output written once
    n_bits = mult.split_width("proposed")[1]
    b, h, w = 8, 1088, 1920  # a full batch of full-HD frames, bucket-padded
    hd_u8 = torch.from_numpy(
        np.stack([np.pad(f, ((0, 8), (0, 0))) for f in hd[:8]])).to(dev)
    x = conv.to_signed_pixels(hd_u8, 8)

    def fused_times(key: str, kind: str) -> dict:
        """Both designs of one product kind at the main path's shape, and
        their plain versions: the stencil design through the public entry
        point, the generic one through the private ``design=``."""
        slots, cols = fused_conv_columns(taps_lap, key, kind, dev)
        return {"stencil": time_ms(lambda: fused_conv2d(x, lap, key,
                                                        kernel_kind=kind)),
                "generic": time_ms(lambda: fc._launch(x, taps_lap, key, kind,
                                                      design="generic")),
                "stencil_plain": time_ms(lambda: stencil_conv_plain(
                    x, slots, cols, n_bits, 3, 3)),
                "generic_plain": time_ms(lambda: fused_conv2d_plain(
                    x, taps_lap, key, kind))}

    fc_ms = fused_times("proposed", "closed_form")
    emit("fused_conv_designs", shape=list(x.shape), mult="proposed",
         kind="closed_form", ms=fc_ms)
    distinct, tab = table_ops(lap, n_bits)
    # per input pixel one table read per distinct tap, per output kh·kw-1 adds
    fc_ops = tab + b * h * w * (distinct + lap.size - 1)
    fc_bytes = 4 * (2 * b * h * w + lap.size)
    fc_bound, fc_by = bound_ms(fc_bytes, fc_ops)

    def designs(name: str, a3, w3, key: str = None, table=None) -> tuple:
        """Both designs of one contraction kernel at one shape: each held
        against the narrow design's plain twin (and the tile design's plain
        version), then timed: tile through the private ``design=``, narrow
        through the public entry point, and the two plain versions."""
        if table is None:
            key = mult.canonical_key(key)
            nb = mult.split_width(key)[1]
            public = lambda: closed_form_matmul(a3, w3, key)
            tile = lambda: am._launch(a3, w3, key, design="tile")
            plain_tile = lambda: closed_form_matmul_plain(a3, w3, key)
            cols = lambda: am.closed_form_columns(w3, key)
            counter = closed_form_matmul.narrow_launches
        else:
            nb = lm.table_width(table.shape[0])
            public = lambda: lut_matmul(a3, w3, table)
            tile = lambda: lm._launch(a3, w3, table, nb, design="tile")
            plain_tile = lambda: lut_matmul_plain(a3, w3, table)
            cols = lambda: lm.table_columns(w3, table)
            counter = lut_matmul.narrow_launches
        plain_narrow = lambda: blocking.narrow_matmul_plain(a3, cols(), nb)
        want = plain_narrow()
        before = counter.value
        err = {"narrow": max_abs_err(public(), want),
               "tile": max(max_abs_err(tile(), want),
                           max_abs_err(plain_tile(), want))}
        require(counter.value == before + 1, f"{name}: the shape is not narrow")
        require(err == {"narrow": 0, "tile": 0}, f"{name}: designs {err}")
        ms = {"tile": time_ms(tile), "narrow": time_ms(public),
              "tile_plain": time_ms(plain_tile),
              "narrow_plain": time_ms(plain_narrow)}
        emit("contraction_designs", kernel=name,
             shape=[*a3.shape, w3.shape[2]], mult=key or "table",
             max_abs_err=err, ms=ms, tolerance=0)
        return err, ms

    pm, pk = len(tiles) * 512 * 512, lap.size
    a_mm = conv._im2col(conv.to_signed_pixels(tile_dev, 8), 3, 3).reshape(1, pm, pk)
    w_mm = torch.from_numpy(lap.reshape(1, pk, 1)).to(dev)
    mm_err, mm_ms = designs("closed_form_matmul", a_mm, w_mm, key="proposed@8")
    mm_ops = tab + pm * (pk + pk - 1)  # per row K table reads, K-1 adds
    mm_bytes = 4 * (pm * pk + pk + pm)
    mm_bound, mm_by = bound_ms(mm_bytes, mm_ops)

    # the fused conv's LUT kind at the same batch under `exact`; its library
    # yardstick is one float32 cuDNN convolution (TF32 off, set above): exact
    # here, since every |sum| < 2^24
    fl_ms = fused_times("exact", "lut")
    xf = x.to(torch.float32)[:, None]
    lap_f = torch.from_numpy(lap.astype(np.float32))[None, None].to(dev)
    fl_lib_ms = time_ms(lambda: F.conv2d(xf, lap_f, padding=1))
    emit("fused_conv_designs", shape=list(x.shape), mult="exact", kind="lut",
         ms=fl_ms, library_ms=fl_lib_ms)
    # the stencil design is what the served paths launch: it must beat the
    # generic design by 10x in the closed-form kind, and be no slower than
    # the generic design or F.conv2d in the LUT kind
    require(fc_ms["generic"] >= 10 * fc_ms["stencil"]
            and fl_ms["stencil"] <= min(fl_ms["generic"], fl_lib_ms),
            f"fused conv designs: closed form {fc_ms}, lut {fl_ms}, "
            f"F.conv2d {fl_lib_ms}")
    require(torch.equal(F.conv2d(xf, lap_f, padding=1)[:, 0].to(torch.int32),
                        fused_conv2d(x, lap, "exact")),
            "F.conv2d differs from the fused LUT kind under exact")
    # lut_matmul at the plan's center group: (B·H·W × 1) @ (1 × 1), exact@8
    hd_m = b * h * w
    a_c = x.reshape(1, hd_m, 1)
    w_c = torch.tensor([[[int(lap_flat[4])]]], dtype=torch.int32, device=dev)
    t_exact = device_table("exact", dev)
    lm_err, lm_ms = designs("lut_matmul", a_c, w_c, table=t_exact)
    a_cf, w_cf = a_c[0].to(torch.float32), w_c[0].to(torch.float32)
    lm_lib_ms = time_ms(lambda: torch.matmul(a_cf, w_cf))
    require(torch.equal(torch.matmul(a_cf, w_cf).to(torch.int32),
                        lut_matmul(a_c[0], w_c[0], t_exact)),
            "torch.matmul differs from lut_matmul under exact")
    lm_ops = table_ops(lap_flat[[4]], 8)[1] + hd_m  # one read per row
    lm_bytes = 4 * (hd_m + 1 + hd_m)
    lm_bound, lm_by = bound_ms(lm_bytes, lm_ops)
    # kernel 2 at the plan's ring group: (B·H·W × 8) @ (8 × 1), csp_axc1@6
    ring = groups["ring"][0]
    a_r = conv._im2col(conv.to_signed_pixels(hd_u8, 6), 3, 3, ring).reshape(
        1, hd_m, len(ring))
    w_r = torch.from_numpy(lap_flat[list(ring)].reshape(1, len(ring), 1)).to(dev)
    rk = "csp_axc1@6"
    mr_err, mr_ms = designs("closed_form_matmul[ring]", a_r, w_r, key=rk)
    mr_ops = (table_ops(lap_flat[list(ring)], 6)[1]
              + hd_m * (2 * len(ring) - 1))  # K table reads, K-1 adds per row
    mr_bytes = 4 * (hd_m * len(ring) + len(ring) + hd_m)
    mr_bound, mr_by = bound_ms(mr_bytes, mr_ops)
    # approx_mul at (4096, 4096): both operands vary, so the least work is a
    # read of the 2^16-entry product table per element
    am_ms = time_ms(lambda: approx_mul(am_a, am_b))
    am_plain_ms = time_ms(lambda: approx_mul_plain(am_a, am_b))
    am_n = am_a.numel()
    am_ops = (1 << 16) + am_n
    am_bytes = 3 * 4 * am_n
    am_bound, am_by = bound_ms(am_bytes, am_ops)
    cf_src = "src/repro_torch/csrc/approx_matmul.cu"
    cf_tpu = "src/repro/kernels/approx_matmul/kernel.py:59"
    lm_src = "src/repro_torch/csrc/lut_matmul.cu"
    lm_tpu = "src/repro/kernels/lut_matmul/kernel.py:74"

    def contraction_row(name, design, launches_, launched_on, err, ms, bound,
                        by, library, shape, key):
        """A row of the kernels line for one design of a contraction kernel;
        its launches are those of the design on the path that runs it, its
        error the worst of every check of the kernel (phases 4, 4b and the
        design check at this shape)."""
        lut = name.startswith("lut")
        return {"name": name, "route": "cuda", "source": lm_src if lut else cf_src,
                "replaces": lm_tpu if lut else cf_tpu, "launches": launches_,
                "max_abs_err": max(err[design], lut_errs["lut_matmul"] if lut
                                   else errs["approx_matmul"]),
                "ms": ms[design], "plain_ms": ms[f"{design}_plain"],
                "bound_ms": bound, "bound_by": by, "library_ms": library,
                "shape": shape, "mult": key, "design": design,
                "launches_on": launched_on}

    mm_shape, mr_shape, lm_shape = [1, pm, pk, 1], [1, hd_m, len(ring), 1], [1, hd_m, 1, 1]

    def fused_row(name, kind, design, launches_, launched_on, err, ms, library,
                  key):
        """A row of the kernels line for one design of one product kind of
        the fused conv; both share the TPU kernel and the bound."""
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/csrc/fused_conv.cu",
                "replaces": "src/repro/kernels/fused_conv/kernel.py:55",
                "launches": launches_, "max_abs_err": err, "ms": ms[design],
                "plain_ms": ms[f"{design}_plain"], "bound_ms": fc_bound,
                "bound_by": fc_by, "library_ms": library,
                "shape": [b, h, w, 3, 3], "mult": key, "kind": kind,
                "design": design, "launches_on": launched_on}

    kernels = [
        fused_row("fused_conv2d[stencil]", "closed_form", "stencil",
                  launches["fused_conv_stencil"], "main_path",
                  errs["fused_conv[stencil]"], fc_ms, None, "proposed"),
        fused_row("fused_conv2d", "closed_form", "generic",
                  g_launches["fused_conv2d"], "generic_conv_path",
                  errs["fused_conv[generic]"], fc_ms, None, "proposed"),
        contraction_row("closed_form_matmul", "tile",
                        w_launches["closed_form_matmul"], "wide_contraction_path",
                        mm_err, mm_ms, mm_bound, mm_by, None, mm_shape, "proposed"),
        contraction_row("closed_form_matmul[narrow]", "narrow",
                        launches["approx_matmul_narrow"], "main_path",
                        mm_err, mm_ms, mm_bound, mm_by, None, mm_shape, "proposed"),
        fused_row("fused_conv2d[lut,stencil]", "lut", "stencil",
                  e_launches["fused_conv2d_lut_stencil"], "uniform_exact_path",
                  lut_errs["fused_conv_lut[stencil]"], fl_ms, fl_lib_ms, "exact"),
        fused_row("fused_conv2d[lut]", "lut", "generic",
                  g_launches["fused_conv2d_lut"], "generic_conv_path",
                  lut_errs["fused_conv_lut[generic]"], fl_ms, fl_lib_ms, "exact"),
        contraction_row("closed_form_matmul[ring]", "tile",
                        w_launches["closed_form_matmul"], "wide_contraction_path",
                        mr_err, mr_ms, mr_bound, mr_by, None, mr_shape, rk),
        contraction_row("closed_form_matmul[ring,narrow]", "narrow",
                        p_launches["closed_form_matmul_narrow"], "planned_path",
                        mr_err, mr_ms, mr_bound, mr_by, None, mr_shape, rk),
        contraction_row("lut_matmul", "tile", w_launches["lut_matmul"],
                        "wide_contraction_path", lm_err, lm_ms, lm_bound, lm_by,
                        lm_lib_ms, lm_shape, "exact"),
        contraction_row("lut_matmul[narrow]", "narrow",
                        p_launches["lut_matmul_narrow"], "planned_path",
                        lm_err, lm_ms, lm_bound, lm_by, lm_lib_ms, lm_shape, "exact"),
        {"name": "approx_mul", "route": "cuda",
         "source": "src/repro_torch/csrc/approx_mul.cu",
         "replaces": "src/repro/kernels/approx_mul/kernel.py:19",
         "launches": am_launches,
         "max_abs_err": lut_errs["approx_mul"], "ms": am_ms,
         "plain_ms": am_plain_ms, "bound_ms": am_bound, "bound_by": am_by,
         "library_ms": None, "shape": list(am_a.shape), "mult": "proposed"},
    ]
    lm_rows, lm_work = lm_phases(dev, card, out_dir, emit_trace)
    kernels += lm_rows
    require(all(k["max_abs_err"] == 0 and k["launches"] > 0 for k in kernels),
            "every kernel exact and launched on its path")
    work = {"fused_conv2d[stencil]": (fc_bytes, fc_ops),
            "fused_conv2d": (fc_bytes, fc_ops),
            "fused_conv2d[lut,stencil]": (fc_bytes, fc_ops),
            "closed_form_matmul": (mm_bytes, mm_ops),
            "closed_form_matmul[narrow]": (mm_bytes, mm_ops),
            "fused_conv2d[lut]": (fc_bytes, fc_ops),
            "closed_form_matmul[ring]": (mr_bytes, mr_ops),
            "closed_form_matmul[ring,narrow]": (mr_bytes, mr_ops),
            "lut_matmul": (lm_bytes, lm_ops), "lut_matmul[narrow]": (lm_bytes, lm_ops),
            "approx_mul": (am_bytes, am_ops), **lm_work}
    emit("kernel_times", card=card, int32_peak_ops_per_s=INT32_OPS_PER_S,
         int8_tensor_core_peak_ops_per_s=INT8_TC_OPS_PER_S,
         hbm_bytes_per_s=HBM_BYTES_PER_S, tf32={
             "cudnn": torch.backends.cudnn.allow_tf32,
             "matmul": torch.backends.cuda.matmul.allow_tf32},
         least_work={k["name"]: {"bytes": work[k["name"]][0],
                                 "ops": work[k["name"]][1]} for k in kernels},
         share_of_bound={k["name"]: k["bound_ms"] / k["ms"] for k in kernels})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
