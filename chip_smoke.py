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
rows design, and the same contraction at width 12 and under a table beyond
the rows design's planes their tile design. The 512×512 set is served once
more under uniform ``approx_cuda:exact``. The fused conv's stencil design
must be the only one the uniform paths launch (both product kinds); its
generic design runs on
the paths that take it (the closed form at width 12, a 7×7 kernel). Both
designs of the fused conv and of the contraction kernels are checked and
timed at the shapes the served paths give them. The edge model of QAT
(``train.qat.finetune_edge``) fine-tunes 120 steps on the 512×512 set under
the same plan: its maps at init equal the served planned maps byte for
byte, its forward launches only the narrow designs, and its PSNR after is
no worse than before (phase ``edge_qat_path``).

Then the LM path: minitron-8b at its published widths. At the dense
layers' four (K, N) shapes and M = 8 (a decode step at batch 8) the decode
design of both contraction kernels (the whole int16 product table in shared
memory) and the tensor design of ``lut_matmul`` (the ``exact`` product on
the INT8 tensor cores) are checked exactly against their plain twins, the
tile designs' plain versions and ``torch._int_mm``, and timed beside the
tile designs and ``torch._int_mm``; at M = 256 (a prefill of 4 × 64
tokens, a training step's 8 × 32) the rows design of both kernels (the
product as an exact int8 GEMM plus bit-monomial int8 GEMMs on the INT8
tensor cores) is, the same way, and the few-row designs must refuse the
shape; the rows design must be 20× faster than the tile design and reach
10% of its tensor-core bound (``approx_matmul``), and be no slower than
``torch._int_mm`` (``exact``). The ``kernel="lut"`` substrate runs one
decode layer-step's dense calls (``lut_matmul``'s decode design), bit for
bit those of the closed form. The model, cut to 4 layers, serves 16 requests through
``ServingEngine`` under ``approx_cuda:proposed@8`` at 2 workers (only
decode launches, 7 per layer-step, no tile launch; worker 0's first wave
equal to a 1-worker run) and under a per-site plan (layer 0 on the exact
table: tensor launches; the FFNs at csp_axc1@6), whose prefill of 4 × 64
tokens through ``bundle.prefill`` (M = 256: rows launches only; the engine
prefills token by token) must equal the same plan on ``approx_lut``; one
decode step's logits must equal, bit for bit, those of the plain substrates
on the card; 4 decode steps are traced (``chiprun_out/
chip_smoke_lm_trace.json``); and two timed decode steps and one prefill
of 8 × 32 tokens run at all 32 layers (the prefill on the rows design
alone).

Then training (phase ``lm_train_path``): the 4-layer model at its published
widths takes 3 QAT steps of ``TrainLoop`` (AdamW, batch 8 × 32 tokens, so
M = 256 on every dense) under ``approx_cuda:proposed@8`` and 3 under the
LM plan, on the rows designs alone (7 launches per layer in the forward, 7
in the recompute of the backward), each held bit for bit, losses and every
updated parameter, to the same steps on the table substrate; one more step
runs under ``torch.profiler`` (``chiprun_out/chip_smoke_train_trace.json``,
phase ``lm_train_trace``). At a reduced width (``RESTART_SIZE``) a run
crashed after its step-8 checkpoint and restarted with neither plan nor
policy configured (both adopted from the manifest) ends bit for bit where
an uninterrupted run does, a conflicting plan is refused, and the
launchers' ``--qat-out`` bundle serves through ``launch/serve.py --plan``
(phase ``lm_train_restart``).

Then the paper's tables, the contraction meter and the plan autotuner.
Table 4 (``core.metrics.evaluate``, every 8-bit design) runs on the card,
every field equal to the CPU's, beside Table 5 and the headline savings
(phase ``paper_tables``). The 512×512 set is served under the edge plan
with a probing ``ContractionMeter`` installed: exactly 16·512·512·K MACs
per tap group, energy = MACs × the unit-gate PDP, the probe's moments equal
to the same service on the CPU, maps and launches equal to an un-metered
run (phase ``meter_path``). ``launch.autotune.autotune_edge`` searches the
same set from an ``approx_cuda`` baseline (the narrow designs meter and
validate it; its tuned plan, rewritten onto ``approx_cuda``, serves the
same maps), and a QAT-scored search picks the CPU's plan (phase
``autotune_edge_path``). ``autotune_lm`` tunes minitron-8b at its
published widths, cut to 4 layers: through the CLI at the default budget
(its bundle then served by ``launch/serve.py --plan``), and at a budget
taken from the scored divergence of one move, where a move is accepted;
each search's metered baseline prefill and one metered prefill of the
greedy's plan count 31,138,512,896 MACs, the validation prefills launch
only the rows design, and the greedy's plan prefills bit for bit as on the
table substrate (phase ``autotune_lm_path``).

Then the MoE, vlm and encdec families, each at its published widths and
freed before the next is built. llama4-maverick cut to 2 layers (one unit:
layer 0 dense, layer 1 top-1 MoE of 128 experts with a shared expert)
serves 16 requests through ``ServingEngine`` at batch 8 under
``approx_cuda:proposed@8`` at 2 workers and at 1 (only decode launches, 7
per layer-step; worker 0's first wave equal to the 1-worker run); its dense
shapes are checked on the decode and rows designs against their plain
twins and timed; one decode step's logits and one ``bundle.prefill`` of 4 ×
64 tokens (rows launches only) equal, bit for bit, the same on
``approx_lut:proposed@8`` (phase ``moe_serving_path``). kimi-k2 at 1 layer
(top-8 of 384 experts) prefills 2 × 32 tokens and takes two decode steps
at batch 8, bit for bit the table substrate, with the tokens kept and
dropped at every dispatch (phase ``moe_topk_path``). paligemma-3b at full
depth prefills 256 patch embeddings and 32 tokens at batch 4 (``patch_proj``
and every dense on the rows design) and serves 4 requests, one decode step
bit for bit the table substrate (phase ``vlm_path``). whisper-large-v3 at
full depth prefills 1500 frames at batch 2 (the encoder at 3000 rows, all
rows launches) and serves 4 requests against zero encoder states, 9 decode
and 2 rows launches per decoder layer-step; one decode step of its first 2
decoder layers is held bit for bit to the table substrate (phase
``encdec_path``).

Then the recurrent families (phase ``recurrent_serving_path``), each at
its published widths and full depth, one on the card at a time:
xlstm-125m (12 layers, mLSTM and sLSTM) and zamba2-1.2b (38 mamba layers,
the shared attention block after every sixth) serve the same 16 requests
at batch 8 under ``approx_cuda:proposed@8`` at 2 workers and at 1 (only
decode launches: 72 and 118 a step, each (K, N) as ``REC_SHAPES`` counts
it; worker 0's first wave equal); one decode step (logits and every
recurrent state and cache) equals, bit for bit, the same on
``approx_lut:proposed@8``; an 8 × 64 prefill (M = 512) launches only the
rows design and, at full depth for xlstm and at 6 layers for zamba, equals
the table substrate's bit for bit; each new (K, N) is checked on the decode
and rows designs against its plain twin and timed.

Then training of the MoE and recurrent families (``train_family_phases``),
each run of TRAIN_STEPS QAT steps of ``TrainLoop`` at batch 8 × 32 (M = 256:
the rows designs alone, at the counts each (K, N) requires) held, losses
and every updated parameter, bit for bit to the same steps on
``approx_lut``: llama4-maverick at its published widths cut to 4 layers
(two stacked units of a dense and a top-1 MoE layer) and 16 experts, under
``approx_cuda:proposed@8`` and under the LM plan, and kimi-k2 cut to 2
layers and top-8 of 32 experts, with Adafactor on ``repro``'s stacked tree
(phase ``moe_train_path``; one maverick step traced); a crash → restart at a
reduced width with 4 experts, bit for bit, its checkpoint's optimizer
state ``repro``'s Adafactor tree, the launchers' bundle served (phase
``moe_train_restart``); xlstm-125m and zamba2-1.2b at full depth with AdamW
(2 × 72 and 2 × 118 launches a step, each layer recomputed in the
backward), xlstm held to the table substrate at full depth, zamba at 6
layers (one shared block), one zamba step traced (phase
``recurrent_train_path``); and the (M, K, N) these phases add, each
checked against its plain twin and timed. Every phase prints one JSON
line; the line before the last lists the kernels with their launches on
the path that runs them (and, beside the rows of their design and shape,
those of the new phases, counted by shape), their times and least-work
bounds, and the last line is
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
#: the training phases: TrainLoop steps of (batch, seq) tokens, M = 256 rows
#: per dense layer (the M = 256 rows of the kernels line), AdamW at a
#: constant rate
TRAIN_BATCH = (8, 32)
TRAIN_STEPS = 3
TRAIN_LR = 3e-4
#: the crash/restart phase's cut of minitron-8b (a full-width checkpoint
#: would write about 20 GB)
RESTART_SIZE = {"n_layers": 2, "d_model": 512, "n_heads": 8, "n_kv_heads": 2,
                "d_ff": 2048, "vocab": 4096}
EDGE_QAT_STEPS = 120
#: uncalibrated steps held card against CPU in edge_qat_path (a few: Adam
#: moves each coefficient by about lr a step, and 5 steps of 0.1 would bring
#: a coefficient to a rounding tie of its integer code)
EDGE_QAT_CHECK_STEPS = 3
EDGE_QAT_PARAM_ATOL = 1e-4
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
#: the contraction kernels and their output zeroing (ctypes launches, outside
#: any torch op), attributed in a traced decode step by name
LM_KERNELS_BY_NAME = {"decode design kernels (by name)": ("decode_matmul_kernel",),
                      "tensor design kernel (by name)": ("exact_matmul_kernel",),
                      "rows design kernel (by name)": ("rows_matmul_kernel",),
                      "tile design kernels (by name)": ("approx_matmul_kernel",
                                                        "lut_matmul_kernel"),
                      "output memsets (by name)": ("Memset",)}

#: the MoE, vlm and encdec phases, each family at its published widths
MOE_ARCH = "llama4-maverick-400b-a17b"
MOE_LAYERS = 2  # one full unit: layer 0 dense, layer 1 MoE (128 experts)
MOE_MAX_LEN = 32
#: the (K, N) of the MoE config's dense layers (layer 0's FFN and layer 1's
#: shared expert share them) and their launches per layer-step
MOE_SHAPES = {"attn.wq,wo": (5120, 5120, 2), "attn.wk,wv": (5120, 1024, 2),
              "ffn.wg,wi": (5120, 8192, 2), "ffn.wo": (8192, 5120, 1)}
TOPK_ARCH = "kimi-k2-1t-a32b"
TOPK_LAYERS = 1  # top-8 of 384 experts, every layer MoE
TOPK_PREFILL = (2, 32)
VLM_ARCH = "paligemma-3b"  # full depth: 18 layers
VLM_PREFILL = (4, 32)  # text tokens, after the config's 256 patch embeddings
VLM_BATCH = 4
ENCDEC_ARCH = "whisper-large-v3"  # full depth: 32 encoder + 32 decoder layers
ENCDEC_PREFILL = (2, 16)  # decoder tokens, after 1500 frames a sequence
ENCDEC_BATCH = 4
#: decoder layers of the encdec decode step held to the table substrate
#: (its cross K/V take B * 1500 rows, slow on the plain gathers)
ENCDEC_IDENTITY_LAYERS = 2
#: the recurrent families at their published widths and full depth; the
#: (K, N) of each dense site and its launches per decode step
REC_ARCHS = ("xlstm-125m", "zamba2-1.2b")
REC_SHAPES = {
    "xlstm-125m": {"mlstm.wq,wk,wv,wo_gate,wo;slstm.wz,wi,wf,wo_gate,wo":
                   (768, 768, 60), "mlstm.wi,wf": (768, 4, 12)},
    "zamba2-1.2b": {"mamba.in_proj": (2048, 8352, 38),
                    "mamba.out_proj": (4096, 2048, 38),
                    "shared.attn.wq,wk,wv,wo": (2048, 2048, 24),
                    "shared.ffn.wg,wi": (2048, 8192, 12),
                    "shared.ffn.wo": (8192, 2048, 6)},
}
REC_PREFILL = (8, 64)  # M = 512 on every dense: the rows design
REC_MAX_LEN = 32
#: zamba's prefill held to the table substrate at a cut depth that keeps one
#: shared block (after layer 5): 6 layers of 38 (the plain gathers of a
#: 38-layer prefill at M = 512 would take minutes)
REC_IDENTITY_LAYERS = {"zamba2-1.2b": 6}
#: the MoE and recurrent training phases: TRAIN_STEPS QAT steps of
#: TRAIN_BATCH tokens (M = 256, the rows designs only). maverick cut to two
#: units of (dense, MoE) and 16 experts, kimi-k2 to 2 layers and top-8 of
#: 32 experts: every width published (the cuts keep the peak under the
#: card's 80 GB: 128 experts of one layer are 64 GB of bf16 parameters and
#: gradients)
MOE_TRAIN_CUT = {"n_layers": 4, "n_experts": 16}
TOPK_TRAIN_CUT = {"n_layers": 2, "n_experts": 32}
#: the (K, N) of kimi-k2's dense sites (attention at 64 / 8 heads of 112,
#: the shared expert at d_ff 2048) and their launches per layer-pass
TOPK_SHAPES = {"attn.wq,wo": (7168, 7168, 2), "attn.wk,wv": (7168, 896, 2),
               "moe.shared.ffn.wg,wi": (7168, 2048, 2),
               "moe.shared.ffn.wo": (2048, 7168, 1)}
#: the MoE crash/restart phase's cut: RESTART_SIZE at two units, 4 experts
MOE_RESTART_SIZE = {**RESTART_SIZE, "n_layers": 4, "n_experts": 4}


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


def rows_contraction_work(m: int, k: int, n: int, planes: int):
    """(bytes, operations) of the least work of an (m × k) @ (k × n)
    contraction of int8 codes into int32 whose product table takes
    ``planes`` bit-monomial planes besides the exact product
    (``kernels.monomials``): R + 1 int8 tensor-core products (two
    operations per multiply-add, at ``INT8_TC_OPS_PER_S``); each input read
    once, each output written once. For a closed form at M = 256 this is
    below ``contraction_work``'s INT32 count."""
    return m * k + k * n + 4 * m * n, (planes + 1) * 2 * m * k * n


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
    """The LM path: minitron-8b through ServingEngine, every M = 8 dense on
    the decode design of ``approx_matmul`` (closed forms) or the tensor
    design of ``lut_matmul`` (``exact``), the M = 256 prefill and training
    steps on the rows designs. Returns (rows of the kernels line, least work
    by row name)."""
    import dataclasses

    from repro_torch.kernels import blocking
    from repro_torch.kernels.approx_matmul import ops as am
    from repro_torch.kernels.approx_matmul.ops import (closed_form_matmul,
                                                       closed_form_matmul_plain)
    from repro_torch.kernels.lut_matmul import ops as lm
    from repro_torch.kernels.lut_matmul.ops import (device_table, lut_matmul,
                                                    lut_matmul_plain)
    from repro_torch.models import common as mcommon
    from repro_torch.models import registry as reg
    from repro_torch.nn import plan as plan_mod
    from repro_torch.nn import substrate as sub
    from repro_torch.obs.trace import Tracer, tracing_scope
    from repro_torch.serving import Request, ServingEngine
    from torch.profiler import ProfilerActivity, profile

    counters = contraction_counters()

    def reset():
        for c in counters.values():
            c.reset()

    def counts() -> dict:
        torch.cuda.synchronize()
        return {name: c.value for name, c in counters.items()}

    def only(**launched) -> dict:
        """The counts a run must show: ``launched``, every other design 0."""
        return {name: launched.get(name, 0) for name in counters}

    # -- lm_kernel_shapes: the dense operands of one decode step (M = 8) and
    # of one prefill of 4 x 64 tokens (M = 256), quantized as dense does
    cfg = reg.get_config(LM_ARCH)
    gen = torch.Generator(dev).manual_seed(1)
    t_exact = device_table("exact", dev)
    t_prop = device_table("proposed@8", dev)  # kernel="lut" under proposed@8
    cf_planes = am.rows_decomposition("proposed@8")  # the rows design's planes
    require(torch.equal(am.closed_form_table16("proposed@8", dev).cpu(),
                        am.closed_form_table16("proposed@8", "cpu")),
            "the decode table built on the card differs from the closed form")
    q = sub.QuantPolicy()
    shape_rows: dict = {}
    for m in (LM_BATCH, LM_PREFILL[0] * LM_PREFILL[1]):
        decode = m <= blocking.DECODE_MAX_M
        for site, (k, n, per_step) in LM_SHAPES.items():
            x = torch.randn((1, m, k), generator=gen, device=dev).to(cfg.dtype)
            w = (torch.randn((1, k, n), generator=gen, device=dev)
                 / k ** 0.5).to(cfg.dtype)
            qa, _ = sub._quantize_operand(x, q.x_mode, None, 2, 8, q.eps)
            qb, _ = sub._quantize_operand(w, q.w_mode, None, 1, 8, q.eps)
            a32, b32 = qa.to(torch.int32), qb.to(torch.int32)
            iters = 10 if decode else 3
            cf_plain, cf_plain_ms = timed_once(
                lambda: closed_form_matmul_plain(a32, b32, "proposed@8"))
            lut_plain, lut_plain_ms = timed_once(
                lambda: lut_matmul_plain(a32, b32, t_exact))
            err = {"closed_form_tile": max_abs_err(am._launch(
                       qa, qb, "proposed@8", design="tile"), cf_plain),
                   "lut_tile": max_abs_err(lm._launch(
                       qa, qb, t_exact, 8, design="tile"), lut_plain)}
            # torch._int_mm: int8 x int8 -> int32, exact (the exact wiring's
            # product), M zero-padded to its shape rule where below it
            a2 = qa[0]
            if m < INT_MM_MIN_M:
                a2 = F.pad(a2, (0, 0, 0, INT_MM_MIN_M - m))
            b2 = qb[0].contiguous()
            err["int_mm"] = max_abs_err(torch._int_mm(a2, b2)[:m], lut_plain[0])
            ms = {"closed_form_tile": time_ms(lambda: am._launch(
                      qa, qb, "proposed@8", design="tile"), iters=iters),
                  "lut_tile": time_ms(lambda: lm._launch(
                      qa, qb, t_exact, 8, design="tile"), iters=iters),
                  "int_mm": time_ms(lambda: torch._int_mm(a2, b2), iters=iters),
                  "closed_form_tile_plain": cf_plain_ms,
                  "lut_tile_plain": lut_plain_ms}
            if decode:
                # the served designs, through the public entry points that
                # dense calls, on the int8 codes as dense hands them over;
                # each against its plain twin, the tile design's plain
                # version and (tensor) torch._int_mm
                t16 = am.closed_form_table16("proposed@8", dev)
                dec_plain, ms["closed_form_decode_plain"] = timed_once(
                    lambda: blocking.decode_matmul_plain(qa, qb, t16, 8))
                ten_plain, ms["lut_tensor_plain"] = timed_once(
                    lambda: blocking.tensor_matmul_plain(qa, qb))
                ldec_plain, ms["lut_decode_plain"] = timed_once(
                    lambda: blocking.decode_matmul_plain(qa, qb, lm.table16(t_prop), 8))
                reset()
                got = {"closed_form_decode": closed_form_matmul(qa, qb, "proposed@8"),
                       "lut_tensor": lut_matmul(qa, qb, t_exact),
                       "lut_decode": lm._launch(qa, qb, t_prop, 8, design="decode")}
                require(counts() == only(closed_form_decode=1, lut_tensor=1,
                                         lut_decode=1),
                        f"M = {m} at {site}: designs launched {counts()}")
                err["closed_form_decode"] = max(
                    max_abs_err(got["closed_form_decode"], dec_plain),
                    max_abs_err(got["closed_form_decode"], cf_plain))
                err["lut_tensor"] = max(max_abs_err(got["lut_tensor"], ten_plain),
                                        max_abs_err(got["lut_tensor"], lut_plain),
                                        max_abs_err(got["lut_tensor"][0],
                                                    torch._int_mm(a2, b2)[:m]))
                err["lut_decode"] = max(max_abs_err(got["lut_decode"], ldec_plain),
                                        max_abs_err(got["lut_decode"], cf_plain))
                ms["closed_form_decode"] = time_ms(
                    lambda: closed_form_matmul(qa, qb, "proposed@8"), iters=iters)
                ms["lut_tensor"] = time_ms(lambda: lut_matmul(qa, qb, t_exact),
                                           iters=iters)
                ms["lut_decode"] = time_ms(lambda: lm._launch(
                    qa, qb, t_prop, 8, design="decode"), iters=iters)
                del got, dec_plain, ten_plain, ldec_plain
            else:  # no fallback: the few-row designs refuse the prefill's M
                for fn in (lambda: am._launch(qa, qb, "proposed@8", design="decode"),
                           lambda: lm._launch(qa, qb, t_exact, 8, design="tensor"),
                           lambda: lm._launch(qa, qb, t_prop, 8, design="decode")):
                    try:
                        fn()
                    except ValueError:
                        continue
                    require(False, f"a few-row design took M = {m}")
                # the served design at many rows, through the public entry
                # points on the int8 codes as dense hands them over: each
                # against its plain twin, the tile design's plain version
                # and (exact) torch._int_mm
                rows_plain, ms["closed_form_rows_plain"] = timed_once(
                    lambda: blocking.rows_matmul_plain(qa, qb, cf_planes, 8))
                lrows_plain, ms["lut_rows_plain"] = timed_once(
                    lambda: blocking.rows_matmul_plain(
                        qa, qb, lm.rows_decomposition(t_exact), 8))
                reset()
                got = {"closed_form_rows": closed_form_matmul(qa, qb, "proposed@8"),
                       "lut_rows": lut_matmul(qa, qb, t_exact)}
                require(counts() == only(closed_form_rows=1, lut_rows=1),
                        f"M = {m} at {site}: designs launched {counts()}")
                err["closed_form_rows"] = max(
                    max_abs_err(got["closed_form_rows"], rows_plain),
                    max_abs_err(got["closed_form_rows"], cf_plain))
                err["lut_rows"] = max(max_abs_err(got["lut_rows"], lrows_plain),
                                      max_abs_err(got["lut_rows"], lut_plain),
                                      max_abs_err(got["lut_rows"][0],
                                                  torch._int_mm(a2, b2)))
                ms["closed_form_rows"] = time_ms(
                    lambda: closed_form_matmul(qa, qb, "proposed@8"))
                ms["lut_rows"] = time_ms(lambda: lut_matmul(qa, qb, t_exact))
                del got, rows_plain, lrows_plain
            require(set(err.values()) == {0},
                    f"designs at ({m} x {k}) @ ({k} x {n}): {err}")
            # least work: the closed form's at M = 256 is that of its planes
            # on the INT8 tensor cores, below its INT32 count
            work = {"closed_form": contraction_work(m, k, n) if decode
                    else rows_contraction_work(m, k, n, cf_planes.planes),
                    "lut": exact_contraction_work(m, k, n)}
            rate = {"closed_form": INT32_OPS_PER_S if decode else INT8_TC_OPS_PER_S,
                    "lut": INT8_TC_OPS_PER_S}
            bounds = {kind: bound_ms(*work[kind], rate[kind])[0] for kind in work}
            if not decode:  # what the rows design must reach at this shape
                require(ms["closed_form_tile"] >= 20 * ms["closed_form_rows"]
                        and bounds["closed_form"] >= 0.1 * ms["closed_form_rows"]
                        and ms["lut_rows"] <= ms["int_mm"],
                        f"rows designs at ({m} x {k}) @ ({k} x {n}): {ms}, "
                        f"bounds {bounds}")
            shape_rows[(m, site)] = {"k": k, "n": n, "per_layer_step": per_step,
                                     "ms": ms, "work": work, "rate": rate,
                                     "err": err}
            emit("lm_kernel_shapes", m=m, site=site, shape=[1, m, k, n],
                 operands="int8 codes", max_abs_err=err, tolerance=0, ms=ms,
                 int_mm_rows=a2.shape[0], bound_ms=bounds,
                 rows_planes=None if decode else cf_planes.planes)
            del x, w, qa, qb, a32, b32, cf_plain, lut_plain, a2, b2
    torch.cuda.empty_cache()

    # -- lm_lut_kernel_path: the kernel="lut" substrate (the product table
    # instead of the closed form; not reachable from a spec string, so not
    # from ServingEngine) at the dense shapes of one decode layer-step, its
    # outputs bit for bit those of the closed-form substrate
    lut_sub = sub.CudaSubstrate("proposed@8", kernel="lut")
    cf_sub = sub.get_substrate("approx_cuda:proposed@8")
    cspec = sub.ContractionSpec.matmul(quant=mcommon._DENSE_QUANT)
    lut_same = True
    reset()
    for site, (k, n, per_step) in LM_SHAPES.items():
        x = torch.randn((LM_BATCH, 1, k), generator=gen, device=dev).to(cfg.dtype)
        w = (torch.randn((k, n), generator=gen, device=dev) / k ** 0.5).to(cfg.dtype)
        for _ in range(per_step):
            got = lut_sub.dot_general(x, w, cspec)
            lut_same &= torch.equal(got.view(torch.int16),
                                    cf_sub.dot_general(x, w, cspec).view(torch.int16))
    c_lut = counts()
    require(c_lut == only(lut_decode=7, closed_form_decode=7),
            f"kernel='lut' layer-step launches {c_lut}")
    require(lut_same, "the kernel='lut' substrate differs from the closed form")
    emit("lm_lut_kernel_path", substrate="CudaSubstrate('proposed@8', kernel='lut')",
         entry_point="CudaSubstrate.dot_general", batch=LM_BATCH, dense_calls=7,
         launches=c_lut, bit_identical_to="approx_cuda:proposed@8",
         bit_identical=lut_same)
    del x, w, got

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
    # M = 8 steps: only decode launches, 7 per layer-step, no tile launch
    require(c2 == only(closed_form_decode=7 * LM_LAYERS * steps),
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
         launches_expected="7 decode launches x layers x decode steps",
         first_wave_identical=same, card=card)

    # -- lm_planned_path: layer 0 on the exact table, FFNs at csp_axc1@6
    reqs_p, cp, rp = serve(LM_PLAN, range(LM_REQUESTS), 2)
    sp = rp["decode_steps"]
    require(cp == only(closed_form_decode=7 * (LM_LAYERS - 1) * sp,
                       lut_tensor=7 * sp),
            f"lm planned launches {cp} over {sp} steps")
    # one prefill of 4 x 64 tokens under the plan through the prefill entry
    # point (ServingEngine prefills through decode_step): M = 256 on both
    # rows designs, the logits bit for bit those of the table substrate's plan
    def planned(plan):
        return reg.build_bundle(dataclasses.replace(
            bundle.cfg, dot_plan=plan_mod.as_plan(plan)))

    pbundle = planned(LM_PLAN)
    toks = torch.from_numpy(rng.integers(1, vocab, LM_PREFILL)).to(dev)
    reset()
    (logits_pf, prefill_ms) = timed_once(
        lambda: pbundle.prefill(params, {"tokens": toks}))
    cpf = counts()
    require(cpf == only(closed_form_rows=7 * (LM_LAYERS - 1), lut_rows=7),
            f"planned prefill {cpf}")
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
        reset()
        a = step_logits(kern)
        c_step = counts()
        b, plain_ms = timed_once(lambda: step_logits(plain))
        same = bool(torch.isfinite(a).all()) and torch.equal(
            a.view(torch.int32), b.view(torch.int32))
        name = kern if isinstance(kern, str) else "lm_plan"
        identity[name] = {"against": plain if isinstance(plain, str)
                          else "lm_plan on approx_bitexact / approx_lut",
                          "bit_identical": same, "launches": c_step,
                          "plain_step_ms": plain_ms}
        require(same, f"lm logits {name} differ from {identity[name]['against']}")
        require(c_step["closed_form_tile"] == c_step["lut_tile"] == 0
                and c_step["closed_form_decode"] + c_step["lut_tensor"]
                == 7 * LM_LAYERS, f"lm_bit_identity {name} launches {c_step}")
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
    reset()
    with tracing_scope(tracer), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(treqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_steps = eng.metrics.batches_flushed
    c_trace = counts()
    require(c_trace == only(closed_form_decode=7 * LM_LAYERS * n_steps),
            f"lm trace launches {c_trace} over {n_steps} steps")
    trace_path = out_dir / "chip_smoke_lm_trace.json"
    prof.export_chrome_trace(str(trace_path))
    emit_trace("lm_trace", trace_path, {"wall_s": wall, "decode_steps": n_steps,
                                        "launches": c_trace}, tracer)
    busy_us, by_name = device_busy(trace_path)
    # the host's kernel launches in the traced steps (runtime API calls)
    host_launches = sum(
        1 for e in json.loads(trace_path.read_text()).get("traceEvents", [])
        if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
        and e.get("name", "").startswith("cudaLaunchKernel"))
    split = device_ms_by_span(prof, LM_SPANS)
    for label, markers in LM_KERNELS_BY_NAME.items():
        split[label] = sum(v for name, v in by_name.items()
                           if any(mk in name for mk in markers)) / 1e3
    emit("lm_trace_split", decode_steps=n_steps,
         device_ms_per_step={k: v / n_steps for k, v in split.items()},
         device_busy_ms_per_step=busy_us / 1e3 / n_steps,
         unattributed_ms_per_step=(busy_us / 1e3 - sum(split.values())) / n_steps,
         wall_ms_per_step=1e3 * wall / n_steps,
         kernel_launches_per_step=host_launches / n_steps,
         dense_calls_per_step=7 * LM_LAYERS,
         spans={"kernel.*": "the contraction wrappers' own torch ops (the "
                            "int32 casts of the designs that take int32)",
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
    require(cdec == only(closed_form_decode=7 * cfg.n_layers * 2),
            f"full-depth decode launches {cdec}")
    require(cfull == only(closed_form_rows=7 * cfg.n_layers),
            f"full-depth prefill launches {cfull}")
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

    train = lm_train_phases(dev, card, out_dir, counters, only)

    # rows of the kernels line: each design of each kernel at each LM shape
    # it runs. M = 8 rows count ServingEngine's launches (the main path;
    # kernel="lut" rows CudaSubstrate.dot_general's), where the tile
    # designs must show 0; M = 256 rows count lm_train_path's (TrainLoop),
    # where the tile designs must show 0, beside the prefill entry point's,
    # which the engine does not call (it prefills token by token)
    kinds = {"closed_form": ("closed_form_matmul", "src/repro_torch/csrc/approx_matmul.cu",
                             "src/repro/kernels/approx_matmul/kernel.py:59",
                             "proposed@8", "closed_form"),
             "lut": ("lut_matmul", "src/repro_torch/csrc/lut_matmul.cu",
                     "src/repro/kernels/lut_matmul/kernel.py:74", "exact", "lut"),
             "lut_kernel": ("lut_matmul", "src/repro_torch/csrc/lut_matmul.cu",
                            "src/repro/kernels/lut_matmul/kernel.py:74",
                            "proposed@8", "closed_form")}
    m_pf = LM_PREFILL[0] * LM_PREFILL[1]
    served, trained, lut_entry = ("ServingEngine.generate", "TrainLoop.run",
                                  "CudaSubstrate.dot_general")
    # (kind, design, M) -> (key of ms/err, launches, phase, entry point)
    designs = {
        ("closed_form", "decode", LM_BATCH): ("closed_form_decode",
            c2["closed_form_decode"], "lm_serving_path", served),
        ("closed_form", "tile", LM_BATCH): ("closed_form_tile",
            c2["closed_form_tile"], "lm_serving_path (must be 0)", served),
        ("closed_form", "rows", m_pf): ("closed_form_rows",
            train["closed_form_rows"], "lm_train_path", trained),
        ("closed_form", "tile", m_pf): ("closed_form_tile",
            train["closed_form_tile"], "lm_train_path (must be 0)", trained),
        ("lut", "tensor", LM_BATCH): ("lut_tensor", cp["lut_tensor"],
                                      "lm_planned_path", served),
        ("lut", "tile", LM_BATCH): ("lut_tile", cp["lut_tile"],
                                    "lm_planned_path (must be 0)", served),
        ("lut", "rows", m_pf): ("lut_rows", train["lut_rows"],
                                "lm_train_path", trained),
        ("lut", "tile", m_pf): ("lut_tile", train["lut_tile"],
                                "lm_train_path (must be 0)", trained),
        ("lut_kernel", "decode", LM_BATCH): ("lut_decode", c_lut["lut_decode"],
                                             "lm_lut_kernel_path", lut_entry)}
    rows, work = [], {}
    for (m, site), r in shape_rows.items():
        for (kind, design, dm), (key_, n_launch, where, entry) in designs.items():
            if dm != m:
                continue
            name, source, tpu, mult_key, work_kind = kinds[kind]
            b_ms, by = bound_ms(*r["work"][work_kind], r["rate"][work_kind])
            row_name = f"{name}[{design},{site},M={m}]"
            if kind == "lut_kernel":
                row_name = f"{name}[{design},{site},M={m},proposed@8]"
            rows.append({"name": row_name, "route": "cuda", "source": source,
                         "replaces": tpu, "launches": n_launch,
                         "max_abs_err": r["err"][key_], "ms": r["ms"][key_],
                         "plain_ms": r["ms"][f"{key_}_plain"],
                         "bound_ms": b_ms, "bound_by": by,
                         "library_ms": r["ms"]["int_mm"] if kind == "lut" else None,
                         "shape": [1, m, r["k"], r["n"]], "mult": mult_key,
                         "design": design, "launches_on": where,
                         "entry_point": entry, "off_path": "must be 0" in where,
                         "launches_per_layer_step_at_shape": r["per_layer_step"]})
            if m == m_pf:  # the same shape on bundle.prefill
                rows[-1]["launches_bundle_prefill"] = cpf[key_]
            work[row_name] = r["work"][work_kind]
    return rows, work


def contraction_counters() -> dict:
    """The contraction kernels' launch counters by kind and design (each
    wrapper counts its launches, by shape too)."""
    from repro_torch.kernels.approx_matmul.ops import closed_form_matmul
    from repro_torch.kernels.lut_matmul.ops import lut_matmul

    return {"closed_form_tile": closed_form_matmul.launches,
            "closed_form_narrow": closed_form_matmul.narrow_launches,
            "closed_form_decode": closed_form_matmul.decode_launches,
            "closed_form_rows": closed_form_matmul.rows_launches,
            "lut_tile": lut_matmul.launches,
            "lut_narrow": lut_matmul.narrow_launches,
            "lut_decode": lut_matmul.decode_launches,
            "lut_tensor": lut_matmul.tensor_launches,
            "lut_rows": lut_matmul.rows_launches}


def count_launches(counters: dict, fn):
    """(fn(), launches by design, launches by design and shape
    ``"BxMxKxN"``): the counts set to 0 just before and read just after."""
    for c in counters.values():
        c.reset()
    out = fn()
    torch.cuda.synchronize()
    return out, {name: c.value for name, c in counters.items()}, {
        name: {"x".join(map(str, sh)): v for sh, v in c.by_shape().items()}
        for name, c in counters.items() if c.value}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shape, dtype and bytes."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                            b.reshape(-1).contiguous().view(torch.uint8)))


def lm_train_phases(dev, card: str, out_dir: Path, counters: dict, only) -> dict:
    """The training path: minitron-8b at its published widths, depth cut to
    LM_LAYERS, through TrainLoop on the card (phase lm_train_path), then a
    crash and restart at a reduced size with the launchers (phase
    lm_train_restart). Returns the launches of lm_train_path by design."""
    import shutil

    from repro_torch.models import convert
    from repro_torch.models import registry as reg
    from repro_torch.optim import adamw
    from torch.profiler import ProfilerActivity, profile

    work_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(work_dir, ignore_errors=True)
    full = reg.get_config(LM_ARCH)
    bundle = reg.get_bundle(LM_ARCH, n_layers=LM_LAYERS)
    batch, seq = TRAIN_BATCH

    def train(plan, steps: int) -> tuple:
        return train_run(bundle, adamw(), plan, steps, dev, counters,
                         work_dir / "unused")

    # -- lm_train_path: each plan on the kernels, then on the table
    # substrate (plain torch gathers, the same integers): the losses and
    # every updated parameter bit for bit
    reduced = {"n_layers": [LM_LAYERS, full.n_layers]}
    cases = {}
    launches = {name: 0 for name in counters}
    for name, kern, plain, expect in (
            ("approx_cuda:proposed@8", "approx_cuda:proposed@8",
             "approx_lut:proposed@8", only(closed_form_rows=2 * 7 * LM_LAYERS)),
            ("lm_plan", LM_PLAN, LM_PLAN_TABLE,
             only(closed_form_rows=2 * 7 * (LM_LAYERS - 1), lut_rows=2 * 7))):
        p_kern, r_kern = train(kern, TRAIN_STEPS)
        require(all(c == expect for c in r_kern["launches_per_step"]),
                f"lm_train_path {name}: launches per step "
                f"{r_kern['launches_per_step']}, expected {expect}")
        for c in r_kern["launches_per_step"]:
            for k, v in c.items():
                launches[k] += v
        kern_params = {k: t.detach().cpu() for k, t in
                       convert.named_leaves(p_kern).items()}
        del p_kern
        torch.cuda.empty_cache()
        p_plain, r_plain = train(plain, TRAIN_STEPS)
        require(all(c == only() for c in r_plain["launches_per_step"]),
                f"the table substrate launched {r_plain['launches_per_step']}")
        plain_params = convert.named_leaves(p_plain)
        same_loss = r_kern["loss_per_step"] == r_plain["loss_per_step"]
        differ = [k for k, t in kern_params.items()
                  if not same_bits(t, plain_params[k].cpu())]
        del p_plain, plain_params, kern_params
        torch.cuda.empty_cache()
        require(same_loss and not differ,
                f"lm_train_path {name}: losses {r_kern['loss_per_step']} vs "
                f"{r_plain['loss_per_step']}, params that differ: {differ[:8]}")
        cases[name] = {"plan": kern, "kernels": r_kern, "against": plain,
                       "plain": {k: r_plain[k] for k in
                                 ("loss_per_step", "step_ms", "peak_memory_gb")},
                       "losses_bit_identical": same_loss,
                       "params_bit_identical": not differ}
    emit("lm_train_path", arch=LM_ARCH, reduced=reduced, params=bundle.cfg.param_count(),
         widths={"d_model": full.d_model, "n_heads": full.n_heads,
                 "n_kv_heads": full.n_kv_heads, "d_ff": full.d_ff,
                 "vocab": full.vocab},
         entry_point="TrainLoop.run", batch=batch, seq_len=seq, rows_m=batch * seq,
         steps=TRAIN_STEPS, optimizer="adamw", lr=TRAIN_LR, qat="bitexact",
         remat=bundle.cfg.remat,
         launches_expected="per step: 7 per layer in the forward + 7 in the "
                           "recompute of the backward (remat); rows designs only",
         cases=cases, launches=launches, card=card)

    # one more step under torch.profiler: where a training step's device
    # time goes (its launches are not counted in `launches`)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p_tr, r_tr = train("approx_cuda:proposed@8", 1)
        wall = time.perf_counter() - t0
    del p_tr
    torch.cuda.empty_cache()
    trace_path = out_dir / "chip_smoke_train_trace.json"
    prof.export_chrome_trace(str(trace_path))
    busy_us, by_name = device_busy(trace_path)
    step_ms = r_tr["step_ms"][0]
    kernel_ms = sum(v for k, v in by_name.items() if "matmul_kernel" in k) / 1e3
    rows_ms = sum(v for k, v in by_name.items() if "rows_matmul_kernel" in k) / 1e3
    emit("lm_train_trace", trace=str(trace_path.relative_to(out_dir.parent)),
         plan="approx_cuda:proposed@8", steps=1,
         wall_s_with_init=wall, step_ms=step_ms,
         device_busy_ms=busy_us / 1e3,
         device_ms_by_name={k: v / 1e3 for k, v in sorted(
             by_name.items(), key=lambda kv: -kv[1])[:12]},
         contraction_kernels_ms=kernel_ms, rows_kernels_ms=rows_ms,
         launches=r_tr["launches_per_step"][0], card=card)

    # -- lm_train_restart: crash -> restart bitwise at a reduced size
    r = crash_restart_and_serve(LM_ARCH, RESTART_SIZE, lambda _: adamw(), dev,
                                work_dir)
    try:
        r["run"]("b", plan="approx_cuda:proposed@8")
        conflict = None
    except ValueError as e:
        conflict = str(e)
    require(conflict is not None and "plan" in conflict,
            "a conflicting plan was not refused")
    shutil.rmtree(work_dir, ignore_errors=True)
    emit("lm_train_restart", arch=LM_ARCH,
         reduced={k: [v, getattr(full, k)] for k, v in RESTART_SIZE.items()},
         conflicting_plan_refused=conflict, card=card, **r["record"])
    del r
    torch.cuda.empty_cache()
    return launches


def crash_restart_and_serve(arch: str, size: dict, make_optimizer, dev,
                            work_dir: Path) -> dict:
    """``arch`` at ``size`` under LM_PLAN with QAT: 12 TrainLoop steps
    uninterrupted, and a run crashed at step 10 then restarted with neither
    plan nor policy configured (both adopted from the step-8 checkpoint)
    must end bit for bit the same, parameters and optimizer state; then the
    training launcher's ``--qat-out`` bundle holds the trained parameters
    and ``launch/serve.py --plan`` serves it. Returns ``{"run": the loop
    factory (name, fail_at, plan, qat) → (loop, params, state, start,
    stream), "record": the readings}``."""
    from repro_torch.checkpoint import load_plan_bundle, unflatten_into
    from repro_torch.data import SyntheticLMStream
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import convert
    from repro_torch.models import registry as reg
    from repro_torch.nn import plan as plan_mod
    from repro_torch.train import QATPolicy, TrainLoop, TrainLoopConfig

    rcfg = reg.get_config(arch, **size)
    rbundle = reg.build_bundle(rcfg)
    batch, seq = TRAIN_BATCH
    rsteps, every, fail = 12, 4, 10

    def run(name: str, fail_at=None, plan=LM_PLAN, qat=True):
        loop = TrainLoop(rbundle.loss_fn, make_optimizer(rbundle), TrainLoopConfig(
            total_steps=rsteps, ckpt_every=every, ckpt_dir=str(work_dir / name),
            lr=1e-3, fail_at_step=fail_at, qat=QATPolicy() if qat else None,
            plan=None if plan is None else plan_mod.as_plan(plan)),
            layout=rbundle.layout)
        params, opt_state, start = loop.init_or_restore(
            lambda: rbundle.init_params(torch.Generator(dev).manual_seed(0), dev))
        stream = SyntheticLMStream(vocab=rcfg.vocab, batch=batch, seq_len=seq, seed=0)
        return loop, params, opt_state, start, stream

    loop_a, pa, oa, sa, stream_a = run("a")
    loop_a.run(pa, oa, stream_a, sa)
    loop_b, pb, ob, sb, stream_b = run("b", fail_at=fail)
    try:
        loop_b.run(pb, ob, stream_b, sb)
        crashed = None
    except RuntimeError as e:
        crashed = str(e)
    require(crashed == f"injected failure at step {fail}", f"crash: {crashed}")
    del pb, ob
    # the restart configures neither plan nor policy: both are adopted
    loop_c, pc, oc, sc, stream_c = run("b", plan=None, qat=False)
    adopted = (loop_c.cfg.plan == plan_mod.as_plan(LM_PLAN)
               and loop_c.cfg.qat == QATPolicy())
    require(sc == 8 and loop_c.metrics["resumed_from"] == 8 and adopted,
            f"restart from {sc}, adopted plan {loop_c.cfg.plan}")
    loop_c.run(pc, oc, stream_c, sc)
    la, lc = convert.named_leaves(pa), convert.named_leaves(pc)
    restart_same = (all(same_bits(la[k], lc[k]) for k in la)
                    and same_bits(oa["step"], oc["step"])
                    and set(oa["mv"]) == set(oc["mv"])
                    and all(same_bits(oa["mv"][k][s], oc["mv"][k][s])
                            for k in oa["mv"] for s in oa["mv"][k]))
    require(restart_same, "restarted run differs from the uninterrupted one")
    del pa, oa, pc, oc
    # the launchers: --qat-out writes a bundle, serve --plan DIR serves it
    flags = ["--arch", arch, "--device", "cuda"] + [
        a for k, v in size.items() for a in (f"--{k.replace('_', '-')}", str(v))]
    bundle_dir = work_dir / "bundle"
    _, trained = launch_train.main(flags + [
        "--steps", "4", "--batch", str(batch), "--seq-len", str(seq),
        "--ckpt-dir", str(work_dir / "launcher"), "--ckpt-every", "2",
        "--qat", "--dot-plan", json.dumps(LM_PLAN), "--qat-out", str(bundle_dir)])
    plan_b, flat_b, _ = load_plan_bundle(str(bundle_dir))
    shipped = rbundle.layout.from_tree(unflatten_into(rbundle.layout.to_tree(
        {k: t.to("meta") for k, t in convert.named_leaves(trained).items()}),
        flat_b, "cpu"))
    bundle_same = plan_b == plan_mod.as_plan(LM_PLAN) and all(
        same_bits(t.cpu(), shipped[k]) for k, t in convert.named_leaves(trained).items())
    require(bundle_same, "the bundle differs from the trained params")
    del trained
    served = launch_serve.main(flags + ["--plan", str(bundle_dir), "--requests", "4",
                                        "--batch", "4", "--max-tokens", "4"])
    require(len(served) == 4 and all(r.done and len(r.output) == 4 for r in served),
            "serving from the bundle")
    return {"run": run, "record": {
        "steps": rsteps, "ckpt_every": every, "fail_at_step": fail,
        "crashed": crashed, "resumed_from": loop_c.metrics["resumed_from"],
        "adopted_plan_and_policy": adopted,
        "params_and_optimizer_state_bit_identical": restart_same,
        "bundle": {"arrays": len(flat_b), "plan": plan_b.to_dict(),
                   "params_bit_identical": bundle_same,
                   "served_requests": len(served)},
        "losses_uninterrupted": loop_a.metrics["losses"],
        "losses_restarted": loop_c.metrics["losses"]}}


def edge_qat_phase(dev, tiles: list, planned_maps: list, counters: dict) -> dict:
    """finetune_edge on the 512x512 test images under the edge plan: at init
    the QAT model's maps equal the served planned maps byte for byte, and
    the forward runs only the narrow designs of the contraction kernels.
    Returns the launches by counter name."""
    from repro_torch.train import qat

    imgs = torch.from_numpy(np.stack(tiles)).to(dev)
    for c in counters.values():
        c.reset()
    init_maps = qat.edge_maps(qat.init_edge_params(dev), imgs, PLAN).cpu().numpy()
    require(np.array_equal(init_maps, np.stack(planned_maps)),
            "edge QAT maps at init differ from the served planned maps")
    t0 = time.perf_counter()
    res = qat.finetune_edge(imgs, PLAN, steps=EDGE_QAT_STEPS, lr=0.1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.value for k, c in counters.items()}
    narrow = ("closed_form_matmul_narrow", "lut_matmul_narrow")
    require(all(launches[k] > 0 for k in narrow)
            and all(v == 0 for k, v in launches.items() if k not in narrow),
            f"edge QAT launches {launches}")
    require(all(np.isfinite(res["losses"])) and res["psnr_post"] >= res["psnr_pre"],
            f"edge QAT: psnr {res['psnr_pre']} -> {res['psnr_post']}")
    # the card trains: the calibration alone can meet the PSNR check above,
    # so a few uncalibrated steps (from the Laplacian, far from the optimum)
    # run on the card and on the CPU must agree and lower the loss. The
    # forward's integer sums are exact on both; each gradient is a float32
    # mean over 4.2 M products with cancellation, summed in another order
    # on the card, and Adam's later steps follow the gradients' ratios, so
    # the params agree to EDGE_QAT_PARAM_ATOL, not to the 1e-6 that 1152
    # pixels give in tests/test_torch_qat.py. A wrong backward moves them
    # by a step (lr = 0.1) or more.
    steps = EDGE_QAT_CHECK_STEPS
    on_card = qat.finetune_edge(imgs, PLAN, steps=steps, lr=0.1, calibrate=False)
    on_cpu = qat.finetune_edge(imgs.cpu(), PLAN, steps=steps, lr=0.1, calibrate=False)
    param_err = {k: float((on_card["params"][k].cpu() - v).abs().max())
                 for k, v in on_cpu["params"].items()}
    require(np.allclose(on_card["losses"], on_cpu["losses"], rtol=1e-6, atol=0)
            and max(param_err.values()) <= EDGE_QAT_PARAM_ATOL
            and on_card["losses"][-1] < on_card["losses"][0],
            f"uncalibrated edge QAT: card losses {on_card['losses']}, CPU losses "
            f"{on_cpu['losses']}, params differ by {param_err}")
    emit("edge_qat_path", plan=PLAN, images=len(tiles), shape=list(imgs.shape),
         steps=EDGE_QAT_STEPS, lr=0.1, init_maps_byte_identical_to_served=True,
         psnr_pre_db=res["psnr_pre"], psnr_post_db=res["psnr_post"],
         loss_first=res["losses"][0], loss_min=min(res["losses"]),
         loss_last=res["losses"][-1], wall_s=wall,
         params={k: v.cpu().reshape(-1).tolist() for k, v in res["params"].items()},
         launches=launches,
         uncalibrated_card_vs_cpu={"steps": steps, "losses_card": on_card["losses"],
                                   "losses_cpu": on_cpu["losses"],
                                   "max_abs_param_diff": param_err,
                                   "tolerance": {"loss_rtol": 1e-6,
                                                 "param_atol": EDGE_QAT_PARAM_ATOL}})
    return launches


def tools_phases(dev, card: str, tiles: list, out_dir: Path) -> dict:
    """The paper's tables, the contraction meter and the plan autotuner on
    the card (phases paper_tables, meter_path, autotune_edge_path,
    autotune_lm_path). Returns the contraction kernels' launches on each
    phase's path by design and shape (``"BxMxKxN"``), for the kernels
    line."""
    import contextlib
    import dataclasses
    import io
    import shutil

    from repro_torch.core import energy, metrics
    from repro_torch.core import multiplier as mult
    from repro_torch.data import image_batch
    from repro_torch.launch import autotune as at
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import registry as reg
    from repro_torch.nn import plan as plan_mod
    from repro_torch.obs.meter import (ContractionMeter, pdp_per_mac_fj,
                                       telemetry_scope)
    from repro_torch.serving import EdgeDetectService

    counters = contraction_counters()

    def counted(fn):
        return count_launches(counters, fn)

    log = io.StringIO()  # the searches' and the launcher's own prints
    shapes = {}

    # -- paper_tables: Table 4 on the card, every field equal to the CPU's;
    # Table 5 and the headline savings (not a gate)
    t0 = time.perf_counter()
    reports = {}
    for name in mult.default_width_names():
        fn = mult.ALL_MULTIPLIERS[name]
        got = dataclasses.asdict(metrics.evaluate(fn, name, device=dev))
        want = dataclasses.asdict(metrics.evaluate(fn, name, device="cpu"))
        require(got == want, f"Table 4 {name}: card {got} vs CPU {want}")
        reports[name] = {k: got[k] for k in ("er", "nmed", "mred", "max_ed")}
    sav = energy.savings_vs("proposed", "design_du2022")
    emit("paper_tables", seconds=time.perf_counter() - t0,
         table4=reports, equal_to_cpu=True, table5=energy.table5(),
         proposed_vs_du2022={"pdp_pct": sav["pdp"], "power_pct": sav["power"],
                             "paper_pdp_pct": 29.21, "paper_power_pct": 14.39})

    # -- meter_path: the 512x512 set served under PLAN with the probing
    # meter installed; batches flushed in order on the calling thread
    # (start=False), so the probe draws its rows in the same order as the
    # same service on the CPU
    imgs = np.stack(tiles)
    n, h, w = imgs.shape

    def serve(device, meter):
        with EdgeDetectService(PLAN, device=device, max_batch_size=8,
                               start=False) as svc, telemetry_scope(meter):
            return svc.detect(list(imgs), timeout=300.0)

    def timed(meter_fn):
        """(maps, (launches by design, by shape), meter, wall s of 3
        passes): each pass on a fresh meter, the last one kept; the first
        un-metered pass is a warm-up."""
        walls = []
        for _ in range(3):
            meter_ = meter_fn()
            t0 = time.perf_counter()
            maps_, *counts_ = counted(lambda: serve(dev, meter_))
            walls.append(time.perf_counter() - t0)
        return maps_, counts_, meter_, walls

    serve(dev, None)  # warm-up
    bare, bare_counts, _, bare_s = timed(lambda: None)
    _, count_counts, counting, count_s = timed(ContractionMeter)
    metered, metered_counts, meter, probe_s = timed(
        lambda: ContractionMeter(error_probe=True))
    require(all(np.array_equal(a, b) for a, b in zip(bare, metered)),
            "metered maps differ from the un-metered run")
    require(bare_counts == metered_counts == count_counts
            and bare_counts[0]["closed_form_narrow"] > 0
            and bare_counts[0]["lut_narrow"] > 0,
            f"meter_path launches {bare_counts} / {metered_counts}")
    metered_counts, shapes["meter_path"] = metered_counts
    sites = meter.site_summary()
    want_macs = {"conv.edge.center": n * h * w, "conv.edge.ring": n * h * w * 8}
    require({s: sites[s]["macs"] for s in want_macs} == want_macs == {
        "conv.edge.center": 4_194_304, "conv.edge.ring": 33_554_432},
        f"meter_path MACs {sites}")
    for site, spec in ((s, plan_mod.as_plan(PLAN).resolve(s)) for s in want_macs):
        price = pdp_per_mac_fj(spec.split(":", 1)[1])
        e = sites[site]["energy_pdp_fj"]
        require(abs(e - want_macs[site] * price) <= 1e-12 * e,
                f"{site}: energy {e} vs MACs x {price}")
    require(counting.site_summary() == sites, "probe changed the counts")
    cpu = ContractionMeter(error_probe=True)
    serve("cpu", cpu)
    require(meter.probe_moments() == cpu.probe_moments()
            and meter.registry.to_json() == cpu.registry.to_json(),
            f"probe moments card {meter.probe_moments()} vs CPU "
            f"{cpu.probe_moments()}")
    emit("meter_path", plan=PLAN, images=[n, h, w], sites=sites,
         probe_moments=meter.probe_moments(), equal_to_cpu=True,
         byte_identical_to_unmetered=True, launches=metered_counts,
         launches_by_shape=shapes["meter_path"],
         wall_s={"unmetered": bare_s, "metered": count_s,
                 "metered_with_probe": probe_s})

    # -- autotune_edge_path: the search on the 512x512 set with an
    # approx_cuda baseline (the narrow designs meter and validate it)
    t0 = time.perf_counter()
    res, e_counts, shapes["autotune_edge_path"] = counted(lambda: at.autotune_edge(
        imgs, baseline="approx_cuda:proposed@8", device=dev))
    e_s = time.perf_counter() - t0
    base, tuned = res["baseline"], res["tuned"]
    require(tuned["psnr_db"] >= base["psnr_db"] or res["rolled_back"],
            f"autotune_edge validation {tuned} vs {base}")
    require(tuned["pdp_fj"] <= base["pdp_fj"], f"tuned pdp {tuned} vs {base}")
    require(e_counts["closed_form_narrow"] > 0
            and e_counts["closed_form_tile"] == e_counts["lut_tile"] == 0
            and e_counts["closed_form_rows"] == e_counts["lut_rows"] == 0,
            f"autotune_edge launches {e_counts}")
    # the tuned plan on the kernels, rewritten here (not by the program)
    plan = res["plan"]
    on_kernels = plan_mod.SubstratePlan.from_dict(json.loads(json.dumps(
        plan.to_dict()).replace("approx_bitexact:", "approx_cuda:")))
    with EdgeDetectService(plan, max_batch_size=8) as a, \
            EdgeDetectService(on_kernels, max_batch_size=8) as b:
        maps_a = a.detect(list(imgs), timeout=300.0)
        maps_b = b.detect(list(imgs), timeout=300.0)
    require(all(np.array_equal(u, v) for u, v in zip(maps_a, maps_b)),
            "the tuned plan on approx_cuda serves other maps")
    small = image_batch(6, 64, 64)
    t0 = time.perf_counter()
    q_card = at.autotune_edge(small, qat_steps=3, device=dev)
    q_cpu = at.autotune_edge(small, qat_steps=3, device="cpu")
    q_s = time.perf_counter() - t0
    require(q_card["plan"] == q_cpu["plan"],
            f"qat search: card {q_card['plan']} vs CPU {q_cpu['plan']}")
    require(abs(q_card["qat"]["psnr_post"] - q_cpu["qat"]["psnr_post"]) <= 0.05,
            f"qat psnr_post card {q_card['qat']} vs CPU {q_cpu['qat']}")
    emit("autotune_edge_path", images=[n, h, w], seconds=e_s,
         site_macs=res["site_macs"], candidates=res["candidates"],
         baseline=base, tuned=tuned, rolled_back=res["rolled_back"],
         accepted_moves=len(res["history"]) - 1, launches=e_counts,
         launches_by_shape=shapes["autotune_edge_path"],
         served_on_approx_cuda_byte_identical=True,
         qat_search={"images": [6, 64, 64], "steps": 3, "seconds": q_s,
                     "plan": q_card["plan"].to_dict(), "card": q_card["qat"],
                     "cpu": q_cpu["qat"]})

    # -- autotune_lm_path: minitron-8b at its published widths, depth cut to
    # 4; first through the CLI at repro's budget (its bundle then served by
    # the launcher), then at a budget taken from the scored divergence of
    # the move layer.3.* -> approx_cuda:proposed@8
    layers = 4
    bundle_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_autotune"
    macs_per_prefill = layers * 32 * (2 * 4096 * 4096 + 2 * 4096 * 1024
                                      + 3 * 4096 * 16384)
    require(macs_per_prefill == 31_138_512_896, "MACs per prefill")
    cand = "approx_cuda:proposed@8"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        first, l1, _ = counted(lambda: at.main([
            "--workload", "lm", "--arch", LM_ARCH, "--n-layers", str(layers),
            "--candidates", f"int8,{cand}", "--out", str(bundle_dir)]))
    first_s = time.perf_counter() - t0
    # the first scoring pass: the single move on the last layer
    cfg = reg.get_config(LM_ARCH, n_layers=layers)
    tokens = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, size=(2, 16))).to(dev)}

    def prefill(plan_):
        with torch.no_grad():
            return reg.get_bundle(LM_ARCH, n_layers=layers, dot_plan=plan_
                                  ).prefill(first["params"], tokens)

    exact_logits = prefill("exact").float()
    move = at.with_rule(plan_mod.SubstratePlan.uniform("exact"),
                        f"layer.{layers - 1}.*", cand)
    scored = float((prefill(at.stat_plan(move)).float()
                    - exact_logits).abs().max())
    budget = scored * (1 + 1e-6)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        second, l2, shapes["autotune_lm_path"] = counted(lambda: at.autotune_lm(
            LM_ARCH, overrides={"n_layers": layers},
            candidates=("int8", cand), div_budget=budget, verbose=True,
            device=dev))
    second_s = time.perf_counter() - t0
    # each search's metered baseline prefill (its site_macs)
    macs_seen = [sum(r["site_macs"].values()) for r in (first, second)]
    require(macs_seen == [macs_per_prefill] * 2,
            f"MACs of the searches' metered prefills {macs_seen}")
    require(len(second["history"]) > 1,
            f"no move accepted under the budget {budget}")

    def cuda_layers(d) -> int:
        p = plan_mod.SubstratePlan.from_dict(d)
        return sum(p.resolve(f"layer.{i}.attn.wq") == cand for i in range(layers))

    validated = second["history"][::-1][:second["rolled_back"] + 1]
    want_rows = 7 * sum(cuda_layers(s["plan"]) for s in validated)
    require(l2["closed_form_rows"] == want_rows > 0
            and l2["closed_form_decode"] == l2["closed_form_tile"] == 0
            and sum(v for k, v in l2.items() if k.startswith("lut")) == 0
            and l2["closed_form_narrow"] == 0,
            f"autotune_lm launches {l2}, want {want_rows} rows")
    # the greedy's final plan on the kernels, bit for bit the table substrate
    last = second["history"][-1]["plan"]
    on_table = plan_mod.SubstratePlan.from_dict(json.loads(json.dumps(last).replace(
        "approx_cuda:", "approx_lut:")))
    with telemetry_scope(ContractionMeter()) as meter:
        on_kernels = prefill(plan_mod.SubstratePlan.from_dict(last))
    own_macs = sum(e["macs"] for e in meter.summary().values())
    require(own_macs == macs_per_prefill, f"metered prefill MACs {own_macs}")
    require(same_bits(on_kernels, prefill(on_table)),
            "the tuned plan's prefill on approx_cuda differs from approx_lut")
    del exact_logits
    # the CLI's bundle serves through the launcher
    with contextlib.redirect_stdout(log):
        served = launch_serve.main(["--arch", LM_ARCH, "--n-layers", str(layers),
                                    "--requests", "2", "--max-tokens", "2",
                                    "--plan", str(bundle_dir)])
    require([len(r.output) for r in served] == [2, 2], "served from the bundle")
    shutil.rmtree(bundle_dir, ignore_errors=True)
    (out_dir / "chip_smoke_autotune.log").write_text(log.getvalue())
    emit("autotune_lm_path", arch=LM_ARCH, reduced={"n_layers": layers},
         batch=[2, 16], candidates=["int8", cand],
         macs_per_prefill=macs_per_prefill,
         default_budget={"div_budget": 0.25, "seconds": first_s,
                         "tuned": first["tuned"], "baseline": first["baseline"],
                         "history": first["history"], "launches": l1},
         derived_budget={"div_budget": budget, "scored_single_move": scored,
                         "seconds": second_s, "tuned": second["tuned"],
                         "baseline": second["baseline"],
                         "history": second["history"],
                         "rolled_back": second["rolled_back"], "launches": l2,
                         "launches_by_shape": shapes["autotune_lm_path"]},
         site_macs=second["site_macs"], prefill_bit_identical_to_approx_lut=True,
         bundle_served_by_launcher=True, log="chiprun_out/chip_smoke_autotune.log",
         card=card)
    del first, second
    torch.cuda.empty_cache()
    return shapes


def with_plan(bundle, spec):
    """``bundle`` rebuilt on its config under the plan ``spec``."""
    import dataclasses

    from repro_torch.models import registry as reg
    from repro_torch.nn import plan as plan_mod

    return reg.build_bundle(dataclasses.replace(
        bundle.cfg, dot_plan=plan_mod.as_plan(spec)))


def free_card() -> None:
    """Drop the last model's tensors from the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def serve_mix(bundle, params, prompts, batch: int, workers: int, max_len: int,
              spec: str, dev, counters: dict) -> tuple:
    """One ``generate()`` of ``prompts`` ((prompt, max_tokens, temperature)
    each) on a warmed ``ServingEngine`` under ``spec``: (requests, launches
    by design, by shape, readings)."""
    from repro_torch.serving import Request, ServingEngine

    eng = ServingEngine(bundle, params, batch_size=batch, max_len=max_len,
                        substrate=spec, device=dev)
    eng.generate([Request(prompt=[1, 2], max_tokens=1)])  # warm-up
    torch.cuda.synchronize()
    eng.metrics.reset()
    reqs = [Request(prompt=p, max_tokens=mt, temperature=temp)
            for p, mt, temp in prompts]
    t0 = time.perf_counter()
    _, c, by = count_launches(counters, lambda: eng.generate(reqs, workers=workers))
    wall = time.perf_counter() - t0
    st = eng.metrics.snapshot()
    vocab = bundle.cfg.vocab
    require(all(r.done and len(r.output) == r.max_tokens
                and all(0 <= t < vocab for t in r.output) for r in reqs)
            and st["requests_served"] == len(reqs)
            and st["requests_failed"] == 0, f"served {st}")
    busy, batches = eng.metrics.worker_busy_seconds, eng.metrics.worker_batches
    tokens = sum(len(r.output) for r in reqs)
    return reqs, c, by, {
        "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
        "latency_p50_ms": st["latency_p50_ms"],
        "latency_p99_ms": st["latency_p99_ms"],
        "decode_steps": eng.metrics.batches_flushed,
        "decode_step_ms_by_worker": {w: 1e3 * busy[w] / batches[w]
                                     for w in sorted(batches)}}


def family_phases(dev, card: str) -> tuple:
    """The MoE, vlm and encdec families at their published widths (phases
    moe_serving_path, moe_topk_path, vlm_path, encdec_path), each model
    freed before the next is built. Returns (rows of the kernels line for
    the MoE config's dense shapes, least work by row name)."""
    import dataclasses

    from repro_torch.kernels import blocking
    from repro_torch.kernels.approx_matmul import ops as am
    from repro_torch.kernels.approx_matmul.ops import closed_form_matmul
    from repro_torch.models import common as mcommon
    from repro_torch.models import encdec
    from repro_torch.models import registry as reg
    from repro_torch.nn import substrate as sub

    counters = contraction_counters()
    kern, table = "approx_cuda:proposed@8", "approx_lut:proposed@8"

    def counted(fn):
        return count_launches(counters, fn)

    def only(**launched) -> dict:
        return {name: launched.get(name, 0) for name in counters}

    def widths(cfg) -> dict:
        return {k: getattr(cfg, k) for k in (
            "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
            "n_experts", "top_k", "moe_interleave", "shared_expert",
            "n_patches", "n_frames")}

    def build(name, **over):
        """(bundle, params, seconds to draw them): seeded random weights on
        the card, the peak-memory count restarted."""
        free_card()
        torch.cuda.reset_peak_memory_stats()
        bundle = reg.get_bundle(name, **over)
        t0 = time.perf_counter()
        params = bundle.init_params(torch.Generator(dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        return bundle, params, time.perf_counter() - t0

    rng = np.random.default_rng(7)
    gen = torch.Generator(dev).manual_seed(3)

    def tokens(shape, vocab):
        return torch.from_numpy(rng.integers(1, vocab, shape)).to(dev)

    # -- moe_serving_path: llama4-maverick at its published widths, 2 layers
    bundle, params, init_s = build(MOE_ARCH, n_layers=MOE_LAYERS)
    cfg, full = bundle.cfg, reg.get_config(MOE_ARCH)
    require(params.layers[0].moe is None and params.layers[1].moe is not None
            and tuple(params.layers[1].moe.wi.shape) == (128, 5120, 8192),
            "maverick's unit: layer 0 dense, layer 1 MoE of 128 experts")
    n_params = sum(t.numel() for t in params.parameters())
    # the dense shapes on the decode (M = 8) and rows (M = 256) designs,
    # through the public entry point dense calls, on int8 codes as dense
    # quantizes them, each against its design's plain twin
    q = sub.QuantPolicy()
    t16 = am.closed_form_table16("proposed@8", dev)
    planes = am.rows_decomposition("proposed@8")
    shape_rows = {}
    for m in (LM_BATCH, LM_PREFILL[0] * LM_PREFILL[1]):
        decode = m <= blocking.DECODE_MAX_M
        for site, (k, n, per_step) in MOE_SHAPES.items():
            x = torch.randn((1, m, k), generator=gen, device=dev).to(cfg.dtype)
            w = (torch.randn((1, k, n), generator=gen, device=dev)
                 / k ** 0.5).to(cfg.dtype)
            qa, _ = sub._quantize_operand(x, q.x_mode, None, 2, 8, q.eps)
            qb, _ = sub._quantize_operand(w, q.w_mode, None, 1, 8, q.eps)
            design = "decode" if decode else "rows"
            plain, plain_ms = timed_once(
                (lambda: blocking.decode_matmul_plain(qa, qb, t16, 8)) if decode
                else (lambda: blocking.rows_matmul_plain(qa, qb, planes, 8)))
            got, c, _ = counted(lambda: closed_form_matmul(qa, qb, "proposed@8"))
            require(c == only(**{f"closed_form_{design}": 1}),
                    f"M = {m} at {site}: designs launched {c}")
            err = max_abs_err(got, plain)
            require(err == 0, f"{design} design at ({m} x {k}) @ ({k} x {n}): {err}")
            ms = time_ms(lambda: closed_form_matmul(qa, qb, "proposed@8"))
            work = (contraction_work(m, k, n) if decode
                    else rows_contraction_work(m, k, n, planes.planes))
            rate = INT32_OPS_PER_S if decode else INT8_TC_OPS_PER_S
            shape_rows[(design, site)] = {"m": m, "k": k, "n": n, "err": err,
                                          "ms": ms, "plain_ms": plain_ms,
                                          "work": work, "rate": rate,
                                          "per_layer_step": per_step}
            emit("moe_kernel_shapes", design=design, site=site, shape=[1, m, k, n],
                 max_abs_err=err, tolerance=0, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms(*work, rate)[0])
            del x, w, qa, qb, plain, got
    # the experts at a decode step of batch 8: capacity 1, every expert's
    # three (1 x d) products, outside the substrate (repro's einsums)
    moe = params.layers[1].moe
    buf = torch.randn((cfg.n_experts, 1, cfg.d_model), generator=gen,
                      device=dev).to(cfg.dtype)
    expert_ms = time_ms(lambda: mcommon._expert_ffn(moe, buf))
    expert_bytes = sum(t.numel() * t.element_size() for t in (moe.wi, moe.wg, moe.wo))
    # ServingEngine: 16 requests of 8 + 8 tokens, odd ones sampled
    prompts = [list(map(int, rng.integers(1, cfg.vocab, LM_PROMPT)))
               for _ in range(LM_REQUESTS)]
    spec_of = lambda order: [(prompts[i], LM_PROMPT, 0.0 if i % 2 == 0 else 0.8)
                             for i in order]
    reqs2, c2, by2, r2 = serve_mix(bundle, params, spec_of(range(LM_REQUESTS)),
                                   LM_BATCH, 2, MOE_MAX_LEN, kern, dev, counters)
    steps = r2["decode_steps"]
    require(c2 == only(closed_form_decode=7 * MOE_LAYERS * steps),
            f"moe serving launches {c2} over {steps} steps")
    order1 = list(range(0, LM_REQUESTS, 2)) + list(range(1, LM_REQUESTS, 2))
    reqs1, c1, _, r1 = serve_mix(bundle, params, spec_of(order1), LM_BATCH, 1,
                                 MOE_MAX_LEN, kern, dev, counters)
    first_wave = {i: r.output for i, r in zip(order1[:LM_BATCH], reqs1)}
    same_wave = all(first_wave[i] == reqs2[i].output for i in first_wave)
    require(same_wave, "moe first-wave greedy outputs differ between 1 and 2 workers")
    # one decode step, the kernels against the table substrate on the card
    tok = tokens((LM_BATCH, 1), cfg.vocab)

    def step_logits(b):
        st = b.init_decode_state(LM_BATCH, MOE_MAX_LEN, dev)
        return b.decode_step(params, st, {"token": tok, "cache_len": 0})[0]

    a, c_step, _ = counted(lambda: step_logits(with_plan(bundle, kern)))
    b, table_step_ms = timed_once(lambda: step_logits(with_plan(bundle, table)))
    step_same = bool(torch.isfinite(a).all()) and same_bits(a, b)
    require(step_same and c_step == only(closed_form_decode=7 * MOE_LAYERS),
            f"moe decode step vs {table}: launches {c_step}")
    # one prefill of 4 x 64 tokens: M = 256 on the rows design alone; its
    # first call timed apart (the MoE's first (E, C = 3, d) products)
    toks = tokens(LM_PREFILL, cfg.vocab)
    _, pf_first_ms = timed_once(
        lambda: with_plan(bundle, kern).prefill(params, {"tokens": toks}))
    t0 = time.perf_counter()
    (pf, pf_ms), c_pf, by_pf = counted(lambda: timed_once(
        lambda: with_plan(bundle, kern).prefill(params, {"tokens": toks})))
    pf_wall = time.perf_counter() - t0
    pf_table, pf_table_ms = timed_once(
        lambda: with_plan(bundle, table).prefill(params, {"tokens": toks}))
    pf_same = pf.shape == (LM_PREFILL[0], 1, cfg.vocab) \
        and bool(torch.isfinite(pf).all()) and same_bits(pf, pf_table)
    require(pf_same and c_pf == only(closed_form_rows=7 * MOE_LAYERS),
            f"moe prefill vs {table}: launches {c_pf}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    emit("moe_serving_path", arch=MOE_ARCH, widths=widths(full),
         reduced={"n_layers": [MOE_LAYERS, full.n_layers]},
         layers=[{"moe": layer.moe is not None} for layer in params.layers],
         params=n_params, param_count=cfg.param_count(), init_s=init_s,
         substrate=kern, batch=LM_BATCH, requests=LM_REQUESTS,
         prompt_tokens=LM_PROMPT, max_tokens=LM_PROMPT, workers_2=r2,
         workers_1=r1, launches=c2, launches_by_shape=by2,
         launches_expected="7 decode launches (4 attention + 3 FFN or shared "
                           "expert) x 2 layers x decode steps",
         first_wave_identical=same_wave,
         decode_step={"bit_identical_to": table, "bit_identical": step_same,
                      "launches": c_step, "table_substrate_ms": table_step_ms},
         prefill={"entry_point": "bundle.prefill", "tokens": list(LM_PREFILL),
                  "device_events_ms": pf_ms, "first_call_ms": pf_first_ms,
                  "wall_s": pf_wall, "launches": c_pf,
                  "launches_by_shape": by_pf, "bit_identical_to": table,
                  "bit_identical": pf_same, "table_substrate_ms": pf_table_ms},
         experts={"capacity": 1, "buf": list(buf.shape), "device_ms": expert_ms,
                  "weight_bytes": expert_bytes,
                  "bound_ms": 1e3 * expert_bytes / HBM_BYTES_PER_S},
         peak_memory_gb=peak, card=card)
    rows, work = [], {}
    for (design, site), r in shape_rows.items():
        name = f"closed_form_matmul[{design},{site},M={r['m']},{MOE_ARCH}]"
        key = (1, r["m"], r["k"], r["n"])
        by = (by2 if design == "decode" else by_pf).get(f"closed_form_{design}", {})
        b_ms, b_by = bound_ms(*r["work"], r["rate"])
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/approx_matmul.cu",
                     "replaces": "src/repro/kernels/approx_matmul/kernel.py:59",
                     "launches": by.get("x".join(map(str, key)), 0),
                     "max_abs_err": r["err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None, "shape": list(key), "mult": "proposed@8",
                     "design": design,
                     "launches_on": "moe_serving_path" + (
                         "" if design == "decode" else " (bundle.prefill)"),
                     "entry_point": "ServingEngine.generate" if design == "decode"
                     else "bundle.prefill",
                     "launches_per_layer_step_at_shape": r["per_layer_step"]})
        work[name] = r["work"]
    del params, bundle, moe, buf, a, b, pf, pf_table
    free_card()

    # -- moe_topk_path: kimi-k2 at its published widths, 1 layer (top-8 of
    # 384 experts); routing counted at every dispatch
    bundle, params, init_s = build(TOPK_ARCH, n_layers=TOPK_LAYERS)
    cfg, full = bundle.cfg, reg.get_config(TOPK_ARCH)
    routed = []
    dispatch = mcommon._dispatch_local

    def counting_dispatch(cfg_, xn, router):
        buf_, info = dispatch(cfg_, xn, router)
        keep = info[2]
        routed.append({"tokens": xn.shape[0], "choices": keep.numel(),
                       "capacity": info[3], "kept": keep.sum(),
                       "dropped": (~keep).sum()})
        return buf_, info

    toks = tokens(TOPK_PREFILL, cfg.vocab)
    steps_tok = tokens((LM_BATCH, 2), cfg.vocab)

    def run(spec):
        b_ = with_plan(bundle, spec)
        pf_ = b_.prefill(params, {"tokens": toks})
        st = b_.init_decode_state(LM_BATCH, 16, dev)
        outs = [pf_] + [b_.decode_step(params, st, {
            "token": steps_tok[:, i:i + 1], "cache_len": i})[0] for i in range(2)]
        return outs

    mcommon._dispatch_local = counting_dispatch
    try:
        got, c_k, by_k = counted(lambda: run(kern))
        run("approx_cuda:exact")  # the routing of the exact product
    finally:
        mcommon._dispatch_local = dispatch
    routing = [{k: int(v) for k, v in r_.items()} for r_ in routed]
    routing, routing_exact = routing[:3], routing[3:]
    want = run(table)
    same = all(bool(torch.isfinite(g).all()) and same_bits(g, w_)
               for g, w_ in zip(got, want))
    require(same and c_k == only(closed_form_rows=7 * TOPK_LAYERS,
                                 closed_form_decode=2 * 7 * TOPK_LAYERS),
            f"kimi-k2 vs {table}: launches {c_k}")
    require([r_["capacity"] for r_ in routing] == [2, 1, 1]
            and all(r_["kept"] + r_["dropped"] == r_["choices"] for r_ in routing),
            f"kimi-k2 routing {routing}")
    emit("moe_topk_path", arch=TOPK_ARCH, widths=widths(full),
         reduced={"n_layers": [TOPK_LAYERS, full.n_layers]},
         params=sum(t.numel() for t in params.parameters()),
         param_count=cfg.param_count(), init_s=init_s, substrate=kern,
         prefill_tokens=list(TOPK_PREFILL), decode_steps=2, batch=LM_BATCH,
         routing={"prefill": routing[0], "decode_steps": routing[1:]},
         routing_under_exact={"prefill": routing_exact[0],
                              "decode_steps": routing_exact[1:]},
         launches=c_k, launches_by_shape=by_k, bit_identical_to=table,
         bit_identical=same, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         card=card)
    del params, bundle, got, want
    free_card()

    # -- vlm_path: paligemma-3b at full depth, a prefix of 256 patches
    bundle, params, init_s = build(VLM_ARCH)
    cfg = bundle.cfg
    pe = torch.randn((VLM_PREFILL[0], cfg.n_patches, cfg.d_model), generator=gen,
                     device=dev).to(cfg.dtype)
    toks = tokens(VLM_PREFILL, cfg.vocab)
    (pf, pf_ms), c_v, by_v = counted(lambda: timed_once(lambda: with_plan(
        bundle, kern).prefill(params, {"tokens": toks, "patch_embeds": pe})))
    require(pf.shape == (VLM_PREFILL[0], 1, cfg.vocab) and bool(torch.isfinite(pf).all())
            and c_v == only(closed_form_rows=1 + 7 * cfg.n_layers),
            f"paligemma prefill launches {c_v}")
    vprompts = [(list(map(int, rng.integers(1, cfg.vocab, 8))), 4, 0.0)
                for _ in range(VLM_BATCH)]
    _, c_ve, by_ve, r_ve = serve_mix(bundle, params, vprompts, VLM_BATCH, 1, 16,
                                     kern, dev, counters)
    require(c_ve == only(closed_form_decode=7 * cfg.n_layers * r_ve["decode_steps"]),
            f"paligemma serving launches {c_ve}")
    vtok = tokens((VLM_BATCH, 1), cfg.vocab)

    def vstep(b_):
        st = b_.init_decode_state(VLM_BATCH, 16, dev)
        return b_.decode_step(params, st, {"token": vtok, "cache_len": 0})[0]

    a = vstep(with_plan(bundle, kern))
    b, vtable_ms = timed_once(lambda: vstep(with_plan(bundle, table)))
    vsame = bool(torch.isfinite(a).all()) and same_bits(a, b)
    require(vsame, f"paligemma decode step vs {table}")
    emit("vlm_path", arch=VLM_ARCH, widths=widths(cfg), layers=cfg.n_layers,
         params=sum(t.numel() for t in params.parameters()),
         param_count=cfg.param_count(), init_s=init_s, substrate=kern,
         prefill={"entry_point": "bundle.prefill", "patches": cfg.n_patches,
                  "tokens": list(VLM_PREFILL), "rows": VLM_PREFILL[0] * (
                      cfg.n_patches + VLM_PREFILL[1]),
                  "device_events_ms": pf_ms, "launches": c_v,
                  "launches_by_shape": by_v},
         serving=r_ve, serving_launches=c_ve, serving_launches_by_shape=by_ve,
         decode_step={"batch": VLM_BATCH, "bit_identical_to": table,
                      "bit_identical": vsame, "table_substrate_ms": vtable_ms},
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)
    del params, bundle, pf, pe, a, b
    free_card()

    # -- encdec_path: whisper-large-v3 at full depth; 1500 frames a sequence
    bundle, params, init_s = build(ENCDEC_ARCH)
    cfg = bundle.cfg
    frames = torch.randn((ENCDEC_PREFILL[0], cfg.n_frames, cfg.d_model),
                         generator=gen, device=dev).to(cfg.dtype)
    toks = tokens(ENCDEC_PREFILL, cfg.vocab)
    (pf, pf_ms), c_e, by_e = counted(lambda: timed_once(lambda: with_plan(
        bundle, kern).prefill(params, {"tokens": toks, "frames": frames})))
    ne, nd = cfg.n_encoder_layers, cfg.n_layers
    require(pf.shape == (ENCDEC_PREFILL[0], 1, cfg.vocab)
            and bool(torch.isfinite(pf).all())
            and c_e == only(closed_form_rows=7 * ne + 11 * nd),
            f"whisper prefill launches {c_e}")
    eprompts = [(list(map(int, rng.integers(1, cfg.vocab, 4))), 4, 0.0)
                for _ in range(ENCDEC_BATCH)]
    _, c_ee, by_ee, r_ee = serve_mix(bundle, params, eprompts, ENCDEC_BATCH, 1, 16,
                                     kern, dev, counters)
    es = r_ee["decode_steps"]
    require(c_ee == only(closed_form_decode=9 * nd * es, closed_form_rows=2 * nd * es),
            f"whisper serving launches {c_ee} over {es} steps")
    # one decode step at a cut depth against the table substrate, the
    # decoder cross-attending to random encoder states of batch 2
    cut_cfg = dataclasses.replace(cfg, n_layers=ENCDEC_IDENTITY_LAYERS)
    cut = encdec.EncDec(params.embed, [], list(params.dec[:ENCDEC_IDENTITY_LAYERS]))
    cut_bundle = reg.build_bundle(cut_cfg)
    etok = tokens((ENCDEC_PREFILL[0], 1), cfg.vocab)

    def estep(b_):
        st = b_.init_decode_state(ENCDEC_PREFILL[0], 16, dev)
        st["enc_out"] = frames
        return b_.decode_step(cut, st, {"token": etok, "cache_len": 0})[0]

    a, c_es, by_es = counted(lambda: estep(with_plan(cut_bundle, kern)))
    b, etable_ms = timed_once(lambda: estep(with_plan(cut_bundle, table)))
    esame = bool(torch.isfinite(a).all()) and same_bits(a, b)
    require(esame and c_es == only(closed_form_decode=9 * ENCDEC_IDENTITY_LAYERS,
                                   closed_form_rows=2 * ENCDEC_IDENTITY_LAYERS),
            f"whisper decode step vs {table}: launches {c_es}")
    emit("encdec_path", arch=ENCDEC_ARCH, widths=widths(cfg),
         layers={"encoder": ne, "decoder": nd},
         params=sum(t.numel() for t in params.parameters()),
         param_count=cfg.param_count(), init_s=init_s, substrate=kern,
         prefill={"entry_point": "bundle.prefill", "frames": cfg.n_frames,
                  "tokens": list(ENCDEC_PREFILL),
                  "encoder_rows": ENCDEC_PREFILL[0] * cfg.n_frames,
                  "device_events_ms": pf_ms, "launches": c_e,
                  "launches_by_shape": by_e},
         serving=r_ee, serving_launches=c_ee, serving_launches_by_shape=by_ee,
         enc_out="zeros, as repro's engine",
         decode_step={"reduced": {"n_layers": [ENCDEC_IDENTITY_LAYERS, nd]},
                      "batch": ENCDEC_PREFILL[0], "enc_out": "random frames",
                      "launches": c_es, "bit_identical_to": table,
                      "bit_identical": esame, "table_substrate_ms": etable_ms},
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)
    del params, bundle, cut, pf, frames, a, b
    free_card()
    # the other phases' launches by shape beside the row of their design
    other = {"moe_topk_path": by_k, "vlm_path (bundle.prefill)": by_v,
             "vlm_path (ServingEngine.generate)": by_ve,
             "encdec_path (bundle.prefill)": by_e,
             "encdec_path (ServingEngine.generate)": by_ee,
             "encdec_path (decode step)": by_es}
    for row in rows:
        design = f"closed_form_{row['design']}"
        row["launches_other_phases_by_shape"] = {
            phase: by[design] for phase, by in other.items() if design in by}
    return rows, work


def recurrent_phases(dev, card: str) -> tuple:
    """The recurrent families at their published widths and full depth
    (phase ``recurrent_serving_path``): xlstm-125m and zamba2-1.2b, one on
    the card at a time, under ``approx_cuda:proposed@8``. Each serves the
    LM mix at 2 workers and at 1 (decode launches only, per (K, N) as
    ``REC_SHAPES`` counts them; worker 0's first wave equal), prefills 8 ×
    64 tokens (rows launches only), and holds a decode step (logits and
    every state tensor) and a prefill bit for bit to
    ``approx_lut:proposed@8``. Its dense shapes are checked on the decode
    (M = 8) and rows (M = 512) designs against their plain twins and
    timed. Returns (rows of the kernels line, least work by row name)."""
    import dataclasses

    from repro_torch.checkpoint.ckpt import tree_leaves
    from repro_torch.kernels import blocking
    from repro_torch.kernels.approx_matmul import ops as am
    from repro_torch.kernels.approx_matmul.ops import closed_form_matmul
    from repro_torch.models import registry as reg
    from repro_torch.models import zamba
    from repro_torch.nn import substrate as sub

    counters = contraction_counters()
    kern, table = "approx_cuda:proposed@8", "approx_lut:proposed@8"
    q = sub.QuantPolicy()
    t16 = am.closed_form_table16("proposed@8", dev)
    planes = am.rows_decomposition("proposed@8")
    rng = np.random.default_rng(11)
    gen = torch.Generator(dev).manual_seed(5)
    m_prefill = REC_PREFILL[0] * REC_PREFILL[1]

    def only(**launched) -> dict:
        return {name: launched.get(name, 0) for name in counters}

    def tokens(shape, vocab):
        return torch.from_numpy(rng.integers(1, vocab, shape)).to(dev)

    def at(by: dict, m: int, k: int, n: int) -> int:
        return by.get(f"1x{m}x{k}x{n}", 0)

    rows, work, records = [], {}, {}
    for arch in REC_ARCHS:
        free_card()
        torch.cuda.reset_peak_memory_stats()
        bundle = reg.get_bundle(arch)
        cfg = bundle.cfg
        t0 = time.perf_counter()
        params = bundle.init_params(torch.Generator(dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        shapes = REC_SHAPES[arch]
        per_step = sum(v[2] for v in shapes.values())
        # the dense shapes on the decode (M = 8) and rows (M = 512) designs,
        # on int8 codes as dense quantizes them, each against its plain twin
        shape_rows = {}
        for m in (LM_BATCH, m_prefill):
            decode = m <= blocking.DECODE_MAX_M
            design = "decode" if decode else "rows"
            for site, (k, n, _) in shapes.items():
                x = torch.randn((1, m, k), generator=gen, device=dev).to(cfg.dtype)
                w = (torch.randn((1, k, n), generator=gen, device=dev)
                     / k ** 0.5).to(cfg.dtype)
                qa, _ = sub._quantize_operand(x, q.x_mode, None, 2, 8, q.eps)
                qb, _ = sub._quantize_operand(w, q.w_mode, None, 1, 8, q.eps)
                plain, plain_ms = timed_once(
                    (lambda: blocking.decode_matmul_plain(qa, qb, t16, 8)) if decode
                    else (lambda: blocking.rows_matmul_plain(qa, qb, planes, 8)))
                got, c, _ = count_launches(
                    counters, lambda: closed_form_matmul(qa, qb, "proposed@8"))
                require(c == only(**{f"closed_form_{design}": 1}),
                        f"{arch} M = {m} at {site}: designs launched {c}")
                err = max_abs_err(got, plain)
                require(err == 0, f"{arch} {design} design at ({m} x {k}) @ "
                                  f"({k} x {n}): {err}")
                ms = time_ms(lambda: closed_form_matmul(qa, qb, "proposed@8"))
                wk = (contraction_work(m, k, n) if decode
                      else rows_contraction_work(m, k, n, planes.planes))
                rate = INT32_OPS_PER_S if decode else INT8_TC_OPS_PER_S
                shape_rows[(design, site)] = {"m": m, "k": k, "n": n, "err": err,
                                              "ms": ms, "plain_ms": plain_ms,
                                              "work": wk, "rate": rate}
                emit("recurrent_kernel_shapes", arch=arch, design=design,
                     site=site, shape=[1, m, k, n], max_abs_err=err, tolerance=0,
                     ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(*wk, rate)[0])
                del x, w, qa, qb, plain, got
        # ServingEngine: 16 requests of 8 + 8 tokens at batch 8, odd ones
        # sampled; at 2 workers and at 1 (worker 0's first wave first)
        prompts = [list(map(int, rng.integers(1, cfg.vocab, LM_PROMPT)))
                   for _ in range(LM_REQUESTS)]
        spec_of = lambda order: [(prompts[i], LM_PROMPT, 0.0 if i % 2 == 0 else 0.8)
                                 for i in order]
        reqs2, c2, by2, r2 = serve_mix(bundle, params, spec_of(range(LM_REQUESTS)),
                                       LM_BATCH, 2, REC_MAX_LEN, kern, dev, counters)
        steps2 = r2["decode_steps"]
        order1 = list(range(0, LM_REQUESTS, 2)) + list(range(1, LM_REQUESTS, 2))
        reqs1, c1, by1, r1 = serve_mix(bundle, params, spec_of(order1), LM_BATCH, 1,
                                       REC_MAX_LEN, kern, dev, counters)
        steps1 = r1["decode_steps"]
        for c_, by_, st_ in ((c2, by2, steps2), (c1, by1, steps1)):
            dec = by_.get("closed_form_decode", {})
            require(c_ == only(closed_form_decode=per_step * st_)
                    and all(at(dec, LM_BATCH, k, n) == cnt * st_
                            for k, n, cnt in shapes.values())
                    and sum(dec.values()) == per_step * st_,
                    f"{arch} serving launches {c_} {dec} over {st_} steps")
        first_wave = {i: r.output for i, r in zip(order1[:LM_BATCH], reqs1)}
        same_wave = all(first_wave[i] == reqs2[i].output for i in first_wave)
        require(same_wave, f"{arch} first-wave outputs differ between 1 and 2 workers")
        # one decode step from a fresh state: logits and every state tensor
        # bit for bit the table substrate's
        tok = tokens((LM_BATCH, 1), cfg.vocab)

        def step(b_):
            st = b_.init_decode_state(LM_BATCH, REC_MAX_LEN, dev)
            return b_.decode_step(params, st, {"token": tok, "cache_len": 0})

        (a, a_st), c_step, _ = count_launches(
            counters, lambda: step(with_plan(bundle, kern)))
        (b, b_st), table_step_ms = timed_once(lambda: step(with_plan(bundle, table)))
        la = [t for _, t in tree_leaves(a_st)]
        lb = [t for _, t in tree_leaves(b_st)]
        step_same = bool(torch.isfinite(a).all()) and same_bits(a, b) \
            and len(la) == len(lb) and all(same_bits(x_, y_) for x_, y_ in zip(la, lb))
        require(step_same and c_step == only(closed_form_decode=per_step),
                f"{arch} decode step vs {table}: launches {c_step}")
        # the 8 x 64 prefill at full depth: M = 512, the rows design alone
        toks = tokens(REC_PREFILL, cfg.vocab)
        _, pf_first_ms = timed_once(
            lambda: with_plan(bundle, kern).prefill(params, {"tokens": toks}))
        (pf, pf_ms), c_pf, by_pf = count_launches(counters, lambda: timed_once(
            lambda: with_plan(bundle, kern).prefill(params, {"tokens": toks})))
        rows_by = by_pf.get("closed_form_rows", {})
        require(pf.shape == (REC_PREFILL[0], 1, cfg.vocab)
                and bool(torch.isfinite(pf).all())
                and c_pf == only(closed_form_rows=per_step)
                and all(at(rows_by, m_prefill, k, n) == cnt
                        for k, n, cnt in shapes.values()),
                f"{arch} prefill launches {c_pf} {rows_by}")
        # the prefill bit for bit the table substrate's (zamba at a cut depth
        # that keeps one shared block)
        cut_layers = REC_IDENTITY_LAYERS.get(arch, cfg.n_layers)
        if cut_layers == cfg.n_layers:
            cut_bundle, cut = bundle, params
        else:
            cut_bundle = reg.build_bundle(dataclasses.replace(cfg, n_layers=cut_layers))
            cut = zamba.Zamba(params.embed, list(params.mamba[:cut_layers]),
                              params.shared)
            require(zamba._shared_positions(cut_bundle.cfg) == [cut_layers - 1],
                    f"{arch} cut keeps one shared block")
        pk, c_pk, _ = count_launches(
            counters, lambda: with_plan(cut_bundle, kern).prefill(cut, {"tokens": toks}))
        pt, pf_table_ms = timed_once(
            lambda: with_plan(cut_bundle, table).prefill(cut, {"tokens": toks}))
        pf_same = bool(torch.isfinite(pk).all()) and same_bits(pk, pt)
        require(pf_same and c_pk["closed_form_rows"] > 0
                and sum(c_pk.values()) == c_pk["closed_form_rows"],
                f"{arch} prefill vs {table}: launches {c_pk}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        records[arch] = {"workers_2": r2, "workers_1": r1, "prefill_ms": pf_ms}
        emit("recurrent_serving_path", arch=arch, family=cfg.family,
             widths={k: getattr(cfg, k) for k in (
                 "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
                 "ssm_state", "conv_width", "shared_attn_every")},
             layers=cfg.n_layers,
             params=sum(t.numel() for t in params.parameters()),
             param_count=cfg.param_count(), init_s=init_s, substrate=kern,
             batch=LM_BATCH, requests=LM_REQUESTS, prompt_tokens=LM_PROMPT,
             max_tokens=LM_PROMPT, workers_2=r2, workers_1=r1,
             launches=c2, launches_by_shape=by2, launches_workers_1=c1,
             launches_per_step={"decode": per_step,
                                "by_kn": {site: v[2] for site, v in shapes.items()}},
             first_wave_identical=same_wave,
             decode_step={"bit_identical_to": table, "bit_identical": step_same,
                          "state_tensors": len(la), "launches": c_step,
                          "table_substrate_ms": table_step_ms},
             prefill={"entry_point": "bundle.prefill", "tokens": list(REC_PREFILL),
                      "device_events_ms": pf_ms, "first_call_ms": pf_first_ms,
                      "launches": c_pf, "launches_by_shape": by_pf},
             prefill_identity={"reduced": {"n_layers": [cut_layers, cfg.n_layers]},
                               "tokens": list(REC_PREFILL),
                               "bit_identical_to": table,
                               "bit_identical": pf_same, "launches": c_pk,
                               "table_substrate_ms": pf_table_ms},
             peak_memory_gb=peak, card=card)
        for (design, site), r in shape_rows.items():
            name = f"closed_form_matmul[{design},{site},M={r['m']},{arch}]"
            by = (by2 if design == "decode" else by_pf).get(f"closed_form_{design}", {})
            b_ms, b_by = bound_ms(*r["work"], r["rate"])
            rows.append({"name": name, "route": "cuda",
                         "source": "src/repro_torch/csrc/approx_matmul.cu",
                         "replaces": "src/repro/kernels/approx_matmul/kernel.py:59",
                         "launches": at(by, r["m"], r["k"], r["n"]),
                         "max_abs_err": r["err"], "ms": r["ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": None,
                         "shape": [1, r["m"], r["k"], r["n"]], "mult": "proposed@8",
                         "design": design,
                         "launches_on": "recurrent_serving_path" + (
                             " (2 workers)" if design == "decode"
                             else " (bundle.prefill)"),
                         "entry_point": "ServingEngine.generate"
                         if design == "decode" else "bundle.prefill",
                         "launches_per_step_at_shape": shapes[site][2]})
            work[name] = r["work"]
        del params, bundle, cut, a, b, a_st, b_st, pf, pk, pt
        free_card()
    return rows, work


def train_run(bundle, optimizer, plan, steps: int, dev, counters: dict,
              ckpt_dir: Path, around=None) -> tuple:
    """``steps`` QAT TrainLoop steps of ``bundle`` under ``plan`` with
    ``optimizer``, from the seeded init on the card: (params, readings). Per
    step: CUDA events between step ends (the loss is read on the host at a
    step's end, which synchronises) and the contraction launches by design
    and by shape, counted from 0 before each step. ``around``, a context
    manager, is entered around the steps alone (not the init)."""
    import contextlib

    from repro_torch.data import SyntheticLMStream
    from repro_torch.nn import plan as plan_mod
    from repro_torch.train import QATPolicy, TrainLoop, TrainLoopConfig

    batch, seq = TRAIN_BATCH
    loop = TrainLoop(bundle.loss_fn, optimizer, TrainLoopConfig(
        total_steps=steps, ckpt_every=steps + 1, lr=TRAIN_LR,
        ckpt_dir=str(ckpt_dir), qat=QATPolicy(), plan=plan_mod.as_plan(plan)),
        layout=bundle.layout)
    params, opt_state, start = loop.init_or_restore(
        lambda: bundle.init_params(torch.Generator(dev).manual_seed(0), dev))
    stream = SyntheticLMStream(vocab=bundle.cfg.vocab, batch=batch, seq_len=seq,
                               seed=0)
    events, per_step, by_step = [torch.cuda.Event(enable_timing=True)], [], []

    def reset():
        for c in counters.values():
            c.reset()

    def on_step(_step, _loss):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        per_step.append({name: c.value for name, c in counters.items()})
        by_step.append({name: {"x".join(map(str, sh)): v
                               for sh, v in c.by_shape().items()}
                        for name, c in counters.items() if c.value})
        reset()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    with around or contextlib.nullcontext():
        events[0].record()
        loop.run(params, opt_state, stream, start, on_step=on_step)
        torch.cuda.synchronize()
    losses = loop.metrics["losses"]
    require(len(losses) == steps and all(np.isfinite(losses)),
            f"training losses {losses}")
    del opt_state
    return params, {
        "loss_per_step": losses,
        "step_ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_per_step": per_step, "launches_by_shape_per_step": by_step}


def per_step_by_shape(shapes: dict, layers: int, m: int) -> dict:
    """Rows launches a training step makes by shape ``"1xMxKxN"``: each
    (K, N) of ``shapes`` (its launches per layer-pass third) in every one of
    ``layers`` layers, in the forward and in the recompute."""
    out: dict = {}
    for k, n, per in shapes.values():
        key = f"1x{m}x{k}x{n}"
        out[key] = out.get(key, 0) + 2 * per * layers
    return out


def rows_shape_check(kind: str, m: int, k: int, n: int, dtype, gen, dev,
                     counters: dict) -> dict:
    """One (m × k) @ (k × n) contraction on the rows design through the
    public entry point ``dense`` calls, on int8 codes as ``dense`` quantizes
    them: ``kind`` ``closed_form`` (proposed@8) or ``lut`` (the ``exact``
    table, also against ``torch._int_mm``), held exactly to its plain twin,
    timed beside it (and the library call for ``exact``)."""
    from repro_torch.kernels import blocking
    from repro_torch.kernels.approx_matmul import ops as am
    from repro_torch.kernels.approx_matmul.ops import closed_form_matmul
    from repro_torch.kernels.lut_matmul import ops as lm
    from repro_torch.kernels.lut_matmul.ops import device_table, lut_matmul
    from repro_torch.nn import substrate as sub

    q = sub.QuantPolicy()
    x = torch.randn((1, m, k), generator=gen, device=dev).to(dtype)
    w = (torch.randn((1, k, n), generator=gen, device=dev) / k ** 0.5).to(dtype)
    qa, _ = sub._quantize_operand(x, q.x_mode, None, 2, 8, q.eps)
    qb, _ = sub._quantize_operand(w, q.w_mode, None, 1, 8, q.eps)
    if kind == "closed_form":
        planes = am.rows_decomposition("proposed@8")
        fn = lambda: closed_form_matmul(qa, qb, "proposed@8")  # noqa: E731
        wk = rows_contraction_work(m, k, n, planes.planes)
    else:
        t_exact = device_table("exact", dev)
        planes = lm.rows_decomposition(t_exact)
        fn = lambda: lut_matmul(qa, qb, t_exact)  # noqa: E731
        wk = exact_contraction_work(m, k, n)
    plain, plain_ms = timed_once(lambda: blocking.rows_matmul_plain(qa, qb, planes, 8))
    got, c, _ = count_launches(counters, fn)
    require(c == {name: int(name == f"{kind}_rows") for name in counters},
            f"({m} x {k}) @ ({k} x {n}) {kind}: designs launched {c}")
    err = max_abs_err(got, plain)
    library_ms = None
    if kind == "lut":
        a2, b2 = qa[0], qb[0].contiguous()
        err = max(err, max_abs_err(got[0], torch._int_mm(a2, b2)))
        library_ms = time_ms(lambda: torch._int_mm(a2, b2))
    require(err == 0, f"rows design {kind} at ({m} x {k}) @ ({k} x {n}): {err}")
    return {"err": err, "ms": time_ms(fn), "plain_ms": plain_ms, "work": wk,
            "library_ms": library_ms, "shape": [1, m, k, n]}


def train_family_phases(dev, card: str) -> tuple:
    """Training of the MoE and recurrent families on the card: phases
    ``moe_train_path`` (llama4-maverick cut to MOE_TRAIN_CUT under
    proposed@8 and under LM_PLAN, kimi-k2 cut to TOPK_TRAIN_CUT under
    proposed@8; Adafactor on repro's stacked tree, as repro's launcher
    trains MoE configs), ``moe_train_restart`` (crash → restart bit for bit
    at MOE_RESTART_SIZE, the launchers' bundle served) and
    ``recurrent_train_path`` (xlstm-125m and zamba2-1.2b at full depth with
    AdamW). Each run: TRAIN_STEPS QAT steps of TrainLoop on the kernels,
    the same steps on the table substrate, the losses and every updated
    parameter bit for bit, the rows designs alone at their required counts
    by shape; one maverick and one zamba step traced. Returns (rows of the
    kernels line for the new (M, K, N), least work by row name, the
    phases' rows launches by kind and shape)."""
    import shutil

    from repro_torch.models import convert, lm
    from repro_torch.models import registry as reg
    from repro_torch.models import zamba
    from repro_torch.optim import adafactor, adamw
    from torch.profiler import ProfilerActivity, profile

    counters = contraction_counters()
    work_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_family_train"
    shutil.rmtree(work_dir, ignore_errors=True)
    kern, table = "approx_cuda:proposed@8", "approx_lut:proposed@8"
    m = TRAIN_BATCH[0] * TRAIN_BATCH[1]
    gen = torch.Generator(dev).manual_seed(9)
    launched: dict = {}  # kind -> "1xMxKxN" -> launches in these phases

    def only(**n) -> dict:
        return {name: n.get(name, 0) for name in counters}

    def optimizer(bundle):
        return adafactor(bundle.layout) if bundle.cfg.n_experts else adamw()

    def widths(cfg) -> dict:
        return {k: getattr(cfg, k) for k in (
            "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "d_ff_expert",
            "vocab", "n_experts", "top_k", "moe_interleave", "shared_expert",
            "ssm_state", "conv_width", "shared_attn_every")}

    def held(name: str, bundle, plans: tuple, expect: dict, steps: int = TRAIN_STEPS):
        """``steps`` on the kernels under plans[0] and on the table substrate
        under plans[1]: the losses and every parameter bit for bit; each
        kernel step launches exactly ``expect`` ({kind: {shape: n}})."""
        free_card()
        p_k, r_k = train_run(bundle, optimizer(bundle), plans[0], steps, dev,
                             counters, work_dir / "unused")
        want = only(**{kind: sum(by.values()) for kind, by in expect.items()})
        require(all(c == want for c in r_k["launches_per_step"])
                and all(by == expect for by in r_k["launches_by_shape_per_step"]),
                f"{name}: launches per step {r_k['launches_by_shape_per_step']}, "
                f"expected {expect}")
        for by in r_k["launches_by_shape_per_step"]:
            for kind, shapes in by.items():
                for sh, v in shapes.items():
                    launched.setdefault(kind, {})[sh] = \
                        launched.setdefault(kind, {}).get(sh, 0) + v
        kern_params = {k: t.detach().cpu() for k, t in
                       convert.named_leaves(p_k).items()}
        n_params = sum(t.numel() for t in kern_params.values())
        del p_k
        free_card()
        p_t, r_t = train_run(bundle, optimizer(bundle), plans[1], steps, dev,
                             counters, work_dir / "unused")
        require(all(c == only() for c in r_t["launches_per_step"]),
                f"the table substrate launched {r_t['launches_per_step']}")
        plain_params = convert.named_leaves(p_t)
        same_loss = r_k["loss_per_step"] == r_t["loss_per_step"]
        differ = [k for k, t in kern_params.items()
                  if not same_bits(t, plain_params[k].cpu())]
        del p_t, plain_params, kern_params
        free_card()
        require(same_loss and not differ,
                f"{name}: losses {r_k['loss_per_step']} vs {r_t['loss_per_step']}, "
                f"params that differ: {differ[:8]}")
        return {"plan": plans[0], "kernels": {k: v for k, v in r_k.items()
                                              if k != "launches_per_step"},
                "against": plans[1],
                "plain": {k: r_t[k] for k in ("loss_per_step", "step_ms",
                                              "peak_memory_gb")},
                "params": n_params, "losses_bit_identical": same_loss,
                "params_bit_identical": not differ}

    def traced(name: str, bundle, plan) -> dict:
        """One step (the first from the init) under torch.profiler: where
        its device time goes. The Chrome trace is read and removed (it
        would not fit the run's output directory)."""
        free_card()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        p_tr, r_tr = train_run(bundle, optimizer(bundle), plan, 1, dev, counters,
                               work_dir / "unused", around=prof)
        del p_tr
        free_card()
        work_dir.mkdir(parents=True, exist_ok=True)
        path = work_dir / f"{name}_train_trace.json"
        prof.export_chrome_trace(str(path))
        busy_us, by_name = device_busy(path)
        trace_mb = path.stat().st_size / 1e6
        path.unlink()
        return {"trace_mb_not_kept": trace_mb, "steps": 1,
                "step_ms": r_tr["step_ms"][0], "device_busy_ms": busy_us / 1e3,
                "device_ms_by_name": {k: v / 1e3 for k, v in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:12]},
                "rows_kernels_ms": sum(v for k, v in by_name.items()
                                       if "rows_matmul_kernel" in k) / 1e3,
                "launches": r_tr["launches_per_step"][0]}

    t_phase = time.perf_counter()
    # -- moe_train_path -----------------------------------------------------
    full = reg.get_config(MOE_ARCH)
    bundle = reg.get_bundle(MOE_ARCH, **MOE_TRAIN_CUT)
    layers = bundle.cfg.n_layers
    require(layers // lm.unit_period(bundle.cfg) == 2,
            "maverick's cut keeps two stacked units")
    all_rows = per_step_by_shape(MOE_SHAPES, layers, m)
    layer0 = per_step_by_shape(MOE_SHAPES, 1, m)
    cases = {
        "maverick approx_cuda:proposed@8": held(
            "maverick proposed@8", bundle, (kern, table),
            {"closed_form_rows": all_rows}),
        "maverick lm_plan": held(
            "maverick lm_plan", bundle, (LM_PLAN, LM_PLAN_TABLE),
            {"closed_form_rows": {k: v - layer0[k] for k, v in all_rows.items()},
             "lut_rows": layer0}),
    }
    mav_trace = traced("moe", bundle, kern)
    tbundle = reg.get_bundle(TOPK_ARCH, **TOPK_TRAIN_CUT)
    cases["kimi-k2 approx_cuda:proposed@8"] = held(
        "kimi-k2 proposed@8", tbundle, (kern, table),
        {"closed_form_rows": per_step_by_shape(TOPK_SHAPES, tbundle.cfg.n_layers, m)})
    tfull = reg.get_config(TOPK_ARCH)
    emit("moe_train_path", entry_point="TrainLoop.run",
         optimizer="adafactor(bundle.layout): repro's rule on its stacked tree",
         archs={MOE_ARCH: {"widths": widths(full), "reduced": {
                    k: [v, getattr(full, k)] for k, v in MOE_TRAIN_CUT.items()},
                           "param_count": bundle.cfg.param_count()},
                TOPK_ARCH: {"widths": widths(tfull), "reduced": {
                    k: [v, getattr(tfull, k)] for k, v in TOPK_TRAIN_CUT.items()},
                            "param_count": tbundle.cfg.param_count()}},
         batch=TRAIN_BATCH[0], seq_len=TRAIN_BATCH[1], rows_m=m, steps=TRAIN_STEPS,
         lr=TRAIN_LR, qat="bitexact", remat=bundle.cfg.remat,
         launches_expected="per step: 7 rows launches per layer in the forward "
                           "+ 7 in the recompute (4 attention + the dense FFN "
                           "or the shared expert); layer 0 on lut_matmul under "
                           "the LM plan; rows designs only",
         cases=cases, trace=mav_trace, seconds=time.perf_counter() - t_phase,
         card=card)
    del bundle, tbundle
    free_card()

    # -- moe_train_restart: crash -> restart bit for bit, Adafactor's state
    # through repro's tree on disk, and the launchers
    t_phase = time.perf_counter()
    r = crash_restart_and_serve(MOE_ARCH, MOE_RESTART_SIZE, optimizer, dev, work_dir)
    # the step-8 checkpoint's optimizer state is repro's Adafactor tree: a
    # stacked norm scale's statistics factored, vc shared by the layers
    with np.load(work_dir / "b" / "step_0000000008" / "arrays.npz") as z:
        stats = {k: tuple(z[k].shape) for k in z.files if k.startswith("opt/")}
    d, n_units = MOE_RESTART_SIZE["d_model"], MOE_RESTART_SIZE["n_layers"] // 2
    tree_ok = (stats.get("opt/mv/unit/0/attn/ln/vr") == (n_units,)
               and stats.get("opt/mv/unit/0/attn/ln/vc") == (d,)
               and stats.get("opt/mv/unit/1/moe/wi/vr") == (
                   n_units, MOE_RESTART_SIZE["n_experts"], d)
               and "opt/mv/embed/ln_f/v" in stats and "opt/step" in stats)
    require(tree_ok, f"the checkpoint's Adafactor state: {sorted(stats)[:12]}")
    shutil.rmtree(work_dir, ignore_errors=True)
    emit("moe_train_restart", arch=MOE_ARCH,
         reduced={k: [v, getattr(full, k)] for k, v in MOE_RESTART_SIZE.items()},
         optimizer="adafactor(bundle.layout)",
         checkpoint_opt_is_repros_adafactor_tree=tree_ok,
         checkpoint_opt_arrays=len(stats), seconds=time.perf_counter() - t_phase,
         card=card, **r["record"])
    del r
    free_card()

    # -- recurrent_train_path: xlstm and zamba at full depth, AdamW ----------
    t_phase = time.perf_counter()
    records = {}
    for arch in REC_ARCHS:
        bundle = reg.get_bundle(arch)
        cfg = bundle.cfg
        shapes = zamba_shapes(cfg) if cfg.family == "zamba" else REC_SHAPES[arch]
        require(shapes == REC_SHAPES[arch], f"{arch}: dense sites {shapes}")
        expect = {"closed_form_rows": per_step_by_shape(shapes, 1, m)}
        cut_layers = REC_IDENTITY_LAYERS.get(arch, cfg.n_layers)
        if cut_layers == cfg.n_layers:
            record = held(arch, bundle, (kern, table), expect)
        else:
            # the timed run at full depth on the kernels; the identity at a
            # cut depth that keeps one shared block
            free_card()
            p_k, r_k = train_run(bundle, adamw(), kern, TRAIN_STEPS, dev, counters,
                                 work_dir / "unused")
            require(all(by == expect for by in r_k["launches_by_shape_per_step"])
                    and all(sum(c.values()) == c["closed_form_rows"]
                            for c in r_k["launches_per_step"]),
                    f"{arch}: launches per step {r_k['launches_by_shape_per_step']}")
            for by in r_k["launches_by_shape_per_step"]:
                for sh, v in by.get("closed_form_rows", {}).items():
                    launched.setdefault("closed_form_rows", {})[sh] = \
                        launched.setdefault("closed_form_rows", {}).get(sh, 0) + v
            del p_k
            cut_bundle = reg.get_bundle(arch, n_layers=cut_layers)
            require(zamba._shared_positions(cut_bundle.cfg) == [cut_layers - 1],
                    f"{arch} cut keeps one shared block")
            cut_expect = {"closed_form_rows": per_step_by_shape(
                zamba_shapes(cut_bundle.cfg), 1, m)}
            identity = held(f"{arch} at {cut_layers} layers", cut_bundle,
                            (kern, table), cut_expect)
            record = {"plan": kern, "kernels": {k: v for k, v in r_k.items()
                                                if k != "launches_per_step"},
                      "identity": {"reduced": {"n_layers": [cut_layers, cfg.n_layers]},
                                   **identity}}
        records[arch] = {"widths": widths(cfg), "layers": cfg.n_layers,
                         "param_count": cfg.param_count(),
                         "launches_expected_per_step": expect, **record}
    zamba_trace = traced("zamba", reg.get_bundle("zamba2-1.2b"), kern)
    emit("recurrent_train_path", entry_point="TrainLoop.run", optimizer="adamw",
         batch=TRAIN_BATCH[0], seq_len=TRAIN_BATCH[1], rows_m=m, steps=TRAIN_STEPS,
         lr=TRAIN_LR, qat="bitexact",
         launches_expected="per step: every dense site in the forward and in "
                           "the recompute of each remat region (each layer, "
                           "zamba's shared block at each place): 2 x 72 "
                           "(xlstm), 2 x 118 (zamba); rows designs only",
         archs=records, trace=zamba_trace, seconds=time.perf_counter() - t_phase,
         card=card)
    free_card()

    # -- the new (M, K, N) on the rows design: kimi-k2's shapes, the
    # recurrent shapes at M = 256, and maverick's under the LM plan's exact
    # layer (lut_matmul), each checked against its plain twin and timed
    rows, work = [], {}
    news = ([("closed_form", TOPK_ARCH, site, kn) for site, kn in TOPK_SHAPES.items()]
            + [("closed_form", arch, site, kn) for arch in REC_ARCHS
               for site, kn in REC_SHAPES[arch].items()]
            + [("lut", MOE_ARCH, site, kn) for site, kn in MOE_SHAPES.items()])
    for kind, arch, site, (k, n, _) in news:
        r = rows_shape_check(kind, m, k, n, torch.bfloat16, gen, dev, counters)
        name = (f"{'closed_form_matmul' if kind == 'closed_form' else 'lut_matmul'}"
                f"[rows,{site},M={m},{arch}]")
        b_ms, b_by = bound_ms(*r["work"], INT8_TC_OPS_PER_S)
        lut = kind == "lut"
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/" + (
                         "lut_matmul.cu" if lut else "approx_matmul.cu"),
                     "replaces": "src/repro/kernels/" + (
                         "lut_matmul/kernel.py:74" if lut
                         else "approx_matmul/kernel.py:59"),
                     "launches": launched.get(f"{kind}_rows", {}).get(
                         "x".join(map(str, r["shape"])), 0),
                     "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": r["library_ms"],
                     "shape": r["shape"], "mult": "exact" if lut else "proposed@8",
                     "design": "rows",
                     "launches_on": "moe_train_path" if arch in (MOE_ARCH, TOPK_ARCH)
                     else "recurrent_train_path", "entry_point": "TrainLoop.run"})
        work[name] = r["work"]
        emit("train_kernel_shapes", name=name, shape=r["shape"], max_abs_err=r["err"],
             tolerance=0, ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b_ms,
             library_ms=r["library_ms"])
    return rows, work, launched


def zamba_shapes(cfg) -> dict:
    """``REC_SHAPES["zamba2-1.2b"]`` at ``cfg``'s depth: the mamba sites once
    a layer, the shared block's at each place it runs."""
    from repro_torch.models import zamba

    places = len(zamba._shared_positions(cfg))
    per = {"mamba.in_proj": cfg.n_layers, "mamba.out_proj": cfg.n_layers,
           "shared.attn.wq,wk,wv,wo": 4 * places, "shared.ffn.wg,wi": 2 * places,
           "shared.ffn.wo": places}
    return {site: (k, n, per[site])
            for site, (k, n, _) in REC_SHAPES["zamba2-1.2b"].items()}


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
                        closed_form_matmul.narrow_launches,
                        closed_form_matmul.rows_launches):
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
                        closed_form_matmul.narrow_launches.value,
                    "approx_matmul_rows": closed_form_matmul.rows_launches.value}
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
            and launches["approx_matmul"] == launches["approx_matmul_rows"] == 0,
            f"launches {launches}")
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
                        lut_matmul.rows_launches, closed_form_matmul.rows_launches,
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
                      "lut_matmul_rows": lut_matmul.rows_launches.value,
                      "closed_form_matmul_rows": closed_form_matmul.rows_launches.value,
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
            and p_launches["lut_matmul"] == p_launches["lut_matmul_rows"] == 0
            and p_launches["closed_form_matmul"] == 0
            and p_launches["closed_form_matmul_rows"] == 0,
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

    # -- 5c. edge QAT: finetune_edge under the same plan -------------------
    qat_launches = edge_qat_phase(dev, tiles, p_served[32:48], {
        "closed_form_matmul": closed_form_matmul.launches,
        "closed_form_matmul_narrow": closed_form_matmul.narrow_launches,
        "closed_form_matmul_decode": closed_form_matmul.decode_launches,
        "closed_form_matmul_rows": closed_form_matmul.rows_launches,
        "lut_matmul": lut_matmul.launches,
        "lut_matmul_rows": lut_matmul.rows_launches,
        "lut_matmul_narrow": lut_matmul.narrow_launches,
        "lut_matmul_decode": lut_matmul.decode_launches,
        "lut_matmul_tensor": lut_matmul.tensor_launches,
        "fused_conv2d": fused_conv2d.launches,
        "fused_conv2d_lut": fused_conv2d.lut_launches})

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

    # the rows design of both contraction kernels, on the path that takes
    # it: dot_general at a dense layer's shape, (8 x 128 tokens x 64) @
    # (64 x 256), K = 64 and N = 256 beyond the narrow design's limits; the
    # same contraction through the kernels' entry points takes the tile
    # design at width 12 (beyond int8 codes; no approx_cuda spec takes it)
    # and under a product table beyond the rows design's planes
    tokens = torch.from_numpy(rng.integers(-128, 128, (8, 128, 64))
                              .astype(np.int32)).to(dev)
    weight = torch.from_numpy(rng.integers(-128, 128, (64, 256))
                              .astype(np.int32)).to(dev)
    dense_dims = (((2,), (0,)), ((), ()))
    a_w, b_w = tokens.reshape(1, -1, 64), weight[None]
    noise = torch.from_numpy(rng.integers(-2**20, 2**20, 1 << 16)
                             .astype(np.int32)).to(dev)
    require(lm.rows_decomposition(noise) is None,
            "a noise table within the rows design's planes")
    wide_plain = {"approx_cuda": closed_form_matmul_plain(a_w, b_w, "proposed@8"),
                  "approx_cuda:exact": lut_matmul_plain(
                      a_w, b_w, device_table("exact", dev))}
    wide_counters = {"closed_form_matmul": closed_form_matmul.launches,
                     "lut_matmul": lut_matmul.launches,
                     "closed_form_matmul_rows": closed_form_matmul.rows_launches,
                     "lut_matmul_rows": lut_matmul.rows_launches,
                     "closed_form_matmul_narrow": closed_form_matmul.narrow_launches,
                     "lut_matmul_narrow": lut_matmul.narrow_launches}
    for counter in wide_counters.values():
        counter.reset()
    w_err = 0
    for spec, want in wide_plain.items():
        got = sub.get_substrate(spec).dot_general(
            tokens, weight, sub.ContractionSpec(dense_dims))
        w_err = max(w_err, max_abs_err(got, want[0].reshape(got.shape)))
    w_err = max(w_err, max_abs_err(lut_matmul(a_w, b_w, noise),
                                   lut_matmul_plain(a_w, b_w, noise)),
                max_abs_err(closed_form_matmul(a_w, b_w, "proposed@12"),
                            closed_form_matmul_plain(a_w, b_w, "proposed@12")))
    torch.cuda.synchronize()
    w_launches = {name: c.value for name, c in wide_counters.items()}
    require(w_launches == {"closed_form_matmul": 1, "lut_matmul": 1,
                           "closed_form_matmul_rows": 1, "lut_matmul_rows": 1,
                           "closed_form_matmul_narrow": 0, "lut_matmul_narrow": 0},
            f"wide contraction launches {w_launches}")
    require(w_err == 0, "wide contraction vs plain")
    emit("wide_contraction_path", shape=[8, 128, 64, 256],
         specs=list(wide_plain) + ["lut_matmul, a table beyond the rows planes",
                                   "closed_form_matmul, proposed@12"],
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
        dict(contraction_row("closed_form_matmul[ring,narrow]", "narrow",
                             p_launches["closed_form_matmul_narrow"], "planned_path",
                             mr_err, mr_ms, mr_bound, mr_by, None, mr_shape, rk),
             launches_edge_qat_path=qat_launches["closed_form_matmul_narrow"]),
        contraction_row("lut_matmul", "tile", w_launches["lut_matmul"],
                        "wide_contraction_path", lm_err, lm_ms, lm_bound, lm_by,
                        lm_lib_ms, lm_shape, "exact"),
        dict(contraction_row("lut_matmul[narrow]", "narrow",
                             p_launches["lut_matmul_narrow"], "planned_path",
                             lm_err, lm_ms, lm_bound, lm_by, lm_lib_ms, lm_shape,
                             "exact"),
             launches_edge_qat_path=qat_launches["lut_matmul_narrow"]),
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
    tool_shapes = tools_phases(dev, card, tiles, out_dir)
    family_rows, family_work = family_phases(dev, card)
    rec_rows, rec_work = recurrent_phases(dev, card)
    train_rows, train_work, train_launched = train_family_phases(dev, card)

    def at_kn(by_shape: dict, k: int, n: int) -> dict:
        """The counted launches ("BxMxKxN" -> n) whose K and N are k and n."""
        return {s: v for s, v in by_shape.items()
                if s.split("x")[2:] == [str(k), str(n)]}

    # the new phases' launches beside the row of their design, K and N: the
    # meter and the edge search launch the narrow designs (ring K = 8 on
    # the closed form, center K = 1 on the table), the LM search's
    # validation prefills (M = 32) the rows design; each phase's record
    # lists all its launches by shape
    for row in kernels:
        if row["name"] in ("closed_form_matmul[ring,narrow]", "lut_matmul[narrow]"):
            kind = "lut" if row["name"].startswith("lut") else "closed_form"
            for phase in ("meter_path", "autotune_edge_path"):
                row[f"launches_{phase}"] = at_kn(
                    tool_shapes[phase].get(f"{kind}_narrow", {}), *row["shape"][2:])
        if row["name"].startswith("closed_form_matmul[rows,"):
            row["launches_autotune_lm_path"] = at_kn(
                tool_shapes["autotune_lm_path"]["closed_form_rows"], *row["shape"][2:])
    kernels += family_rows + rec_rows
    # the training phases' launches beside the rows of their design and
    # shape (maverick's at M = 256 under proposed@8); their new shapes
    # follow as rows of their own
    for row in kernels:
        kind = row["name"].split("[")[0].replace("closed_form_matmul", "closed_form") \
            .replace("lut_matmul", "lut")
        if row.get("design") == "rows":
            n_train = train_launched.get(f"{kind}_rows", {}).get(
                "x".join(map(str, row["shape"])), 0)
            if n_train:
                row["launches_moe_train_path"] = n_train
    kernels += train_rows
    # every row exact; launched on its path, except the tile designs at the
    # decode step's M = 8, which the served path must not launch at all
    require(all(k["max_abs_err"] == 0 and (k["launches"] == 0 if k.get("off_path")
                                           else k["launches"] > 0) for k in kernels),
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
            "approx_mul": (am_bytes, am_ops), **lm_work, **family_work,
            **rec_work, **train_work}
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
