"""Kernel micro-benchmarks on the PyTorch port: product-substrate sweep.

The counterpart of ``benchmarks/kernelbench.py``. Times the integer
contraction (``dot_int``) of every substrate registered in
``repro_torch.nn.substrate`` — no hand-maintained mode list — on
``device`` (the card unless the caller asks for the CPU; no card raises).
``approx_pallas`` is the alias of ``approx_cuda`` and is timed once, under
``approx_cuda``.

Beyond the substrate sweep, this bench times:

* the wiring × width sweep (every CSP wiring runs the closed-form kernel;
  its ``approx_pallas:*`` specs, section and row names are the
  reference's, the specs resolving through the alias onto
  ``approx_cuda``);
* the designs of the two contraction kernels (``designs``, in the place of
  the reference's k-slab rows, which time a Pallas ``k_chunk`` that has no
  counterpart here): for ``closed_form_matmul`` and ``lut_matmul`` at the
  bench's shape, each design that takes the shape, forced through the
  kernels' private ``_launch(..., design=)``, against the tile design;
* the fused conv kernel (in-kernel im2col) vs the im2col +
  ``dot_general`` path (``conv2d_batched(fused=)``);
* the elementwise ``approx_mul`` kernel.

On the card every result that a kernel computes (the ``approx_cuda`` rows
of the substrate sweep, the wiring sweep, each design, the fused and im2col
conv, ``approx_mul``) is held bit for bit against the kernel's plain
version: the same call on CPU copies of the same operands, where the
wrappers run their plain versions. A mismatch raises.

Timing: CUDA events around 5 calls after one untimed call (which builds
the kernels), the stream first held asleep on the card while the host
enqueues the calls, as ``chip_smoke.py``'s ``time_ms`` does, so the host's
launch cost does not show below 0.1 ms. On the CPU (``--device cpu``, the kernels' plain
versions) the wall clock. Every row also lands in a machine-readable
``BENCH_torch_kernels.json`` at the repo root (the reference's
``BENCH_kernels.json`` is its own CPU run and is left alone), with the
card's ``nvidia-smi`` name and power limit.

``sharded=True`` (``--sharded``) adds the sharded ``dot_general`` rows
(section ``sharded``, the reference's keys): each substrate's contraction
under ``launch.mesh.contraction_partitioning`` of the ``("data",
"model")`` mesh of the ranks ``torchrun`` starts (a world of one without
it; ``--backend gloo``, the default: ``nccl`` is refused until a machine
with a card a rank has run it), each bit-exact
substrate's result held bit for bit against the rank's unsharded one. Every rank times the same calls; rank 0 alone runs the
other sections, prints and writes the JSON.

Standalone: ``python -m benchmarks.torch_kernelbench [--dry-run]
[--substrates a,b] [--json PATH] [--device cpu] [--sharded]`` —
``--dry-run`` shrinks every shape; ``python -m torch.distributed.run
--nproc-per-node 2 -m benchmarks.torch_kernelbench --sharded`` shards.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import card_name, resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn import substrate as sub

_REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
DEFAULT_JSON = _REPO_ROOT / "BENCH_torch_kernels.json"

#: calls a time is the mean of
ITERS = 5
#: cycles the stream sleeps while the host enqueues ITERS calls (~11 ms at
#: 1.755 GHz)
SLEEP_CYCLES = 20_000_000
TIMING = {"cuda": "mean CUDA-event us over 5 calls after 1 untimed call, "
                  "the stream held asleep while they are enqueued",
          "cpu": "mean wall-clock us over 5 calls after 1 untimed call"}


def _time(fn, device: torch.device, iters: int = ITERS) -> float:
    """Mean µs of one call of ``fn``, after one untimed call (on the card
    it builds the kernels). On the card, CUDA events around ``iters`` calls
    that the host enqueues while the stream sleeps, so that they run back
    to back and the host's launch cost shows only where it outlasts the
    device's work."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters * 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def _codes(rng, shape, device) -> torch.Tensor:
    return torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8)
                            ).to(device)


def _held(what: str, fn, operands: tuple, device, plain=None):
    """``fn(*operands)``; on the card also ``(plain or fn)`` on CPU copies
    of the operands (the plain versions), which the result must equal bit
    for bit."""
    out = fn(*operands)
    if device.type == "cuda":
        want = (plain or fn)(*(t.cpu() for t in operands))
        assert torch.equal(out.cpu(), want), \
            f"{what}: the kernel on the card != its plain version"
    return out


def _design_rows(rng, records, dry_run, device) -> list:
    """Each design of the two contraction kernels that takes the bench's
    shape, against the tile design."""
    from repro_torch.kernels import blocking
    from repro_torch.kernels.approx_matmul import ops as am
    from repro_torch.kernels.lut_matmul import ops as lm

    m = k = n = 32 if dry_run else 128
    a = _codes(rng, (1, m, k), device)
    b = _codes(rng, (1, k, n), device)
    table = lm.device_table("proposed", device)
    macs = m * k * n
    kernels = (
        ("closed_form_matmul", blocking.eligible_designs(m, k, n, 8),
         lambda d: am._launch(a, b, "proposed", design=d),
         lambda a_, b_: am.closed_form_matmul(a_, b_, "proposed")),
        ("lut_matmul", blocking.eligible_designs(m, k, n, 8,
                                                 lm.table_checks(table)),
         lambda d: lm._launch(a, b, table, 8, design=d),
         lambda a_, b_: lm.lut_matmul(a_, b_, lm.device_table("proposed",
                                                              a_.device))),
    )
    rows = []
    ran = "kernel" if device.type == "cuda" else "plain"
    print(f"\n== kernel bench: contraction designs ({m}x{k}x{n}, proposed@8, "
          f"{ran}) ==")
    for kernel, eligible, launch, plain in kernels:
        designs = [d for d in blocking.DESIGN_ORDER if eligible.get(d)]
        # the tile design first: every other design is held and timed
        # against it
        designs = ["tile"] + [d for d in designs if d != "tile"]
        base = ref = None
        for design in designs:
            # the CPU has the plain version only: one per kernel, whatever
            # the design
            fn = (lambda _d=design: launch(_d)) if device.type == "cuda" \
                else (lambda: plain(a, b))
            out = _held(f"{kernel} {design} design", lambda _a, _b: fn(),
                        (a, b), device, plain)
            if ref is None:
                ref = out
            equal = bool(torch.equal(out, ref))
            assert equal, f"{kernel} {design} design != tile design"
            us = _time(fn, device)
            gmacs = macs / us / 1e3
            if base is None:
                base = us
            speedup = base / us
            print(f"{kernel:>20s} {design:>6s}: {us:10.1f} us  "
                  f"({gmacs:8.2f} GMAC/s, {speedup:6.2f}x vs tile)")
            rows.append((f"kernel/design_{kernel}_{design}", us,
                         f"gmacs={gmacs:.2f};speedup={speedup:.2f}x"))
            records.append({"section": "designs", "kernel": kernel,
                            "wiring": "proposed", "width": 8, "design": design,
                            "ran": ran, "shape": [m, k, n], "us": round(us, 1),
                            "gmacs": round(gmacs, 3),
                            "speedup_vs_tile": round(speedup, 3),
                            "equal_to_tile": equal})
    return rows


def _fused_conv_rows(rng, records, dry_run, device) -> list:
    """Fused conv kernel (in-kernel im2col) vs host-side im2col path."""
    from repro_torch.nn import conv

    b, h, w = (2, 32, 32) if dry_run else (4, 128, 128)
    imgs = torch.from_numpy(rng.integers(-128, 128, (b, h, w)).astype(np.int32)
                            ).to(device)
    s = sub.get_substrate("approx_pallas:proposed")
    rows = []
    print(f"\n== kernel bench: fused conv vs im2col ({b}x{h}x{w}, "
          f"3x3 Laplacian) ==")
    base = None
    for fused, tag in ((False, "im2col"), (True, "fused")):
        _held(f"conv_{tag}", lambda x, _f=fused: conv.conv2d_batched(
            x, conv.LAPLACIAN, s, fused=_f), (imgs,), device)
        us = _time(lambda _f=fused: conv.conv2d_batched(
            imgs, conv.LAPLACIAN, s, fused=_f), device)
        speedup = (base / us) if base else 1.0
        if not fused:
            base = us
        print(f"{tag:>10s}: {us:10.1f} us  ({speedup:4.2f}x vs im2col)")
        rows.append((f"kernel/conv_{tag}", us,
                     f"imgs={b}x{h}x{w};speedup={speedup:.2f}x"))
        records.append({"section": "fused_conv", "kernel": f"conv_{tag}",
                        "wiring": "proposed", "width": 8,
                        "shape": [b, h, w], "us": round(us, 1),
                        "speedup_vs_im2col": round(speedup, 3)})
    return rows


def _sharded_rows(specs, a8, b8, macs, records, device,
                  leader: bool) -> list:
    """dot_general + Partitioning over the debug mesh of every rank; each
    result held against the rank's unsharded ``dot_int``."""
    rows = []
    mesh = mesh_lib.make_debug_mesh()
    part = mesh_lib.contraction_partitioning(mesh)
    world = dist.get_world_size()
    if leader:
        print(f"\n== kernel bench: sharded dot_general (mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}, "
              f"m_axis={part.m_axis}, k_axis={part.k_axis}, backend "
              f"{dist.get_backend()}) ==")
    for spec in specs:
        s = sub.get_substrate(spec)
        cspec = sub.ContractionSpec(partitioning=part)
        got = s.dot_general(a8, b8, cspec)
        if s.meta.bit_exact:  # approx_stat's per-shard correction is not
            assert torch.equal(got, s.dot_int(a8, b8)), \
                f"{spec}: sharded dot_general != the unsharded dot_int"
        us = _time(lambda _s=s: _s.dot_general(a8, b8, cspec), device)
        gmacs = macs / us / 1e3
        if leader:
            print(f"{spec:>16s}: {us:10.1f} us  ({gmacs:6.2f} GMAC/s) "
                  "[sharded]")
        rows.append((f"kernel/sharded_{s.meta.label}", us,
                     f"gmacs={gmacs:.2f};devices={world}"))
        records.append({"section": "sharded", "kernel": "dot_general",
                        "spec": spec, "us": round(us, 1),
                        "gmacs": round(gmacs, 3), "devices": world})
    return rows


def run(substrates=None, sharded=False, dry_run=False,
        json_path=DEFAULT_JSON, trace_path=None, device="cuda",
        backend="gloo") -> list:
    from repro_torch.obs import Tracer, tracing_scope, write_chrome_trace

    device = resolve_device(str(device))
    owns_group = sharded and not dist.is_initialized()
    if sharded:
        mesh_lib.init_ranks(backend)
        device = mesh_lib.rank_device(device.type)
    leader = not sharded or dist.get_rank() == 0
    tracer = Tracer() if trace_path and leader else None
    try:
        with tracing_scope(tracer):
            rows = _run_benches(substrates, sharded, dry_run, json_path,
                                device, leader)
    finally:
        if owns_group:
            dist.destroy_process_group()
    if tracer is not None:
        p = write_chrome_trace(tracer, trace_path)
        print(f"wrote {len(tracer.events())} trace events to {p}")
    return rows if leader else []


def _run_benches(substrates, sharded, dry_run, json_path, device,
                 leader=True) -> list:
    rows = []
    records: list[dict] = []
    rng = np.random.default_rng(0)
    m, k, n = (32, 64, 32) if dry_run else (256, 512, 256)
    a8 = _codes(rng, (m, k), device)
    b8 = _codes(rng, (k, n), device)
    specs = (list(substrates) if substrates else
             [s for s in sub.list_substrates() if s != "approx_pallas"])
    macs = m * k * n
    if not leader:  # the other ranks take part in the sharded rows only
        return _sharded_rows(specs, a8, b8, macs, records, device, False)
    print(f"\n== kernel bench: int8 matmul substrates ({m}x{k}x{n}, "
          f"{device.type}) ==")
    for spec in specs:
        s = sub.get_substrate(spec)
        if s.meta.preferred_backend == "cuda":  # the kernels' backend
            _held(spec, s.dot_int, (a8, b8), device)
        us = _time(lambda _s=s: _s.dot_int(a8, b8), device)
        gmacs = macs / us / 1e3
        note = " [plain]" if s.meta.preferred_backend == "cuda" \
            and device.type != "cuda" else ""
        print(f"{spec:>16s}: {us:10.1f} us  ({gmacs:6.2f} GMAC/s){note}")
        rows.append((f"kernel/matmul_{s.meta.label}", us, f"gmacs={gmacs:.2f}"))
        records.append({"section": "substrates", "kernel": "dot_int",
                        "spec": spec, "shape": [m, k, n], "us": round(us, 1),
                        "gmacs": round(gmacs, 3),
                        "cost_hint": s.meta.cost_hint})
    if sharded:
        rows.extend(_sharded_rows(specs, a8, b8, macs, records, device, True))

    # wiring × width sweep under the reference's approx_pallas specs, which
    # resolve onto approx_cuda: every CSP wiring rides the closed-form
    # kernel (cost_hint "int32-alu"); only product models without CSP
    # structure ("exact") take the table kernel
    pm = pk = pn = 32 if dry_run else 128
    pa = _codes(rng, (pm, pk), device)
    pb = _codes(rng, (pk, pn), device)
    pmacs = pm * pk * pn
    print(f"\n== kernel bench: approx_pallas (= approx_cuda) wiring x width "
          f"sweep ({pm}x{pk}x{pn}) ==")
    for wiring in ("proposed", "csp_axc1", "design_strollo2020"):
        for width in (4, 8):
            spec = f"approx_pallas:{wiring}@{width}"
            s = sub.get_substrate(spec)
            _held(spec, s.dot_int, (pa, pb), device)
            us = _time(lambda _s=s: _s.dot_int(pa, pb), device)
            gmacs = pmacs / us / 1e3
            note = " [plain]" if device.type != "cuda" else ""
            print(f"{spec:>34s}: {us:10.1f} us  ({gmacs:6.2f} GMAC/s) "
                  f"[{s.meta.cost_hint}]{note}")
            rows.append((f"kernel/pallas_{wiring}@{width}", us,
                         f"gmacs={gmacs:.2f};cost={s.meta.cost_hint}"))
            records.append({"section": "pallas_sweep", "kernel": "dot_int",
                            "wiring": wiring, "width": width,
                            "shape": [pm, pk, pn], "us": round(us, 1),
                            "gmacs": round(gmacs, 3),
                            "cost_hint": s.meta.cost_hint})

    rows.extend(_design_rows(rng, records, dry_run, device))
    rows.extend(_fused_conv_rows(rng, records, dry_run, device))

    from repro_torch.kernels.approx_mul.ops import approx_mul
    side = 64 if dry_run else 512
    x = torch.from_numpy(rng.integers(-128, 128, (side, side)).astype(np.int32)
                         ).to(device)
    y = torch.from_numpy(rng.integers(-128, 128, (side, side)).astype(np.int32)
                         ).to(device)
    _held("approx_mul", approx_mul, (x, y), device)
    us = _time(lambda: approx_mul(x, y), device)
    tag = "cuda" if device.type == "cuda" else "plain"
    rows.append((f"kernel/approx_mul_{tag}", us, f"{side}x{side}"))
    records.append({"section": "elementwise", "kernel": "approx_mul",
                    "wiring": "proposed", "width": 8, "shape": [side, side],
                    "us": round(us, 1)})
    print(f"approx_mul ({tag}): {us:.1f} us")

    if json_path:
        payload = {
            "bench": "torch_kernelbench",
            "backend": device.type,
            "card": card_name() if device.type == "cuda" else None,
            "dry_run": bool(dry_run),
            "timing": TIMING[device.type],
            "records": records,
        }
        pathlib.Path(json_path).write_text(json.dumps(payload, indent=1)
                                           + "\n")
        print(f"\nwrote {len(records)} records to {json_path}")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dry-run", action="store_true",
                    help="tiny shapes — seconds-fast smoke run")
    ap.add_argument("--sharded", action="store_true",
                    help="add sharded dot_general rows (debug mesh of the "
                         "ranks torchrun starts)")
    ap.add_argument("--backend", choices=mesh_lib.BACKENDS, default="gloo",
                    help="process-group backend under --sharded")
    ap.add_argument("--substrates", default=None,
                    help="CSV of substrate specs (default: all registered, "
                         "the approx_pallas alias once as approx_cuda)")
    ap.add_argument("--json", default=str(DEFAULT_JSON), dest="json_path",
                    help="output path for BENCH_torch_kernels.json "
                         "('' disables)")
    ap.add_argument("--trace", default=None, dest="trace_path",
                    help="write a Chrome/Perfetto trace of the kernel "
                         "dispatch spans")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the "
                         "kernels' plain versions)")
    args = ap.parse_args()
    substrates = args.substrates.split(",") if args.substrates else None
    rows = run(substrates=substrates, sharded=args.sharded,
               dry_run=args.dry_run, json_path=args.json_path or None,
               trace_path=args.trace_path, device=args.device,
               backend=args.backend)
    if not rows:  # a rank other than 0 under --sharded
        return
    print("\nname,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
