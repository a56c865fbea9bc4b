"""Edge-detection serving sweep on the PyTorch port: throughput/latency vs
{batch, timeout, substrate}.

The counterpart of ``benchmarks/edge_serving.py``. Drives the port's
micro-batching ``EdgeDetectService`` on ``device`` (the card unless the
caller asks for the CPU; no card raises) with a fixed request stream per
configuration and records throughput (img/s), p50/p95/p99 latency, and mean
batch occupancy. One warmup request per service runs the first dispatch of
its bucket shape (on the card it builds the kernels) before metrics are
reset, so the table reflects steady-state serving.

Every configuration also lands in a machine-readable
``BENCH_torch_serving.json`` at the repo root (the reference's
``BENCH_serving.json`` is its own CPU run and is left alone), including the
ambient substrate-meter rollup — per-spec contraction counts, MACs, and
estimated energy (MACs × per-op PDP). ``--trace PATH`` additionally records
the serving spans as a Chrome/Perfetto trace.

The sweep ends with a throughput-vs-worker-count table (workers 1/2/4)
for one substrate (``approx_cuda`` where it is swept, the substrate the
port serves), in two modes per worker count:

* ``host`` — the substrate as it runs, each worker dispatching on its own
  CUDA stream;
* ``emulated`` — the service's ``device_latency_s`` holds each batch on
  the card for the *measured* mean host-mode batch time
  (``torch.cuda._sleep`` on the batch's stream; ``time.sleep`` on the CPU;
  values untouched), the regime where workers hide the host's work behind
  the device's.

Every row is asserted bit-identical to the single-worker host reference.
The sweep runs in this process: the reference's child process exists only
to turn off XLA:CPU's async dispatch, which has no counterpart here.

Standalone:  PYTHONPATH=src python benchmarks/torch_edge_serving.py
             [--dry-run] [--substrates exact,approx_lut] [--requests 32]
             [--json PATH] [--trace PATH] [--device cpu]
Harness:     python -m benchmarks.torch_run --only serve_edge
"""
from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from repro_torch.data import image_batch
from repro_torch.device import card_name, resolve_device
from repro_torch.obs import (ContractionMeter, MetricsRegistry, Tracer,
                             telemetry_scope, tracing_scope, write_chrome_trace)
from repro_torch.serving import EdgeDetectService

_REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
DEFAULT_JSON = _REPO_ROOT / "BENCH_torch_serving.json"

# (max_batch_size, max_wait_s) flush-policy sweep
SETTINGS = ((1, 0.0), (4, 0.002), (8, 0.002), (8, 0.010))

# The reference's CPU-feasible four plus approx_cuda: the reference leaves
# out its bit-exact backends because Pallas interpret mode is orders slower
# on its CPU; here approx_cuda is the substrate the port serves, on the
# card its fused conv kernel. The full registry is reachable via
# --substrates.
DEFAULT_SUBSTRATES = ("exact", "int8", "approx_lut", "approx_stat",
                      "approx_cuda")

#: worker counts for the throughput-vs-worker-count table
WORKER_COUNTS = (1, 2, 4)

#: flush policy used by the worker sweep (batch 4 → several in-flight
#: batches even for modest request streams)
WORKER_SWEEP_BATCH = 4


def _serve_once(spec: str, max_batch: int, max_wait_s: float,
                imgs, device) -> dict:
    svc = EdgeDetectService(spec, device=device, max_batch_size=max_batch,
                            max_wait_s=max_wait_s)
    try:
        svc.detect(imgs[:1])           # warmup: first dispatch of the shape
        svc.metrics.reset()
        svc.detect(list(imgs))
        return svc.stats()
    finally:
        svc.close()


def _serve_workers(spec: str, imgs, n_workers: int,
                   device_latency_s: float, device, ref=None):
    """One worker-sweep cell: stats, outputs, bit-identity vs ``ref``."""
    svc = EdgeDetectService(spec, device=device,
                            max_batch_size=WORKER_SWEEP_BATCH,
                            n_workers=n_workers,
                            device_latency_s=device_latency_s)
    try:
        svc.detect(imgs[:1])           # warmup: first dispatch of the shape
        svc.metrics.reset()
        out = svc.detect(list(imgs))
        identical = ref is None or (
            len(out) == len(ref)
            and all(np.array_equal(a, b) for a, b in zip(ref, out)))
        return svc.stats(), out, identical
    finally:
        svc.close()


def worker_sweep(spec: str, imgs, workers=WORKER_COUNTS,
                 device="cuda") -> dict:
    """Throughput vs worker count, host + emulated-device modes.

    Returns the ``worker_sweep`` record for ``BENCH_torch_serving.json``
    and prints the table. Every cell must be bit-identical to the
    single-worker host reference."""
    device = resolve_device(str(device))
    print(f"\n== edge serving: throughput vs workers ({spec}) ==")
    print(f"{'mode':>9s} {'workers':>7s} {'img/s':>8s} {'speedup':>7s} "
          f"{'p50_ms':>7s} {'inflight_peak':>13s} {'identical':>9s}")
    rows = []
    base = {}
    # host mode: the substrate as served; also yields the bit-identity
    # reference and the emulated-device latency calibration (mean batch
    # busy time)
    ref = None
    cal_s = 0.0
    for w in workers:
        s, out, identical = _serve_workers(spec, imgs, w, 0.0, device, ref=ref)
        if ref is None:
            ref = out
            batches = sum(s["worker_batches"].values()) or 1
            busy = sum(float(v)
                       for v in s["worker_busy_seconds"].values())
            # floor: the emulated stage must dominate the host's per-batch
            # overhead, or it measures the host, not the device
            cal_s = max(busy / batches, 4e-3)
        rows.append(("host", w, s, identical))
    # emulated mode: device as slow as the measured host batch time
    for w in workers:
        s, _, identical = _serve_workers(spec, imgs, w, cal_s, device, ref=ref)
        rows.append(("emulated", w, s, identical))
    out_rows = []
    for mode, w, s, identical in rows:
        thrpt = s["throughput_rps"]
        if w == workers[0]:
            base[mode] = thrpt
        speedup = thrpt / base[mode] if base[mode] > 0 else float("inf")
        print(f"{mode:>9s} {w:>7d} {thrpt:>8.1f} {speedup:>6.2f}x "
              f"{s['latency_p50_ms']:>7.2f} {s['inflight_peak']:>13d} "
              f"{str(identical):>9s}")
        out_rows.append({
            "mode": mode, "workers": w,
            "throughput_img_s": round(thrpt, 2),
            "speedup_vs_1": round(speedup, 3),
            "latency_p50_ms": round(s["latency_p50_ms"], 3),
            "inflight_peak": s["inflight_peak"],
            "worker_batches": s["worker_batches"],
            "bit_identical_to_1worker": bool(identical),
        })
    assert all(r["bit_identical_to_1worker"] for r in out_rows), \
        f"worker sweep of {spec}: a row differs from the 1-worker host maps"
    return {
        "spec": spec,
        "max_batch": WORKER_SWEEP_BATCH,
        "requests": len(imgs),
        "emulated_device_latency_ms": round(cal_s * 1e3, 3),
        "device": device.type,
        "rows": out_rows,
    }


def run(substrates=None, dry_run: bool = False, n_requests: int = 32,
        json_path=DEFAULT_JSON, trace_path=None, device="cuda") -> list:
    device = resolve_device(str(device))
    specs = list(substrates) if substrates else list(DEFAULT_SUBSTRATES)
    settings = SETTINGS
    worker_counts = WORKER_COUNTS
    if dry_run:
        specs, settings, n_requests = specs[:1], SETTINGS[1:2], 6
        worker_counts = (1, 2)
    imgs = image_batch(n_requests, 32, 32, noise=1.5)

    tracer = Tracer() if trace_path else None
    meter = ContractionMeter(MetricsRegistry())
    rows = []
    records: list[dict] = []
    print("\n== edge serving: throughput vs {substrate, batch, timeout} ==")
    print(f"{'substrate':>16s} {'batch':>5s} {'wait_ms':>7s} {'img/s':>8s} "
          f"{'p50_ms':>7s} {'p95_ms':>7s} {'occ':>5s}")
    with tracing_scope(tracer), telemetry_scope(meter):
        for spec in specs:
            for max_batch, wait_s in settings:
                s = _serve_once(spec, max_batch, wait_s, imgs, device)
                assert s["requests_served"] == n_requests, s
                thrpt = s["throughput_rps"]
                us = 1e6 / thrpt if thrpt > 0 else float("inf")
                print(f"{spec:>16s} {max_batch:>5d} {wait_s * 1e3:>7.1f} "
                      f"{thrpt:>8.1f} {s['latency_p50_ms']:>7.2f} "
                      f"{s['latency_p95_ms']:>7.2f} "
                      f"{s['mean_occupancy']:>5.2f}")
                rows.append((
                    f"serve_edge/{spec}/b{max_batch}/w{wait_s * 1e3:g}ms", us,
                    f"thrpt={thrpt:.1f}img/s "
                    f"p50={s['latency_p50_ms']:.2f}ms "
                    f"p95={s['latency_p95_ms']:.2f}ms "
                    f"p99={s['latency_p99_ms']:.2f}ms "
                    f"occ={s['mean_occupancy']:.2f}"))
                records.append({
                    "spec": spec, "max_batch": max_batch,
                    "max_wait_ms": wait_s * 1e3,
                    "requests": n_requests,
                    "throughput_img_s": round(thrpt, 2),
                    "latency_p50_ms": round(s["latency_p50_ms"], 3),
                    "latency_p95_ms": round(s["latency_p95_ms"], 3),
                    "latency_p99_ms": round(s["latency_p99_ms"], 3),
                    "mean_occupancy": round(s["mean_occupancy"], 3),
                    "batches_flushed": s["batches_flushed"],
                    "batches_by_reason": s["batches_by_reason"],
                    "compiled_calls": s["compiled_calls"],
                })

        # throughput-vs-worker-count table on the port's served substrate
        sweep_spec = next((s for s in ("approx_cuda", "approx_lut")
                           if s in specs), specs[0])
        sweep = worker_sweep(sweep_spec, list(imgs), workers=worker_counts,
                             device=device)
        for row in sweep["rows"]:
            rows.append((
                f"serve_edge/{sweep_spec}/workers{row['workers']}"
                f"/{row['mode']}",
                1e6 / row["throughput_img_s"]
                if row["throughput_img_s"] > 0 else float("inf"),
                f"thrpt={row['throughput_img_s']:.1f}img/s "
                f"speedup={row['speedup_vs_1']:.2f}x "
                f"inflight_peak={row['inflight_peak']} "
                f"identical={row['bit_identical_to_1worker']}"))

    if json_path:
        payload = {
            "bench": "torch_edge_serving",
            "backend": device.type,
            "card": card_name() if device.type == "cuda" else None,
            "dry_run": bool(dry_run),
            "image_shape": [32, 32],
            "records": records,
            "worker_sweep": sweep,
            # ambient-meter rollup over the whole sweep (includes warmup):
            # per-spec contraction counts, MACs, estimated energy in fJ
            "substrate_meter": meter.summary(),
        }
        pathlib.Path(json_path).write_text(json.dumps(payload, indent=1)
                                           + "\n")
        print(f"\nwrote {len(records)} records to {json_path}")
    if trace_path:
        p = write_chrome_trace(tracer, trace_path)
        print(f"wrote {len(tracer.events())} trace events to {p}")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dry-run", action="store_true",
                    help="single tiny configuration (CI wiring check)")
    ap.add_argument("--substrates", default=None,
                    help="CSV of substrate specs (default: the reference's "
                         "four and approx_cuda)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--json", default=str(DEFAULT_JSON), dest="json_path",
                    help="output path for BENCH_torch_serving.json "
                         "('' disables)")
    ap.add_argument("--trace", default=None, dest="trace_path",
                    help="write a Chrome/Perfetto trace of the serving spans")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the "
                         "kernels' plain versions)")
    args = ap.parse_args()
    substrates = args.substrates.split(",") if args.substrates else None
    rows = run(substrates=substrates, dry_run=args.dry_run,
               n_requests=args.requests, json_path=args.json_path or None,
               trace_path=args.trace_path, device=args.device)
    print("\nname,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
