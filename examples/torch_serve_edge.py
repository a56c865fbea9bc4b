"""Serve edge-detection requests through the port's micro-batching service.

The counterpart of ``examples/serve_edge.py``: queues a stream of
mixed-shape images into an ``EdgeDetectService`` on a chosen product
substrate, on ``--device`` (the card unless ``--device cpu``; no card
raises), verifies every served edge map is bit-identical to the direct
batched pipeline, and prints the telemetry table (throughput, latency
percentiles, batch occupancy).

The default substrate is ``approx_cuda`` (the reference's is
``approx_bitexact``, a plain emulation in either package): the port serves
the paper's multiplier through its fused conv kernel on the card, and
through that kernel's plain version with ``--device cpu``.

``--metrics-out`` dumps the combined metrics registry (serving counters +
per-contraction substrate meters; ``.prom``/``.txt`` → Prometheus text,
else JSON) and ``--trace-out`` records the serving spans (queue wait, pad,
compile, execute, wait, crop) as a Chrome/Perfetto trace.

``--workers N`` serves through N concurrent batcher workers, each
dispatching on its own CUDA stream (batch k+1 is enqueued while batch k
runs); outputs stay bit-identical at every worker count. ``--sharded``
partitions the served contractions over the ``("data", "model")`` mesh of
the ranks ``torchrun`` starts (a world of one without it; ``--backend
gloo``, the default: ``nccl`` is refused until a machine with a card a
rank has run it): rank 0 serves and checks the maps,
the other ranks follow its batches. Run as a script, rank 0's last line is
a JSON object of the requests served, the throughput and the p50 / p99
latency.

Run:  PYTHONPATH=src python examples/torch_serve_edge.py [--smoke]
      [--substrate approx_lut:design_du2022] [--requests 24]
      [--workers 4] [--device cpu]
      [--metrics-out serve.json] [--trace-out trace.json]
      python -m torch.distributed.run --nproc-per-node 2 \
          examples/torch_serve_edge.py --sharded
"""
import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.data import mixed_shape_batch
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn import conv
from repro_torch.obs import (ContractionMeter, MetricsRegistry, Tracer,
                             telemetry_scope, tracing_scope, write_chrome_trace,
                             write_metrics)
from repro_torch.serving import EdgeDetectService
from repro_torch.serving.metrics import ServingMetrics


def main(argv=None) -> dict:
    """Run the example; returns the images, the served maps and the stats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--substrate", default="approx_cuda",
                    help="ProductSubstrate spec (e.g. approx_cuda, "
                         "approx_lut:design_du2022)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--workers", type=int, default=1,
                    help="batcher worker threads, each on its own CUDA "
                         "stream (dispatch of batch k+1 overlaps batch k)")
    ap.add_argument("--sharded", action="store_true",
                    help="partition the served contractions over the debug "
                         "mesh of the ranks torchrun starts")
    ap.add_argument("--backend", choices=mesh_lib.BACKENDS, default="gloo",
                    help="process-group backend under --sharded")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fast run for CI (few small images)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the "
                         "kernels' plain versions)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the combined metrics registry (.prom/.txt → "
                         "Prometheus text, else JSON)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace-event JSON of the "
                         "serving spans")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    partitioning, owns_group = None, False
    if args.sharded:
        owns_group = not dist.is_initialized()
        mesh_lib.init_ranks(args.backend)
        device = mesh_lib.rank_device(device.type)
        partitioning = mesh_lib.contraction_partitioning(
            mesh_lib.make_debug_mesh())

    if args.smoke:
        args.requests = 6
        imgs = mixed_shape_batch(args.requests,
                                 shapes=((16, 16), (24, 31), (32, 32)))
    else:
        imgs = mixed_shape_batch(args.requests, noise=2.0)

    # one shared registry: serving counters + substrate meters, one dump
    registry = MetricsRegistry()
    meter = ContractionMeter(registry)
    tracer = Tracer() if args.trace_out else None
    with tracing_scope(tracer), telemetry_scope(meter):
        svc = EdgeDetectService(args.substrate, device=device,
                                max_batch_size=args.max_batch,
                                max_wait_s=args.max_wait_ms * 1e-3,
                                n_workers=args.workers,
                                partitioning=partitioning,
                                metrics=ServingMetrics(registry=registry))
        if not svc.leader:  # follow rank 0's batches until it stops
            svc.close()
            if owns_group:
                dist.destroy_process_group()
            return {"images": imgs, "outputs": None, "stats": None,
                    "meter": meter.summary(), "spec": svc.spec,
                    "followed": svc.followed}
        sharded = (f", sharded over {dist.get_world_size()} rank(s), "
                   f"backend {dist.get_backend()}" if args.sharded else "")
        print(f"serving {len(imgs)} mixed-shape images on "
              f"substrate={svc.spec!r} (max_batch={args.max_batch}, "
              f"max_wait={args.max_wait_ms}ms, workers={args.workers}, "
              f"device={device.type}{sharded})")

        outs = svc.detect(imgs)
        svc.close()
    if owns_group:
        dist.destroy_process_group()

    # every served map must be bit-identical to the direct batched pipeline
    for im, out in zip(imgs, outs):
        direct = conv.edge_detect_batched(
            torch.from_numpy(im[None]).to(device), svc.substrate)[0]
        assert out.shape == im.shape and np.array_equal(
            out, direct.cpu().numpy()), \
            f"service output diverged from edge_detect_batched at {im.shape}"
    shapes = sorted({im.shape for im in imgs})
    print(f"served == direct edge_detect_batched (bit-identical) across "
          f"{len(shapes)} shapes: OK")
    print(f"compiled bucket shapes: {list(svc.compiled_shapes)}")
    print()
    print(svc.metrics.format_table())
    summary = meter.summary()
    if summary:
        print()
        for spec, row in sorted(summary.items()):
            print(f"meter      {spec}: {row['contractions']} contractions, "
                  f"{row['macs']} MACs, "
                  f"{row['energy_pdp_fj'] / 1e6:.2f} nJ est.")
    if args.metrics_out:
        p = write_metrics(registry, args.metrics_out,
                          extra={"substrate_meter": summary})
        print(f"metrics -> {p}")
    if args.trace_out:
        p = write_chrome_trace(tracer, args.trace_out)
        print(f"trace -> {p} ({len(tracer.events())} events)")
    return {"images": imgs, "outputs": outs, "stats": svc.stats(),
            "meter": summary, "spec": svc.spec}


if __name__ == "__main__":
    stats = main()["stats"]
    if stats is not None:  # rank 0, or the only one
        print(json.dumps({k: stats[k] for k in (
            "requests_served", "throughput_rps", "latency_p50_ms",
            "latency_p99_ms")}))
