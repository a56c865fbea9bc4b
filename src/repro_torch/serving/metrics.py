"""Serving telemetry: counters, latency percentiles, occupancy histogram.

One :class:`ServingMetrics` instance is shared by a batcher and the service
draining it, so every layer (enqueue, flush, compile, completion) records
into the same snapshot. All methods are thread-safe — the batcher worker and
submitting threads hit them concurrently.

A copy of ``repro.serving.metrics`` with the same ``serving_*`` family
names. The counters live in a
:class:`repro_torch.obs.registry.MetricsRegistry`, so a serving process
exports one combined Prometheus/JSON dump by passing a shared registry. The
historical attributes (``requests_served``,
``batches_by_reason``, ``occupancy_hist``, ...) are read-only properties
over the registry, and ``snapshot()``/``format_table()`` render the same
shapes as before. Latencies additionally feed a bounded reservoir (uniform
replacement past the cap) so a long-running service reports stable
percentiles at O(1) memory — the registry histogram holds the cumulative
bucket view for export, the reservoir answers ``latency_percentile``.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Dict, Optional

from repro_torch.obs.registry import MetricsRegistry

_RESERVOIR_CAP = 8192

#: latency bucket bounds (seconds) for the exported histogram.
_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class ServingMetrics:
    """Counters + latency/occupancy telemetry for a serving pipeline.

    ``registry``: optional shared :class:`MetricsRegistry`; by default each
    instance owns a private one. Two instances recording into the *same*
    registry share series (their counts merge) — share a registry for one
    combined export, not for isolation.

    Flush reasons (``batches_by_reason``):

    * ``"size"``    — bucket reached ``max_batch_size``;
    * ``"timeout"`` — oldest request exceeded ``max_wait_s``;
    * ``"drain"``   — explicit flush/stop drained a partial bucket.
    """

    def __init__(self, clock=time.perf_counter,
                 registry: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        self._clock = clock
        self._rng = random.Random(0)
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._enqueued = r.counter("serving_requests_enqueued_total",
                                   "requests submitted to the batcher")
        self._served = r.counter("serving_requests_served_total",
                                 "requests completed successfully")
        self._failed = r.counter("serving_requests_failed_total",
                                 "requests completed with an error")
        self._batches = r.counter("serving_batches_flushed_total",
                                  "batches flushed, by flush reason",
                                  ("reason",))
        self._compiles = r.counter("serving_compiled_calls_total",
                                   "first dispatches of a new padded batch shape")
        self._depth = r.gauge("serving_queue_depth",
                              "requests waiting in the batcher queue")
        self._depth_peak = r.gauge("serving_queue_depth_peak",
                                   "high-water mark of the batcher queue")
        self._batch_sizes = r.counter("serving_batch_size_total",
                                      "batches flushed, by actual size",
                                      ("size",))
        self._slots_used = r.counter("serving_batch_slots_used_total",
                                     "sum of actual batch sizes")
        self._slots_total = r.counter("serving_batch_slots_total",
                                      "sum of max_batch_size over flushes")
        self._latency = r.histogram("serving_request_latency_seconds",
                                    "request latency (enqueue to done)",
                                    buckets=_LATENCY_BUCKETS)
        self._worker_batches = r.counter("serving_worker_batches_total",
                                         "batches served, by worker",
                                         ("worker",))
        self._worker_busy = r.counter("serving_worker_busy_seconds_total",
                                      "seconds spent serving batches, by "
                                      "worker (occupancy = busy / wall)",
                                      ("worker",))
        self._worker_errors = r.counter("serving_worker_errors_total",
                                        "per-payload failures isolated on a "
                                        "worker, by worker",
                                        ("worker",))
        self._inflight = r.gauge("serving_inflight_batches",
                                 "batches dispatched but not yet finalized "
                                 "(device-utilization proxy)")
        self._inflight_peak = r.gauge("serving_inflight_batches_peak",
                                      "high-water mark of concurrently "
                                      "in-flight batches")
        self.reset()

    def reset(self) -> None:
        """Zero every counter and restart the throughput clock (benchmarks
        call this after warmup so compiles don't pollute the measurement).

        Resets only this instance's ``serving_*`` families — other
        recorders in a shared registry are untouched."""
        with self._lock:
            self.started_at = self._clock()
            self._latencies: list[float] = []          # seconds, reservoir
            self._latency_count = 0
        for fam in (self._enqueued, self._served, self._failed, self._batches,
                    self._compiles, self._depth, self._depth_peak,
                    self._batch_sizes, self._slots_used, self._slots_total,
                    self._latency, self._worker_batches, self._worker_busy,
                    self._worker_errors, self._inflight, self._inflight_peak):
            fam.reset()

    # -- recording -----------------------------------------------------------

    def record_enqueue(self, depth: int) -> None:
        self._enqueued.inc()
        self._depth.set(depth)
        self._depth_peak.set_max(depth)

    def record_batch(self, size: int, reason: str,
                     max_batch_size: int) -> None:
        self._batches.labels(reason=reason).inc()
        self._batch_sizes.labels(size=size).inc()
        self._slots_used.inc(size)
        self._slots_total.inc(max_batch_size)

    def record_done(self, latency_s: float, ok: bool = True,
                    depth: Optional[int] = None) -> None:
        (self._served if ok else self._failed).inc()
        if depth is not None:
            self._depth.set(depth)
        self._latency.observe(latency_s)
        with self._lock:
            self._latency_count += 1
            if len(self._latencies) < _RESERVOIR_CAP:
                self._latencies.append(latency_s)
            else:  # uniform reservoir replacement
                j = self._rng.randrange(self._latency_count)
                if j < _RESERVOIR_CAP:
                    self._latencies[j] = latency_s

    def record_compile(self) -> None:
        self._compiles.inc()

    def record_worker_batch(self, worker: str, busy_s: float) -> None:
        """One batch served end-to-end by ``worker`` in ``busy_s`` seconds."""
        self._worker_batches.labels(worker=str(worker)).inc()
        self._worker_busy.labels(worker=str(worker)).inc(max(0.0, busy_s))

    def record_worker_error(self, worker: str) -> None:
        """One payload failed (and was isolated) on ``worker``."""
        self._worker_errors.labels(worker=str(worker)).inc()

    def record_inflight(self, delta: int) -> None:
        """Batch entered (+1) / left (-1) the dispatched-not-finalized window."""
        self._inflight.inc(delta)
        if delta > 0:
            self._inflight_peak.set_max(self._inflight.value())

    # -- historical attribute surface (read-only, registry-backed) -----------

    @property
    def requests_enqueued(self) -> int:
        return int(self._enqueued.value())

    @property
    def requests_served(self) -> int:
        return int(self._served.value())

    @property
    def requests_failed(self) -> int:
        return int(self._failed.value())

    @property
    def batches_flushed(self) -> int:
        return sum(int(v) for _, v in self._batches.samples())

    @property
    def batches_by_reason(self) -> Dict[str, int]:
        return {labels["reason"]: int(v)
                for labels, v in self._batches.samples()}

    @property
    def compiled_calls(self) -> int:
        return int(self._compiles.value())

    @property
    def queue_depth(self) -> int:
        return int(self._depth.value())

    @property
    def queue_depth_peak(self) -> int:
        return int(self._depth_peak.value())

    @property
    def occupancy_hist(self) -> Dict[int, int]:
        return {int(labels["size"]): int(v)
                for labels, v in self._batch_sizes.samples()}

    @property
    def worker_batches(self) -> Dict[str, int]:
        """{worker: batches served} over every worker that served one."""
        return {labels["worker"]: int(v)
                for labels, v in self._worker_batches.samples()}

    @property
    def worker_busy_seconds(self) -> Dict[str, float]:
        return {labels["worker"]: float(v)
                for labels, v in self._worker_busy.samples()}

    @property
    def worker_errors(self) -> int:
        """Total payload failures isolated across all workers."""
        return sum(int(v) for _, v in self._worker_errors.samples())

    @property
    def inflight_batches(self) -> int:
        return int(self._inflight.value())

    @property
    def inflight_peak(self) -> int:
        """Max batches simultaneously dispatched-not-finalized (>1 proves
        batch k+1 was dispatched while batch k still ran)."""
        return int(self._inflight_peak.value())

    # -- derived views -------------------------------------------------------

    def latency_percentile(self, p: float) -> float:
        """p in [0, 100] → latency seconds (0.0 when nothing recorded)."""
        with self._lock:
            lat = sorted(self._latencies)
        if not lat:
            return 0.0
        idx = min(len(lat) - 1, max(0, round(p / 100.0 * (len(lat) - 1))))
        return lat[idx]

    def throughput(self) -> float:
        """Requests served per second of wall clock since construction."""
        with self._lock:  # started_at races with reset() otherwise
            dt = self._clock() - self.started_at
        served = self.requests_served
        return served / dt if dt > 0 else 0.0

    def mean_occupancy(self) -> float:
        """Mean batch fill fraction: Σ size / Σ max_batch over flushes."""
        denom = self._slots_total.value()
        if not denom:
            return 0.0
        return self._slots_used.value() / denom

    def snapshot(self) -> dict:
        """Point-in-time dict of every counter + derived stats (for logs)."""
        base = {
            "requests_enqueued": self.requests_enqueued,
            "requests_served": self.requests_served,
            "requests_failed": self.requests_failed,
            "batches_flushed": self.batches_flushed,
            "batches_by_reason": dict(sorted(
                self.batches_by_reason.items())),
            "compiled_calls": self.compiled_calls,
            "queue_depth": self.queue_depth,
            "queue_depth_peak": self.queue_depth_peak,
            "occupancy_hist": dict(sorted(self.occupancy_hist.items())),
            "worker_batches": dict(sorted(self.worker_batches.items())),
            "worker_busy_seconds": {
                k: round(v, 6)
                for k, v in sorted(self.worker_busy_seconds.items())},
            "worker_errors": self.worker_errors,
            "inflight_peak": self.inflight_peak,
        }
        base["mean_occupancy"] = self.mean_occupancy()
        base["throughput_rps"] = self.throughput()
        for p in (50, 95, 99):
            base[f"latency_p{p}_ms"] = self.latency_percentile(p) * 1e3
        return base

    def format_table(self) -> str:
        """Human-readable multi-line summary (examples / benchmarks)."""
        s = self.snapshot()
        occ = " ".join(f"{k}:{v}" for k, v in s["occupancy_hist"].items()) \
            or "-"
        reasons = " ".join(f"{k}:{v}" for k, v in s["batches_by_reason"].items()) \
            or "-"
        workers = " ".join(f"{k}:{v}"
                           for k, v in s["worker_batches"].items()) or "-"
        return "\n".join([
            f"requests   in={s['requests_enqueued']} "
            f"served={s['requests_served']} failed={s['requests_failed']}",
            f"batches    n={s['batches_flushed']} ({reasons}) "
            f"occupancy={s['mean_occupancy']:.2f} [{occ}]",
            f"queue      depth={s['queue_depth']} peak={s['queue_depth_peak']}",
            f"workers    [{workers}] errors={s['worker_errors']} "
            f"inflight_peak={s['inflight_peak']}",
            f"latency    p50={s['latency_p50_ms']:.2f}ms "
            f"p95={s['latency_p95_ms']:.2f}ms p99={s['latency_p99_ms']:.2f}ms",
            f"throughput {s['throughput_rps']:.1f} req/s "
            f"(compiled_calls={s['compiled_calls']})",
        ])
