"""Edge-detection serving: dynamic micro-batching over the substrate registry.

Counterpart of ``repro.serving.edge_service``. :class:`EdgeDetectService`
queues single uint8 images, buckets them by padded shape, and drains each
bucket through :func:`repro_torch.nn.conv.edge_detect_batched` on a
registered substrate spec (``"approx_cuda"``, ``"approx_cuda:csp_axc1@4"``,
``"approx_lut:design_du2022"``, …), or through
:func:`repro_torch.nn.conv.edge_detect_planned` under a per-site
:class:`~repro_torch.nn.plan.SubstratePlan`.

Bit-identity contract: a served edge map equals the direct
``edge_detect_batched(img[None], substrate)[0]`` (or
``edge_detect_planned(img[None], plan)[0]``) exactly, for every
substrate and plan. Padding preserves this because images are zero-embedded
at the top-left of the bucket shape, which is indistinguishable (to the
'same' convolution taps of every kept pixel) from the zero border the direct
path applies — the kernels multiply those zeros too, f(0, c) included — and
every contraction is independent per output pixel. Results are cropped back
to the request shape.

Device: ``device=None`` means ``"cuda"``; only an explicit ``device="cpu"``
runs the plain versions. On the card, ``_process`` copies the padded batch
from pinned host memory on the worker's own CUDA stream, launches the
pipeline, starts the device→host copy and records an event; ``_finalize``
waits on that event and crops. With ``n_workers > 1`` the next batch's
dispatch overlaps this batch's device work.

Partitioned serving (``partitioning=``, a
:class:`~repro_torch.nn.substrate.Partitioning`): the pipeline's
contractions shard over the mesh, one process per rank, and every rank
builds the service with its own device and the same partitioning. Batches
form by time, so the ranks would form different ones: rank 0 alone runs the
batcher and, before each batch it executes, broadcasts the batch's shape
and then its pixels over the default process group; every other rank runs
a follower thread that receives them and executes the same pipeline calls
in the same order, until the stop message that rank 0's :meth:`close`
broadcasts. Collectives issued from several worker threads would reach the
ranks in different orders, so rank 0 serializes its partitioned executes
under one lock (its workers still overlap padding and delivery). Requests
are submitted on rank 0; a follower's :meth:`close` waits for the stop.

Shape cache: nothing is compiled per shape in eager PyTorch, but the
service keeps ``compiled_shapes`` and records ``metrics.record_compile()``
on the first dispatch of each padded (batch, H, W) shape, so its metrics
match the JAX service's. The batch dimension is padded to
``max_batch_size`` like the reference's.
"""
from __future__ import annotations

import threading
import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.nn import collectives as coll
from repro_torch.nn import conv
from repro_torch.nn import plan as plan_mod
from repro_torch.nn import substrate as sub
from repro_torch.obs.trace import trace_span
from repro_torch.serving.batcher import MicroBatcher, Ticket
from repro_torch.serving.metrics import ServingMetrics


def _ceil_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


class EdgeDetectService:
    """Micro-batched Laplacian edge detection on one product substrate
    (or a per-tap-group :class:`~repro_torch.nn.plan.SubstratePlan`).

    substrate:          spec string, substrate instance, or a
                        :class:`~repro_torch.nn.plan.SubstratePlan` (or its
                        dict schema) assigning specs to the edge tap-group
                        sites ``conv.edge.center`` / ``conv.edge.ring`` —
                        plans serve through
                        :func:`repro_torch.nn.conv.edge_detect_planned`.
    device:             ``None`` (→ ``"cuda"``), ``"cuda[:i]"`` or ``"cpu"``.
    max_batch_size:     flush a shape bucket at this many images.
    max_wait_s:         flush a partial bucket once its oldest image has
                        waited this long.
    bucket_granularity: H and W are rounded up to this multiple to form the
                        bucket key (1 = exact-shape buckets, no padding).
    pad_batches:        pad the batch dim to max_batch_size.
    n_workers:          worker threads draining the bucketed queue; each
                        dispatches on its own CUDA stream.
    device_latency_s:   emulated extra device latency per batch:
                        ``torch.cuda._sleep`` on the batch's stream on the
                        card, ``time.sleep`` on the CPU. Values pass through
                        unchanged. ``0`` adds nothing.
    partitioning:       optional
                        :class:`~repro_torch.nn.substrate.Partitioning`:
                        shard every contraction over its mesh (rank 0
                        serves, the other ranks follow; see the module
                        docstring). The maps are bit-identical to the
                        unsharded ones for bit-exact substrates.
    """

    def __init__(self, substrate="approx_bitexact", *, device=None,
                 max_batch_size: int = 8, max_wait_s: float = 2e-3,
                 bucket_granularity: int = 16, pad_batches: bool = True,
                 n_workers: int = 1, device_latency_s: float = 0.0,
                 partitioning=None, metrics: Optional[ServingMetrics] = None,
                 start: bool = True):
        if bucket_granularity < 1:
            raise ValueError(
                f"bucket_granularity must be >= 1, got {bucket_granularity}")
        if device_latency_s < 0:
            raise ValueError(
                f"device_latency_s must be >= 0, got {device_latency_s}")
        if partitioning is not None and not isinstance(partitioning,
                                                       sub.Partitioning):
            raise TypeError(
                "partitioning must be a repro_torch.nn.substrate.Partitioning, "
                f"got {type(partitioning).__name__}")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "EdgeDetectService runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run the plain versions")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {self.device}")
        if isinstance(substrate, (plan_mod.SubstratePlan, dict)):
            self.plan = plan_mod.as_plan(substrate)
            self.substrate = sub.get_substrate(self.plan.default)
            self.spec = self.plan.label
        else:
            self.plan = None
            self.substrate = sub.as_substrate(substrate)
            self.spec = self.substrate.meta.spec
        self.bucket_granularity = bucket_granularity
        self.pad_batches = pad_batches
        self.device_latency_s = device_latency_s
        self.metrics = metrics or ServingMetrics()
        self.partitioning = partitioning
        self.leader = (partitioning is None
                       or torch.distributed.get_rank() == 0)
        self._exec_lock = threading.Lock()  # one partitioned execute at a time
        self._follower: Optional[threading.Thread] = None
        self._follow_error: Optional[BaseException] = None
        self.followed = 0  # batches a follower rank executed
        self._compiled_keys = set()  # (batch, H, W) shapes dispatched so far
        self._compiled_lock = threading.Lock()  # workers race on new shapes
        self._local = threading.local()  # per-worker CUDA stream
        self._sleep_cycles = 0
        if self.device.type == "cuda" and device_latency_s > 0:
            self._sleep_cycles = int(device_latency_s * self._cycles_per_s())
        self.batcher = MicroBatcher(
            self._process, max_batch_size=max_batch_size,
            max_wait_s=max_wait_s, bucket_fn=self._bucket,
            finalize_fn=self._finalize, n_workers=n_workers,
            metrics=self.metrics)
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Start serving: the batcher on rank 0 (or without a
        partitioning), the follower thread on the other ranks."""
        if self.leader:
            self.batcher.start()
        elif self._follower is None:
            self._follower = threading.Thread(target=self._follow,
                                              name="edge-follower", daemon=True)
            self._follower.start()

    def close(self, drain: bool = True) -> None:
        """Stop serving. Under a partitioning rank 0 then tells the other
        ranks to stop, and a follower waits for that."""
        if self.leader:
            self.batcher.stop(drain=drain)
            if self.partitioning is not None:
                with self._exec_lock:
                    coll.broadcast_host(torch.zeros(4, dtype=torch.int64), None)
            return
        if self._follower is not None:
            self._follower.join()
            self._follower = None
        if self._follow_error is not None:
            err, self._follow_error = self._follow_error, None
            raise err

    def _follow(self) -> None:
        """A follower rank's loop: receive each batch rank 0 executes and
        run the same pipeline on it, until the stop message."""
        try:
            while True:
                head = coll.broadcast_host(torch.zeros(4, dtype=torch.int64),
                                           None)
                if int(head[0]) == 0:
                    return
                host = torch.empty(tuple(head[1:].tolist()), dtype=torch.uint8)
                coll.broadcast_host(host, None)
                if self.device.type == "cuda":
                    with torch.cuda.device(self.device):
                        self._compute(host.to(self.device))
                        torch.cuda.synchronize(self.device)
                else:
                    self._compute(host)
                self.followed += 1
        except BaseException as e:  # re-raised by close()
            self._follow_error = e

    def __enter__(self) -> "EdgeDetectService":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request path --------------------------------------------------------

    def _cycles_per_s(self) -> float:
        """GPU clock cycles per second of ``torch.cuda._sleep``, timed once
        with CUDA events (the spin counts SM clock cycles)."""
        cycles = 10_000_000
        with torch.cuda.device(self.device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda._sleep(cycles)
            end.record()
            end.synchronize()
            return cycles / (start.elapsed_time(end) * 1e-3)

    def _stream(self) -> torch.cuda.Stream:
        s = getattr(self._local, "stream", None)
        if s is None:
            s = self._local.stream = torch.cuda.Stream(device=self.device)
        return s

    def _bucket(self, img: np.ndarray) -> Tuple[int, int]:
        h, w = img.shape
        g = self.bucket_granularity
        return (_ceil_to(h, g), _ceil_to(w, g))

    def _process(self, bucket: Tuple[int, int], imgs: List[np.ndarray]):
        """Dispatch phase: pad to the bucket shape and launch the pipeline
        without waiting for it — :meth:`_finalize` waits."""
        hh, ww = bucket
        b = len(imgs)
        bp = self.batcher.max_batch_size if self.pad_batches else b
        with trace_span("edge.pad", "serving", bucket=f"{hh}x{ww}", size=b):
            batch = np.zeros((bp, hh, ww), np.uint8)
            for i, im in enumerate(imgs):
                h, w = im.shape
                batch[i, :h, :w] = im
        shape = "x".join(map(str, batch.shape))
        with self._compiled_lock:
            first = batch.shape not in self._compiled_keys
            if first:
                self._compiled_keys.add(batch.shape)
        if first:
            self.metrics.record_compile()
        span = "edge.compile" if first else "edge.execute"
        with trace_span(span, "serving", shape=shape, spec=self.spec):
            inflight = self._dispatch(torch.from_numpy(batch))
        return inflight, [im.shape for im in imgs]

    def _compute(self, batch: torch.Tensor) -> torch.Tensor:
        """The edge-detect pipeline on a uint8 batch on the service's device."""
        if self.plan is not None:
            return conv.edge_detect_planned(batch, self.plan,
                                             partitioning=self.partitioning)
        return conv.edge_detect_batched(batch, self.substrate,
                                        partitioning=self.partitioning)

    def _execute(self, batch: torch.Tensor, host: torch.Tensor) -> torch.Tensor:
        """:meth:`_compute` on ``batch``; under a partitioning, rank 0 first
        sends the followers its shape and pixels ``host``, all under the
        execute lock."""
        if self.partitioning is None:
            return self._compute(batch)
        with self._exec_lock:
            coll.broadcast_host(torch.tensor((1,) + tuple(host.shape),
                                             dtype=torch.int64), None)
            coll.broadcast_host(host, None)
            return self._compute(batch)

    def _dispatch(self, host: torch.Tensor):
        """Run the pipeline on ``host`` (a uint8 CPU batch). CPU: returns the
        finished map. CUDA: returns (pinned host output, event, tensors to
        keep alive until the event) with the copies and kernels enqueued on
        this worker's stream."""
        if self.device.type == "cpu":
            out = self._execute(host, host)
            if self.device_latency_s > 0:
                time.sleep(self.device_latency_s)
            return out, None, ()
        stream = self._stream()
        pinned = host.pin_memory()
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            dev = pinned.to(self.device, non_blocking=True)
            out = self._execute(dev, host)
            if self._sleep_cycles:
                torch.cuda._sleep(self._sleep_cycles)
            out_host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            out_host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return out_host, done, (pinned, dev, out)

    def _finalize(self, bucket: Tuple[int, int], raw) -> List[np.ndarray]:
        """Delivery phase: wait for the dispatched batch, then crop each map
        back to its request shape."""
        (out, done, _keep), shapes = raw
        with trace_span("edge.wait", "serving", size=len(shapes)):
            if done is not None:
                done.synchronize()
            out = out.numpy()
        with trace_span("edge.crop", "serving", size=len(shapes)):
            return [out[i, :h, :w] for i, (h, w) in enumerate(shapes)]

    @staticmethod
    def _check_image(img) -> np.ndarray:
        a = np.asarray(img)
        if a.ndim != 2 or a.dtype != np.uint8:
            raise ValueError(
                f"expected a single (H, W) uint8 image, got {a.dtype} "
                f"array of shape {a.shape}")
        return a

    def _require_leader(self) -> None:
        if not self.leader:
            raise RuntimeError(
                f"rank {torch.distributed.get_rank()} follows rank 0 under a "
                "partitioning: submit requests on rank 0")

    def submit(self, img: np.ndarray) -> Ticket:
        """Queue one (H, W) uint8 image; returns a Ticket (``.result()``)."""
        self._require_leader()
        return self.batcher.submit(self._check_image(img))

    def detect(self, imgs: "np.ndarray | Iterable[np.ndarray]",
               timeout: Optional[float] = 60.0) -> List[np.ndarray]:
        """Submit image(s) and block for the edge maps, preserving order.

        Accepts one (H, W) image, a (B, H, W) stack, or an iterable of
        arbitrary-shape (H, W) images.
        """
        self._require_leader()
        if isinstance(imgs, np.ndarray) and imgs.ndim == 2:
            imgs = [imgs]
        tickets = self.batcher.submit_many(
            self._check_image(im) for im in imgs)
        if not self.batcher.running:
            self.batcher.flush()
        return [t.result(timeout=timeout) for t in tickets]

    # -- introspection -------------------------------------------------------

    @property
    def n_workers(self) -> int:
        return self.batcher.n_workers

    @property
    def compiled_shapes(self) -> Sequence[Tuple[int, int, int]]:
        """(batch, H, W) shapes the service has dispatched."""
        with self._compiled_lock:
            return tuple(sorted(self._compiled_keys))

    def stats(self) -> dict:
        return self.metrics.snapshot()
