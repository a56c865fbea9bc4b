"""Dynamic micro-batching for one-shot requests.

A copy of the :class:`MicroBatcher` half of ``repro.serving.batcher`` (the
LM's ``SlotScheduler`` comes with the LM slice): a thread-safe queue
bucketed by an arbitrary key (shape buckets for vision), flushed when a
bucket reaches ``max_batch_size`` or its oldest request has waited
``max_wait_s``, drained by ``n_workers`` background worker threads. The
vision :class:`~repro_torch.serving.edge_service.EdgeDetectService` runs on
this.

Multi-worker pipeline: every worker loop pops flushable buckets from the
shared queue under one condition variable, so with ``n_workers > 1`` batch
``k+1`` is dispatched while batch ``k`` still runs. Work is split into two
phases to make that overlap real for accelerator backends:

* ``process_fn(bucket_key, payloads) -> raw`` — the *dispatch* phase. It may
  return device work that is still in flight (kernels and copies enqueued
  on a CUDA stream, with an event recorded behind them), so the worker
  releases the device as soon as the computation is enqueued.
* ``finalize_fn(bucket_key, raw) -> results`` — optional *delivery* phase:
  blocks until the dispatched values are ready and materializes one result
  per payload, in order. Without a ``finalize_fn``, ``process_fn`` must
  return the final results itself.

Fault isolation: a failing batch is retried payload-by-payload, so a poison
payload fails only its own ticket (the error re-raises from
``Ticket.result()``), healthy tickets from the same batch still get served,
the worker loop stays alive, and each poisoned payload increments the
``serving_worker_errors_total`` counter. ``process_fn`` must therefore be
safe to re-invoke per payload.

Telemetry goes to :class:`~repro_torch.serving.metrics.ServingMetrics`.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Hashable, Iterable, List, Optional

from repro_torch.obs.trace import current_tracer, trace_span
from repro_torch.serving.metrics import ServingMetrics


# ---------------------------------------------------------------------------
# Dynamic micro-batching (one-shot requests)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Ticket:
    """Handle for one submitted request; ``result()`` blocks until served."""

    payload: Any
    bucket: Hashable
    enqueued_at: float
    _event: threading.Event = dataclasses.field(default_factory=threading.Event)
    _value: Any = None
    _error: Optional[BaseException] = None
    latency_s: Optional[float] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("request not served within timeout")
        if self._error is not None:
            raise self._error
        return self._value


class MicroBatcher:
    """Dynamic micro-batcher: bucketed queue + size/timeout flush policy.

    process_fn(bucket_key, payloads) -> raw
        Called on a worker thread with 1..max_batch_size payloads that share
        a bucket key. With no ``finalize_fn`` it must return one result per
        payload, in order; with one, it may return an opaque in-flight value
        (non-blocking device dispatch) that ``finalize_fn`` materializes.
    finalize_fn(bucket_key, raw) -> results
        Optional delivery phase: blocks on the dispatched value and returns
        one result per payload, in order. Runs on the same worker, but with
        ``n_workers > 1`` another worker dispatches the next batch
        concurrently — host/device overlap.
    bucket_fn(payload) -> hashable
        Bucket assignment (e.g. padded image shape); ``None`` puts everything
        in one bucket. Buckets never mix inside a batch.
    max_wait_s
        A non-full bucket flushes once its *oldest* request has waited this
        long; ``0`` flushes on every worker wakeup (latency-optimal).
    n_workers
        Worker threads draining the queue. Each popped batch is owned end to
        end by one worker; pops are serialized under the queue lock, so
        tickets are never lost, duplicated, or cross-wired regardless of
        worker count.
    """

    def __init__(self, process_fn: Callable[[Hashable, List[Any]], Any],
                 *, max_batch_size: int = 8, max_wait_s: float = 2e-3,
                 bucket_fn: Optional[Callable[[Any], Hashable]] = None,
                 finalize_fn: Optional[Callable[[Hashable, Any], List[Any]]] = None,
                 n_workers: int = 1,
                 metrics: Optional[ServingMetrics] = None,
                 clock=time.perf_counter):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.process_fn = process_fn
        self.finalize_fn = finalize_fn
        self.max_batch_size = max_batch_size
        self.max_wait_s = max_wait_s
        self.n_workers = n_workers
        self.bucket_fn = bucket_fn or (lambda _payload: None)
        self.metrics = metrics or ServingMetrics()
        self._clock = clock
        self._cv = threading.Condition()
        self._buckets: Dict[Hashable, collections.deque] = {}
        self._running = False
        self._stopped = False
        self._threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MicroBatcher":
        with self._cv:
            self._stopped = False
            if self._running:
                return self
            self._running = True
        self._threads = [
            threading.Thread(target=self._worker, args=(i,), daemon=True,
                             name=f"micro-batcher-{i}")
            for i in range(self.n_workers)]
        for t in self._threads:
            t.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop every worker; by default serve everything still queued first.
        Further submissions raise until the batcher is start()ed again."""
        with self._cv:
            self._stopped = True
            was_running = self._running
            self._running = False
            self._cv.notify_all()
        if was_running:
            for t in self._threads:
                t.join()
            self._threads = []
        if drain:
            self._drain_inline()

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission ----------------------------------------------------------

    def submit(self, payload: Any) -> Ticket:
        t = Ticket(payload=payload, bucket=self.bucket_fn(payload),
                   enqueued_at=self._clock())
        with self._cv:
            if self._stopped:
                # a post-stop ticket would sit in the queue forever (no
                # worker, no pending drain) — fail fast instead
                raise RuntimeError("MicroBatcher is stopped; call start()")
            self._buckets.setdefault(t.bucket, collections.deque()).append(t)
            depth = sum(len(q) for q in self._buckets.values())
            self._cv.notify_all()
        self.metrics.record_enqueue(depth)
        return t

    def submit_many(self, payloads: Iterable[Any]) -> List[Ticket]:
        return [self.submit(p) for p in payloads]

    @property
    def depth(self) -> int:
        with self._cv:
            return sum(len(q) for q in self._buckets.values())

    @property
    def running(self) -> bool:
        with self._cv:
            return self._running

    # -- flush policy --------------------------------------------------------

    def _pop_ready_locked(self, now: float, drain: bool):
        """(bucket, tickets, reason) for the most urgent flushable bucket, or
        None. A bucket is flushable when full, expired, or draining; among
        flushable buckets the oldest head wins regardless of trigger, so a
        continuously-full hot bucket cannot starve an expired one past its
        max_wait_s."""
        best = None
        for key, q in self._buckets.items():
            if not q:
                continue
            head = q[0].enqueued_at
            if len(q) >= self.max_batch_size:
                reason = "size"
            elif now - head >= self.max_wait_s:
                reason = "timeout"
            elif drain:
                reason = "drain"
            else:
                continue
            if best is None or head < best[2]:
                best = (key, reason, head)
        if best is None:
            return None
        key, reason, _ = best
        q = self._buckets[key]
        batch = [q.popleft() for _ in range(min(self.max_batch_size, len(q)))]
        if not q:
            del self._buckets[key]
        return key, batch, reason

    def _next_deadline_locked(self) -> Optional[float]:
        heads = [q[0].enqueued_at for q in self._buckets.values() if q]
        return min(heads) + self.max_wait_s if heads else None

    # -- execution -----------------------------------------------------------

    def _invoke(self, key: Hashable, payloads: List[Any], reason: str,
                worker: str) -> List[Any]:
        """One dispatch(+finalize) round for ``payloads``; raises on error.

        The in-flight gauge covers dispatch-to-finalize, so its peak shows
        how many batches genuinely overlapped on the device.
        """
        n = len(payloads)
        self.metrics.record_inflight(+1)
        try:
            with trace_span("batch.process", "serving", bucket=str(key),
                            size=n, reason=reason, worker=worker):
                raw = self.process_fn(key, payloads)
            if self.finalize_fn is not None:
                with trace_span("batch.finalize", "serving", bucket=str(key),
                                size=n, worker=worker):
                    results = self.finalize_fn(key, raw)
            else:
                results = raw
        finally:
            self.metrics.record_inflight(-1)
        if len(results) != n:
            raise RuntimeError(
                f"process_fn returned {len(results)} results for "
                f"{n} payloads (bucket {key!r})")
        return list(results)

    def _run_batch(self, key: Hashable, batch: List[Ticket], reason: str,
                   worker: str):
        """(results, errors) for the batch, isolating poison payloads.

        On a batch failure the payloads are retried one by one, so only the
        ticket(s) whose payload actually raises carry an error — the rest of
        the batch is still served and the worker loop survives.
        """
        try:
            results = self._invoke(key, [t.payload for t in batch], reason,
                                   worker)
            return results, [None] * len(batch)
        except BaseException as batch_err:  # noqa: BLE001 - isolate below
            if len(batch) == 1:
                self.metrics.record_worker_error(worker)
                return [None], [batch_err]
            results, errs = [], []
            for t in batch:
                try:
                    results.append(
                        self._invoke(key, [t.payload], "isolate", worker)[0])
                    errs.append(None)
                except BaseException as e:  # noqa: BLE001 - per-ticket error
                    self.metrics.record_worker_error(worker)
                    results.append(None)
                    errs.append(e)
            return results, errs

    def _serve(self, key: Hashable, batch: List[Ticket], reason: str,
               worker: str = "drain") -> None:
        t_busy = self._clock()
        try:
            self.metrics.record_batch(len(batch), reason, self.max_batch_size)
            tracer = current_tracer()
            if tracer is not None:
                # retroactive span: the head ticket's time in queue. Only
                # meaningful when the batcher runs on the tracer's clock
                # (both default to time.perf_counter).
                head = min(t.enqueued_at for t in batch)
                tracer.event("batch.queue_wait", head, self._clock() - head,
                             "serving", bucket=str(key), size=len(batch),
                             reason=reason, worker=worker)
            results, errs = self._run_batch(key, batch, reason, worker)
        except BaseException as e:  # noqa: BLE001 - telemetry failure: still
            # deliver something so no ticket blocks forever
            results = [None] * len(batch)
            errs = [e] * len(batch)
        now = self._clock()
        depth = self.depth
        for t, r, e in zip(batch, results, errs):
            t._value, t._error = r, e
            t.latency_s = now - t.enqueued_at
            self.metrics.record_done(t.latency_s, ok=e is None, depth=depth)
            t._event.set()
        self.metrics.record_worker_batch(worker, self._clock() - t_busy)

    def _worker(self, idx: int) -> None:
        worker = str(idx)
        while True:
            with self._cv:
                while True:
                    if not self._running:
                        return
                    now = self._clock()
                    ready = self._pop_ready_locked(now, drain=False)
                    if ready is not None:
                        break
                    deadline = self._next_deadline_locked()
                    timeout = None if deadline is None \
                        else max(0.0, deadline - now)
                    self._cv.wait(timeout)
            try:
                self._serve(*ready, worker=worker)
            except BaseException as e:  # noqa: BLE001 - keep the loop alive
                # _serve already shields itself; this is the last-resort
                # guard so a worker can never die holding unresolved tickets
                for t in ready[1]:
                    if not t.done():
                        t._error = e
                        t._event.set()

    def _drain_inline(self) -> None:
        """Serve every queued ticket on the calling thread (stop/flush)."""
        while True:
            with self._cv:
                ready = self._pop_ready_locked(self._clock(), drain=True)
            if ready is None:
                return
            self._serve(*ready)

    def flush(self) -> None:
        """Synchronously serve everything currently queued (testing/shutdown
        aid; safe while workers run — pops are mutually exclusive)."""
        self._drain_inline()
