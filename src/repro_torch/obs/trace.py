"""Tracing: nestable spans on a per-thread stack, Chrome-trace/JSONL export.

A :class:`Tracer` records *spans* — named, timed, optionally attributed
intervals — from any number of threads. Each thread keeps its own span
stack (nesting is per-thread, so a batcher worker's spans never interleave
with a submitter's), and completed spans land in one shared, lock-guarded
event list. Export surfaces:

* :meth:`Tracer.chrome_trace` — the Chrome/Perfetto trace-event JSON
  format (``{"traceEvents": [{"ph": "X", "ts": µs, "dur": µs, ...}]}``);
  load the file at ``ui.perfetto.dev`` or ``chrome://tracing``;
* :meth:`Tracer.events` — plain dicts, one per span (JSONL sinks);
* :class:`JsonlSink` — streams every completed span to a file as one JSON
  object per line (``tracer.add_sink(sink)``).

A copy of ``repro.obs.trace``, with the same span names on the ported
paths; an ambient span is also a ``torch.profiler.record_function`` range,
which the profiler records when it runs. Ambient installation:
:func:`tracing_scope` installs a tracer *process-wide* — deliberately not
thread-local, because serving work happens on batcher worker threads that
never see the installing thread's locals — and :func:`trace_span` is the
zero-overhead instrumentation point: with no tracer installed it returns a
shared no-op context manager (one global read, no allocation).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

__all__ = ["Tracer", "JsonlSink", "tracing_scope", "current_tracer",
           "trace_span"]


class _NullSpan:
    """Reusable, reentrant no-op context manager (the disabled path)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Span recorder with per-thread nesting stacks and a shared event log.

    Timestamps come from ``clock`` (default ``time.perf_counter``,
    monotonic) relative to the tracer's construction instant, exported in
    microseconds (the Chrome trace unit).
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 pid: int = 1):
        self._clock = clock
        self._t0 = clock()
        self._pid = pid
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._sinks: List[Callable[[dict], None]] = []
        self._stacks = threading.local()
        self._tids: Dict[int, int] = {}          # thread ident -> small tid
        self._tid_counter = itertools.count(1)

    # -- internals -----------------------------------------------------------

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = next(self._tid_counter)
        return tid

    def _stack(self) -> list:
        st = getattr(self._stacks, "stack", None)
        if st is None:
            st = self._stacks.stack = []
        return st

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)
            sinks = list(self._sinks)
        for s in sinks:
            s(ev)

    # -- recording -----------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", **attrs):
        """Record a span around the block; nests on this thread's stack."""
        stack = self._stack()
        depth = len(stack)
        parent = stack[-1] if stack else None
        stack.append(name)
        ts = self._now_us()
        try:
            yield self
        finally:
            dur = self._now_us() - ts
            stack.pop()
            args: Dict[str, Any] = {"depth": depth}
            if parent is not None:
                args["parent"] = parent
            args.update(attrs)
            self._emit({"name": name, "cat": cat or "span", "ph": "X",
                        "ts": ts, "dur": dur, "pid": self._pid,
                        "tid": self._tid(), "args": args})

    def event(self, name: str, start_s: float, dur_s: float,
              cat: str = "", **attrs) -> None:
        """Record a retroactive span from absolute ``clock`` readings.

        ``start_s`` is a raw ``clock()`` value (e.g. a ticket's
        ``enqueued_at``) — used for intervals measured outside a ``with``
        block, like queue-wait time.
        """
        self._emit({"name": name, "cat": cat or "span", "ph": "X",
                    "ts": (start_s - self._t0) * 1e6, "dur": dur_s * 1e6,
                    "pid": self._pid, "tid": self._tid(),
                    "args": dict(attrs)})

    def instant(self, name: str, cat: str = "", **attrs) -> None:
        """Zero-duration marker event."""
        self._emit({"name": name, "cat": cat or "instant", "ph": "i",
                    "ts": self._now_us(), "s": "t", "pid": self._pid,
                    "tid": self._tid(), "args": dict(attrs)})

    def add_sink(self, sink: Callable[[dict], None]) -> None:
        """Stream every completed event to ``sink(event_dict)`` as well."""
        with self._lock:
            self._sinks.append(sink)

    # -- export --------------------------------------------------------------

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> dict:
        """Chrome/Perfetto trace-event JSON object (``traceEvents`` list)."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def chrome_trace_text(self) -> str:
        return json.dumps(self.chrome_trace(), indent=1) + "\n"


class JsonlSink:
    """Span sink writing one JSON object per line; close() flushes.

    Usable as a context manager::

        with JsonlSink(path) as sink:
            tracer.add_sink(sink)
            ...
    """

    def __init__(self, path):
        self._lock = threading.Lock()
        self._fh = open(path, "w", encoding="utf-8")

    def __call__(self, ev: dict) -> None:
        line = json.dumps(ev) + "\n"
        with self._lock:
            if not self._fh.closed:
                self._fh.write(line)

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Ambient tracer (process-wide, like the meter scope)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Tracer] = None
_ACTIVE_LOCK = threading.Lock()


def current_tracer() -> Optional[Tracer]:
    """The tracer installed by :func:`tracing_scope`, or None.

    Process-global on purpose: serving spans are recorded on batcher
    worker threads that inherit nothing thread-local from the installer.
    """
    return _ACTIVE


@contextlib.contextmanager
def tracing_scope(tracer: Optional[Tracer]):
    """Install ``tracer`` process-wide for the duration of the block.

    Nesting restores the previous tracer on exit; ``None`` is a no-op
    scope (uninstalls tracing inside the block). Concurrent scopes from
    different threads race on the single global slot — install from one
    place, as the launch/benchmark layers do.
    """
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, tracer
    try:
        yield tracer
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = prev


def trace_span(name: str, cat: str = "", **attrs):
    """Span on the ambient tracer; shared no-op when tracing is off.

    Under a tracer the span is also a ``record_function`` range of the same
    name, so where ``torch.profiler`` records, the device work launched
    inside it is attributed to the span in the profiler's event tree.
    """
    t = _ACTIVE
    if t is None:
        return _NULL_SPAN
    return _span(t, name, cat, attrs)


@contextlib.contextmanager
def _span(t: Tracer, name: str, cat: str, attrs: dict):
    with t.span(name, cat, **attrs), torch.profiler.record_function(name):
        yield
