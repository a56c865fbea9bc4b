"""Metrics registry: thread-safe labeled Counter/Gauge/Histogram families.

The shared measurement substrate every layer records into: serving
telemetry (:class:`repro_torch.serving.metrics.ServingMetrics`) and
anything else that wants a counter. A copy of ``repro.obs.registry``: the
same family names and export formats, so dashboards carry over. A :class:`MetricsRegistry` owns named *families*; a family plus
a label set is one time series. Two export surfaces:

* :meth:`MetricsRegistry.to_json` — a plain dict (machine-readable dumps,
  ``BENCH_serving.json`` sections, CI artifact checks);
* :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
  format (``# HELP`` / ``# TYPE`` headers, ``name{label="v"} value``
  samples, ``_bucket``/``_sum``/``_count`` for histograms).

Concurrency contract: every mutation takes the owning family's lock, so
the batcher worker thread and submitting threads can record concurrently;
reads (``value()``, exports) snapshot under the same lock. Families are
get-or-create — asking a registry for an existing name returns the same
family (type and label names must match), so several recorders can share
one registry without coordination.

Registries are cheap, independent objects: each
:class:`~repro_torch.serving.metrics.ServingMetrics` defaults to a private one,
and an export surface that wants one combined dump passes a shared
registry to every recorder.
"""
from __future__ import annotations

import json
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

#: default latency-style histogram buckets (seconds), Prometheus-ish.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_LabelKey = Tuple[str, ...]


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]) -> _LabelKey:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared label names "
            f"{sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integers render bare, floats as repr."""
    if isinstance(v, bool):  # pragma: no cover - defensive
        return str(int(v))
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labelnames: Sequence[str], key: _LabelKey,
                extra: Optional[Dict[str, str]] = None) -> str:
    pairs = [(n, v) for n, v in zip(labelnames, key)]
    if extra:
        pairs += sorted(extra.items())
    if not pairs:
        return ""
    def esc(s: str) -> str:
        return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    return "{" + ",".join(f'{n}="{esc(str(v))}"' for n, v in pairs) + "}"


class _Family:
    """One named metric family: a dict of label-tuple → series state."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        if not name or not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: Dict[_LabelKey, object] = {}

    # -- series access -------------------------------------------------------

    def _new_state(self):
        raise NotImplementedError

    def _get(self, key: _LabelKey):
        state = self._series.get(key)
        if state is None:
            state = self._series[key] = self._new_state()
        return state

    def labels(self, **labels) -> "_Child":
        """Bound child for one label set (create-on-first-use)."""
        return _Child(self, _label_key(self.labelnames, labels))

    @property
    def _default_key(self) -> _LabelKey:
        if self.labelnames:
            raise ValueError(
                f"metric {self.name!r} declares labels {self.labelnames}; "
                "use .labels(...)")
        return ()

    def reset(self) -> None:
        """Drop every series (zero counters, clear histograms)."""
        with self._lock:
            self._series.clear()

    # -- snapshots -----------------------------------------------------------

    def samples(self) -> list:
        """[(labels_dict, value), ...] — histograms return richer dicts."""
        with self._lock:
            return [(dict(zip(self.labelnames, key)), self._snap(state))
                    for key, state in sorted(self._series.items())]

    def _snap(self, state):
        raise NotImplementedError


class _Child:
    """A family bound to one label set; forwards mutations."""

    __slots__ = ("_family", "_key")

    def __init__(self, family: _Family, key: _LabelKey):
        self._family = family
        self._key = key

    def __getattr__(self, name):
        fam, key = self._family, self._key
        method = getattr(type(fam), "_" + name, None)
        if method is None:
            raise AttributeError(name)
        def call(*args, **kw):
            with fam._lock:
                return method(fam, fam._get(key), *args, **kw)
        return call


class Counter(_Family):
    """Monotonically increasing value (``inc`` rejects negative deltas)."""

    kind = "counter"

    def _new_state(self):
        return [0.0]

    def _inc(self, state, amount: float = 1.0):
        if amount < 0:
            raise ValueError(f"counters only go up (inc({amount}))")
        state[0] += amount

    def _value(self, state) -> float:
        return state[0]

    def _snap(self, state):
        return state[0]

    def inc(self, amount: float = 1.0) -> None:
        key = self._default_key
        with self._lock:
            self._inc(self._get(key), amount)

    def value(self) -> float:
        key = self._default_key
        with self._lock:
            return self._get(key)[0]


class Gauge(_Family):
    """Value that can go anywhere (``set``/``inc``/``set_max``)."""

    kind = "gauge"

    def _new_state(self):
        return [0.0]

    def _set(self, state, v: float):
        state[0] = float(v)

    def _inc(self, state, amount: float = 1.0):
        state[0] += amount

    def _set_max(self, state, v: float):
        """Ratchet: keep the running maximum (peak gauges)."""
        state[0] = max(state[0], float(v))

    def _value(self, state) -> float:
        return state[0]

    def _snap(self, state):
        return state[0]

    def set(self, v: float) -> None:
        key = self._default_key
        with self._lock:
            self._set(self._get(key), v)

    def inc(self, amount: float = 1.0) -> None:
        key = self._default_key
        with self._lock:
            self._inc(self._get(key), amount)

    def set_max(self, v: float) -> None:
        key = self._default_key
        with self._lock:
            self._set_max(self._get(key), v)

    def value(self) -> float:
        key = self._default_key
        with self._lock:
            return self._get(key)[0]


class Histogram(_Family):
    """Cumulative-bucket histogram (+ sum and count), Prometheus layout."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")

    def _new_state(self):
        return {"counts": [0] * len(self.buckets), "sum": 0.0, "count": 0}

    def _observe(self, state, v: float):
        v = float(v)
        state["sum"] += v
        state["count"] += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                state["counts"][i] += 1

    def _snap(self, state):
        return {"buckets": dict(zip(self.buckets, state["counts"])),
                "sum": state["sum"], "count": state["count"]}

    def observe(self, v: float) -> None:
        key = self._default_key
        with self._lock:
            self._observe(self._get(key), v)


class MetricsRegistry:
    """Named metric families behind one lock-free lookup + JSON/Prom export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(name, help, labelnames, **kw)
                return fam
        if type(fam) is not cls or fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind} with "
                f"labels {fam.labelnames}; cannot re-register as "
                f"{cls.kind} with labels {tuple(labelnames)}")
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def families(self) -> list:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def reset(self) -> None:
        for fam in self.families():
            fam.reset()

    # -- export --------------------------------------------------------------

    def to_json(self) -> dict:
        """{name: {type, help, labelnames, samples: [{labels, value}]}}."""
        out = {}
        for fam in self.families():
            out[fam.name] = {
                "type": fam.kind,
                "help": fam.help,
                "labelnames": list(fam.labelnames),
                "samples": [{"labels": labels, "value": value}
                            for labels, value in fam.samples()],
            }
        return out

    def to_json_text(self) -> str:
        return json.dumps(self.to_json(), indent=1, sort_keys=True) + "\n"

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for labels, value in fam.samples():
                key = tuple(str(labels[n]) for n in fam.labelnames)
                if fam.kind == "histogram":
                    acc = 0
                    for b, c in value["buckets"].items():
                        acc = c  # counts are already cumulative
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_fmt_labels(fam.labelnames, key, {'le': repr(float(b))})}"
                            f" {acc}")
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_fmt_labels(fam.labelnames, key, {'le': '+Inf'})}"
                        f" {value['count']}")
                    lines.append(
                        f"{fam.name}_sum{_fmt_labels(fam.labelnames, key)} "
                        f"{_fmt_value(value['sum'])}")
                    lines.append(
                        f"{fam.name}_count{_fmt_labels(fam.labelnames, key)} "
                        f"{value['count']}")
                else:
                    lines.append(
                        f"{fam.name}{_fmt_labels(fam.labelnames, key)} "
                        f"{_fmt_value(value)}")
        return "\n".join(lines) + "\n"
