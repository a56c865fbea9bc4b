"""File export helpers for the observability layer (a copy of
``repro.obs.export``).

One place that knows how to spell metrics and traces to disk, so the
launch scripts, examples, and benchmarks don't each reinvent the dump:

* :func:`write_metrics` — registry → file, format picked by suffix:
  ``.prom`` / ``.txt`` get Prometheus text exposition, everything else a
  JSON document (``registry.to_json()``).
* :func:`write_chrome_trace` — tracer → Chrome/Perfetto trace-event JSON
  (open at ``ui.perfetto.dev`` or ``chrome://tracing``).

Both create parent directories and return the resolved path.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional, Union

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import Tracer

__all__ = ["write_metrics", "write_chrome_trace"]

_PROM_SUFFIXES = {".prom", ".txt"}


def _prepare(path: Union[str, os.PathLike]) -> Path:
    p = Path(path)
    if p.parent and str(p.parent) not in ("", "."):
        p.parent.mkdir(parents=True, exist_ok=True)
    return p


def write_metrics(registry: MetricsRegistry, path: Union[str, os.PathLike],
                  *, extra: Optional[dict] = None) -> Path:
    """Dump ``registry`` to ``path``; suffix picks the format.

    ``.prom``/``.txt`` → Prometheus text exposition (``extra`` ignored —
    that format has no place for free-form context). Anything else →
    JSON: ``{"metrics": registry.to_json(), **extra}``.
    """
    p = _prepare(path)
    if p.suffix.lower() in _PROM_SUFFIXES:
        p.write_text(registry.to_prometheus(), encoding="utf-8")
    else:
        doc = dict(extra or {})
        doc["metrics"] = registry.to_json()
        p.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n",
                     encoding="utf-8")
    return p


def write_chrome_trace(tracer: Tracer,
                       path: Union[str, os.PathLike]) -> Path:
    """Dump ``tracer`` as Chrome trace-event JSON to ``path``."""
    p = _prepare(path)
    p.write_text(tracer.chrome_trace_text(), encoding="utf-8")
    return p
