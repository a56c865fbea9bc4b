"""Substrate meters: runtime per-contraction energy/error accounting.

Counterpart of ``repro.obs.meter``. The paper's headline numbers — PDP and
power savings, bounded edge-detection error — are *observable quantities*;
this module makes them observable at runtime instead of only in offline
estimates. An ambient :class:`ContractionMeter` (installed with
:func:`telemetry_scope`) makes every ``dot_general`` call of
:mod:`repro_torch.nn.substrate` — and the fused conv path in
:mod:`repro_torch.nn.conv` — record, per ``(spec, site)``:

* **contraction counts** and **MACs** (``b·m·k·n`` scalar products);
* **estimated energy** as MACs × the wiring's per-operation PDP from the
  unit-gate model (:func:`repro_torch.core.energy.estimate`), in fJ — the
  runtime counterpart of the offline Table-5 numbers;
* optionally (``error_probe=True``) **online error moments**: a small
  random row-slab of the contraction re-runs per product against the
  exact multiplier and the signed mean error, MED (mean |error|) and
  max-ED accumulate per site.

Call-time semantics: torch runs eagerly and every shape is known on the
host, so a hook records on the host when the contraction is called — every
call, including the recompute of a checkpointed layer in the backward.
Recording reads shapes only: the un-probed path adds no device
synchronization. The probe reads its slab's three sums back to the host,
so it synchronizes; it stays opt-in. The probe's rows are drawn from the
meter's host generator at every call (``repro`` draws them when a function
is traced, so a jitted caller reuses one draw for every execution); a
single call draws the same rows from the same seed in both.

Overhead contract: with no scope active the hooks cost one global read
per ``dot_general`` and touch no registry; outputs are bit-identical
either way (metering is purely additive — the probe computes a side
comparison, never perturbs the contraction).

The scope is installed *process-wide*, not thread-local: serving
contractions run on batcher worker threads, and autograd runs the
backward (and so a checkpointed layer's recompute) on its own device
thread; none of them would see the installing thread's locals. Install
from one place at a time.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.core import energy
from repro_torch.core import multiplier as mult
from repro_torch.obs.registry import MetricsRegistry

__all__ = ["ContractionMeter", "telemetry_scope", "current_meter",
           "pdp_per_mac_fj"]


@functools.lru_cache(maxsize=None)
def pdp_per_mac_fj(mult_key: str) -> float:
    """Estimated energy per scalar product (fJ) for ``"name[@N]"``.

    Priced through the unit-gate model: one MAC's multiplier operation
    costs the design's PDP (power × delay ≈ energy/op) at its width.
    Aliases and the implicit ``@8`` resolve through the canonical key, so
    every spec naming the same hardware design prices identically.
    Designs the energy model doesn't know (none today) price as 0.
    """
    base, n = mult.split_width(mult.canonical_key(mult_key))
    try:
        return float(energy.estimate(base, n)["pdp"])
    except KeyError:
        return 0.0


class ContractionMeter:
    """Per-(spec, site) contraction/energy/error accounting into a registry.

    registry:    shared :class:`~repro_torch.obs.registry.MetricsRegistry`
                 (a private one is created when omitted) — export with
                 ``meter.registry.to_prometheus()`` / ``.to_json()``.
    error_probe: opt in to the online error probe (adds a per-product
                 side comparison on a sampled slab of every metered
                 contraction, and a device synchronization — measurable
                 overhead, off by default).
    probe_rows / probe_cols / probe_k:
                 slab caps: at most ``rows × k × cols`` products are
                 re-run per contraction (rows are sampled at random from
                 the lhs free dim; k and cols truncate).
    seed:        seed for the row-sampling generator (host-side).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 error_probe: bool = False, probe_rows: int = 4,
                 probe_cols: int = 8, probe_k: int = 1024, seed: int = 0):
        if min(probe_rows, probe_cols, probe_k) < 1:
            raise ValueError("probe slab caps must be >= 1")
        self.registry = registry if registry is not None else MetricsRegistry()
        self.error_probe = bool(error_probe)
        self.probe_rows = int(probe_rows)
        self.probe_cols = int(probe_cols)
        self.probe_k = int(probe_k)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        r = self.registry
        labels = ("spec", "site")
        self._contractions = r.counter(
            "substrate_contractions_total",
            "dot_general contractions executed", labels)
        self._macs = r.counter(
            "substrate_macs_total",
            "scalar products (b*m*k*n) contracted", labels)
        self._energy = r.counter(
            "substrate_energy_pdp_fj_total",
            "estimated energy: MACs x per-op PDP (unit-gate model), fJ",
            labels)
        self._probe_n = r.counter(
            "substrate_probe_products_total",
            "scalar products re-run against the exact multiplier", labels)
        self._probe_err = r.gauge(
            "substrate_probe_err_sum",
            "signed error sum (approx - exact) over probed products", labels)
        self._probe_abs = r.counter(
            "substrate_probe_abs_err_sum",
            "absolute error sum over probed products", labels)
        self._probe_max = r.gauge(
            "substrate_probe_max_ed",
            "max error distance seen by the probe", labels)

    # -- substrate hooks (called from dot_general / conv at call time) -------

    def record_contraction(self, meta, b: int, m: int, k: int, n: int,
                           site: Optional[str] = None) -> None:
        """Meter one ``(B,M,K)@(B,K,N)`` contraction under ``meta``.

        ``site`` names the contraction site (a :mod:`repro_torch.nn.plan`
        name like ``"layer.3.attn.wq"``); anonymous contractions fall back
        to the shape label. Host arithmetic on the shape only.
        """
        site = site or f"{b}x{m}x{k}x{n}"
        macs = int(b) * int(m) * int(k) * int(n)
        pdp_fj = pdp_per_mac_fj(meta.mult_key)
        kv = {"spec": meta.spec, "site": site}
        self._contractions.labels(**kv).inc()
        self._macs.labels(**kv).inc(macs)
        if pdp_fj:
            self._energy.labels(**kv).inc(macs * pdp_fj)

    def probe(self, meta, scalar_fn, a3: torch.Tensor, b3: torch.Tensor,
              site: Optional[str] = None) -> None:
        """Re-run a sampled slab per product against the exact multiplier.

        a3/b3: the normalized integer operands ``(B, M, K)`` / ``(B, K, N)``
        (any integer dtype; wrapped into the width's operand domain, the
        same contract every approx backend applies). ``scalar_fn`` is the
        substrate's scalar product model. Error is measured per *product*
        — ``scalar_fn(a, b) − a·b`` — so the accumulated moments are
        directly comparable to the offline LUT oracle
        (:func:`repro_torch.core.lut.error_lut` / ``error_moments``).
        """
        _, m, k = a3.shape
        _, _, ncols = b3.shape
        rows = min(self.probe_rows, m)
        kk = min(self.probe_k, k)
        cols = min(self.probe_cols, ncols)
        with self._lock:
            idx = (np.sort(self._rng.choice(m, size=rows, replace=False))
                   if m > rows else None)
        lhs = (a3[0, :rows] if idx is None
               else a3[0][torch.from_numpy(idx).to(a3.device)])
        a_s = mult.wrap_operand(lhs[:, :kk].to(torch.int32), meta.width)
        b_s = mult.wrap_operand(b3[0, :kk, :cols].to(torch.int32), meta.width)
        approx = scalar_fn(a_s[:, :, None], b_s[None, :, :]).to(torch.int32)
        err = (approx - a_s[:, :, None] * b_s[None, :, :]).to(torch.int64)
        sum_err, sum_abs, max_ed = torch.stack(
            [err.sum(), err.abs().sum(), err.abs().max()]).tolist()
        kv = {"spec": meta.spec,
              "site": site or f"{a3.shape[0]}x{m}x{k}x{ncols}"}
        self._probe_n.labels(**kv).inc(int(rows) * int(kk) * int(cols))
        self._probe_err.labels(**kv).inc(float(sum_err))
        self._probe_abs.labels(**kv).inc(float(sum_abs))
        self._probe_max.labels(**kv).set_max(float(max_ed))

    # -- derived views -------------------------------------------------------

    def summary(self) -> dict:
        """Per-spec rollup: contractions, MACs, estimated energy (fJ)."""
        out: dict = {}
        for labels, value in self._contractions.samples():
            out.setdefault(labels["spec"], {"contractions": 0, "macs": 0,
                                            "energy_pdp_fj": 0.0})
            out[labels["spec"]]["contractions"] += int(value)
        for labels, value in self._macs.samples():
            out.setdefault(labels["spec"], {"contractions": 0, "macs": 0,
                                            "energy_pdp_fj": 0.0})
            out[labels["spec"]]["macs"] += int(value)
        for labels, value in self._energy.samples():
            out[labels["spec"]]["energy_pdp_fj"] += float(value)
        return out

    def site_summary(self) -> dict:
        """Per-site rollup: contractions, MACs, energy (fJ), specs seen.

        Keys are the site labels recorded at each contraction — plan site
        names where the call site passed one (``spec.site`` /
        ``conv.edge*``), shape strings for anonymous contractions. A site
        served by several substrates lists every spec and sums their
        energy.
        """
        out: dict = {}

        def entry(site):
            return out.setdefault(site, {"contractions": 0, "macs": 0,
                                         "energy_pdp_fj": 0.0, "specs": []})

        for labels, value in self._contractions.samples():
            e = entry(labels["site"])
            e["contractions"] += int(value)
            if labels["spec"] not in e["specs"]:
                e["specs"].append(labels["spec"])
        for labels, value in self._macs.samples():
            entry(labels["site"])["macs"] += int(value)
        for labels, value in self._energy.samples():
            entry(labels["site"])["energy_pdp_fj"] += float(value)
        for e in out.values():
            e["specs"] = sorted(e["specs"])
        return out

    def probe_moments(self, spec: Optional[str] = None) -> dict:
        """Accumulated online error moments, keyed by spec (or one spec).

        Each entry: ``{"n", "mean", "med", "max_ed"}`` — signed mean
        error, mean error distance (mean |error|), max error distance —
        comparable to :func:`repro_torch.core.lut.error_moments` /
        ``|error_lut|.mean()`` under uniform operands.
        """
        acc: dict = {}
        for labels, v in self._probe_n.samples():
            acc.setdefault(labels["spec"], dict(n=0, err=0.0, abs=0.0,
                                                max_ed=0.0))["n"] += int(v)
        for labels, v in self._probe_err.samples():
            acc[labels["spec"]]["err"] += float(v)
        for labels, v in self._probe_abs.samples():
            acc[labels["spec"]]["abs"] += float(v)
        for labels, v in self._probe_max.samples():
            a = acc[labels["spec"]]
            a["max_ed"] = max(a["max_ed"], float(v))
        out = {s: {"n": a["n"],
                   "mean": a["err"] / a["n"] if a["n"] else 0.0,
                   "med": a["abs"] / a["n"] if a["n"] else 0.0,
                   "max_ed": a["max_ed"]}
               for s, a in acc.items()}
        if spec is not None:
            return out.get(spec, {"n": 0, "mean": 0.0, "med": 0.0,
                                  "max_ed": 0.0})
        return out


# ---------------------------------------------------------------------------
# Ambient scope (process-wide)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[ContractionMeter] = None
_ACTIVE_LOCK = threading.Lock()


def current_meter() -> Optional[ContractionMeter]:
    """The meter installed by :func:`telemetry_scope`, or None.

    Read by ``dot_general`` and the fused conv path at call time (one
    global read — the disabled path does nothing else).
    """
    return _ACTIVE


@contextlib.contextmanager
def telemetry_scope(meter: Optional[ContractionMeter]):
    """Install ``meter`` process-wide for the duration of the block.

    Deliberately process-global rather than thread-local: metered
    contractions run on serving worker threads and on autograd's device
    thread, none of which inherit the installer's thread-locals. ``None``
    is a no-op scope (disables metering inside the block); nesting
    restores the previous meter on exit.
    """
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, meter
    try:
        yield meter
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = prev
