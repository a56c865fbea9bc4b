"""Per-site substrate plans: which multiplier runs *where*.

Counterpart of ``repro.nn.plan``. A :class:`SubstratePlan` maps contraction
**sites** — stable dotted names like ``conv.edge.center`` or
``layer.3.attn.wq`` — to substrate specs ``backend[:mult_name[@N]]`` (the
:mod:`repro_torch.nn.substrate` grammar): a default rule plus glob-style
overrides. The edge workload's sites are ``conv.edge`` (uniform path) and
``conv.edge.{center,ring}`` (the planned tap-group path, see
:func:`repro_torch.nn.conv.edge_detect_planned`).

Resolution
----------

``plan.resolve(site)`` picks the **most specific** matching rule:

1. an exact (wildcard-free) pattern beats any glob;
2. among globs, the one with the most literal (non-wildcard) characters
   wins — ``layer.3.attn.*`` beats ``layer.*``;
3. exact ties go to the **later** rule (so appended overrides win);
4. no match → the plan default.

Patterns are :func:`fnmatch.fnmatchcase` globs; ``*`` matches dots.
Resolution is lru-cached on the (hashable) ``(plan, site)`` pair.

The JSON schema (version 1) is ``repro``'s, so a plan written by either
package loads in the other as long as it names backends both know
(``approx_pallas`` specs resolve to ``approx_cuda`` here; ``repro`` has no
``approx_cuda``). ``repro``'s scan dispatch (``scan_site_scope``,
``dispatch``, ``SiteDispatch``) belongs to the ``lax.scan`` model stack and
comes with the model slice.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import functools
import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

from repro_torch.nn import substrate as psub

__all__ = [
    "SubstratePlan", "as_plan", "load_plan", "save_plan",
    "stat_spec", "stat_plan", "site_scope", "current_sites",
    "plan_override_scope", "current_plan_override", "PLAN_SCHEMA_VERSION",
    "current_site_stack", "site_stack_scope",
]

PLAN_SCHEMA_VERSION = 1

_WILDCARDS = "*?["


def _check_spec(spec: str) -> str:
    """Eager spec validation: grammar + a registered backend name.

    Wirings and widths are validated lazily by the backend factories
    (``get_substrate``), which own the per-backend width support.
    """
    parts = psub.parse_spec(spec)
    known = psub.list_substrates()
    if parts.backend not in known:
        raise ValueError(
            f"plan names unknown substrate backend {parts.backend!r} "
            f"(known: {known})")
    return spec


def _norm_rules(rules) -> Tuple[Tuple[str, str], ...]:
    if isinstance(rules, dict):
        rules = tuple(rules.items())
    out = []
    for rule in rules:
        if isinstance(rule, dict):
            pat, spec = rule["site"], rule["spec"]
        else:
            pat, spec = rule
        pat, spec = str(pat), str(spec)
        if not pat:
            raise ValueError("plan rule has an empty site pattern")
        _check_spec(spec)
        out.append((pat, spec))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class SubstratePlan:
    """Site-addressed substrate assignment: default spec + glob overrides.

    default: substrate spec for sites no rule matches.
    rules:   ordered ``(site_pattern, spec)`` pairs; also accepts a dict or
             ``{"site": …, "spec": …}`` mappings at construction. Most
             specific pattern wins (see module docstring).

    Hashable by value, so plans key lru caches.
    """

    default: str = "exact"
    rules: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        _check_spec(self.default)
        object.__setattr__(self, "default", str(self.default))
        object.__setattr__(self, "rules", _norm_rules(self.rules))

    # -- resolution ----------------------------------------------------------

    def resolve(self, site: Optional[str]) -> str:
        """The substrate spec assigned to ``site`` (default when None)."""
        if site is None:
            return self.default
        return _resolve(self, str(site))

    def substrate_for(self, site: Optional[str]):
        return psub.get_substrate(self.resolve(site))

    @property
    def is_uniform(self) -> bool:
        return not self.rules

    @property
    def label(self) -> str:
        """Compact human-readable identity for logs and trace spans."""
        if self.is_uniform:
            return f"plan({self.default})"
        return f"plan({self.default}+{len(self.rules)} rules)"

    # -- construction / serialization ----------------------------------------

    @classmethod
    def uniform(cls, spec: str) -> "SubstratePlan":
        """A plan that assigns ``spec`` to every site."""
        return cls(default=str(spec))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": PLAN_SCHEMA_VERSION,
            "default": self.default,
            "rules": [{"site": p, "spec": s} for p, s in self.rules],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SubstratePlan":
        version = int(d.get("version", PLAN_SCHEMA_VERSION))
        if version > PLAN_SCHEMA_VERSION:
            raise ValueError(
                f"plan schema version {version} is newer than supported "
                f"({PLAN_SCHEMA_VERSION})")
        return cls(default=d.get("default", "exact"),
                   rules=_norm_rules(d.get("rules", ())))

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "SubstratePlan":
        return cls.from_dict(json.loads(s))


def as_plan(p: "SubstratePlan | str | dict") -> SubstratePlan:
    """Accept a plan, a spec string (→ uniform plan), or a plan dict."""
    if isinstance(p, SubstratePlan):
        return p
    if isinstance(p, str):
        return SubstratePlan.uniform(p)
    if isinstance(p, dict):
        return SubstratePlan.from_dict(p)
    raise TypeError(f"cannot interpret {type(p).__name__} as a SubstratePlan")


def save_plan(path: str, plan: SubstratePlan) -> str:
    """Write ``plan`` as JSON (schema version 1)."""
    with open(path, "w") as f:
        json.dump(as_plan(plan).to_dict(), f, indent=2)
        f.write("\n")
    return path


def load_plan(path: str) -> SubstratePlan:
    """Read a plan from a JSON file, or from ``plan.json`` in a bundle dir."""
    if os.path.isdir(path):
        path = os.path.join(path, "plan.json")
    with open(path) as f:
        return SubstratePlan.from_dict(json.load(f))


# backends with an approx_stat statistical counterpart (same wiring + width)
_STAT_REWRITABLE = ("approx_bitexact", "approx_lut", "approx_cuda",
                    "approx_pallas")


def stat_spec(spec: str) -> str:
    """A spec's fast statistical counterpart: same wiring/width, stat model.

    Specs without a stat counterpart (``exact``, ``int8``, ``approx_stat``
    itself) pass through unchanged.
    """
    parts = psub.parse_spec(spec)
    if parts.backend in _STAT_REWRITABLE:
        return f"approx_stat:{parts.mult_name}@{parts.width}"
    return spec


def stat_plan(plan: SubstratePlan) -> SubstratePlan:
    """``plan`` with every assignment rewritten via :func:`stat_spec`."""
    plan = as_plan(plan)
    return SubstratePlan(default=stat_spec(plan.default),
                         rules=tuple((p, stat_spec(s)) for p, s in plan.rules))


# ---------------------------------------------------------------------------
# rule matching (most-specific wins)
# ---------------------------------------------------------------------------


def _specificity(pattern: str) -> Tuple[int, int]:
    """(tier, literal-char count): exact patterns outrank every glob."""
    if not any(c in pattern for c in _WILDCARDS):
        return (2, len(pattern))
    literals = sum(1 for c in pattern if c not in _WILDCARDS)
    return (1, literals)


@functools.lru_cache(maxsize=None)
def _resolve(plan: SubstratePlan, site: str) -> str:
    best_spec, best_score = None, None
    for pattern, spec in plan.rules:
        if not fnmatch.fnmatchcase(site, pattern):
            continue
        score = _specificity(pattern)
        if best_score is None or score >= best_score:  # later rule wins ties
            best_spec, best_score = spec, score
    return plan.default if best_spec is None else best_spec


# ---------------------------------------------------------------------------
# ambient plan override and site scopes (thread-local)
# ---------------------------------------------------------------------------


_PLAN_OVERRIDE_STATE = threading.local()


def current_plan_override() -> Optional[SubstratePlan]:
    """The ambient plan installed by :func:`plan_override_scope`, or None."""
    return getattr(_PLAN_OVERRIDE_STATE, "value", None)


@contextlib.contextmanager
def plan_override_scope(plan: "SubstratePlan | str | dict | None"):
    """Make ``plan`` the ambient plan for the block (``None``: no-op scope).

    Call sites that resolve their substrate from a configured plan consult
    :func:`current_plan_override` first.
    """
    prev = getattr(_PLAN_OVERRIDE_STATE, "value", None)
    _PLAN_OVERRIDE_STATE.value = as_plan(plan) if plan is not None else None
    try:
        yield _PLAN_OVERRIDE_STATE.value
    finally:
        _PLAN_OVERRIDE_STATE.value = prev


_SITE_STATE = threading.local()


def _stack() -> list:
    st = getattr(_SITE_STATE, "stack", None)
    if st is None:
        st = _SITE_STATE.stack = []
    return st


@contextlib.contextmanager
def site_scope(*parts):
    """Push concrete site path segment(s) for the duration of the block.

    ``site_scope("layer.3", "attn")`` makes a contraction with leaf ``"wq"``
    inside resolve at ``layer.3.attn.wq``. Segments must not contain glob
    wildcards (those belong in plan *rules*, not site names).
    """
    st = _stack()
    pushed = 0
    try:
        for p in parts:
            p = str(p)
            if not p or any(c in p for c in _WILDCARDS):
                raise ValueError(f"invalid site segment {p!r}")
            st.append(p)
            pushed += 1
        yield
    finally:
        del st[len(st) - pushed:]


def current_sites(leaf: Optional[str] = None):
    """The candidate site names at this point, given a final ``leaf`` segment.

    Returns ``(None, (site,))`` — ``repro``'s shape, whose first element is
    the scan index of a scan frame; scan frames are not ported, so it is
    always None and there is exactly one candidate (``""`` when no scope is
    active and no leaf given).
    """
    tail = [str(leaf)] if leaf is not None else []
    return None, (".".join(_stack() + tail),)


def current_site_stack() -> Tuple[str, ...]:
    """The site segments pushed on this thread, outermost first."""
    return tuple(_stack())


@contextlib.contextmanager
def site_stack_scope(stack: Tuple[str, ...]):
    """Replace this thread's site stack with ``stack`` (a
    :func:`current_site_stack` snapshot) for the block, then restore it.

    For work that runs where the stack was never pushed: a checkpointed
    layer that autograd recomputes on its own device thread.
    """
    st = _stack()
    saved = st[:]
    st[:] = list(stack)
    try:
        yield
    finally:
        st[:] = saved
