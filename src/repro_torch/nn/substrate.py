"""Product-substrate layer: one registry for every scalar-product unit.

Counterpart of ``repro.nn.substrate``. A substrate bundles one
``dot_general``-style contraction entry point

* ``dot_general(x, w, spec)`` — a :class:`ContractionSpec` carries jax-style
  *dimension numbers* and an optional :class:`QuantPolicy` (the float→intN
  quantization boundary);

plus ``scalar(a, b)`` (the raw product model), ``dot_int(a, b)`` (2-D
integer contraction, exact int32-ring adder) and :class:`SubstrateMeta`.

Registered backends (``list_substrates()``):

* ``exact``           — float reference dot; exact integer contraction.
* ``int8``            — symmetric int8 quantization boundary, exact integer
                        contraction.
* ``approx_bitexact`` — every product through the closed-form multiplier
                        model, plain torch. Any width 3..16.
* ``approx_lut``      — the same contraction through the (2^N)² product
                        table, a plain torch gather. Widths ≤ 8.
* ``approx_stat``     — exact contraction + the separable statistical error
                        model (``_stat_tables``). Widths ≤ 8.
* ``approx_cuda``     — the hand-written CUDA kernels (the counterpart of
                        ``approx_pallas``): ``dot_int``/``dot_general``
                        through ``kernels/approx_matmul`` (the closed form)
                        or ``kernels/lut_matmul`` (the product table: the
                        ``exact`` wiring and ``kernel="lut"``), batch dims
                        as the kernel's grid z; convolutions through
                        ``kernels/fused_conv`` in the same kind. Every
                        wiring at widths 3..8. ``approx_pallas`` is
                        registered as an alias, so specs written for
                        ``repro`` resolve unchanged.

The kernel backends follow the device rule of ``kernels``: CPU tensors run
the plain versions, CUDA tensors the kernels.

Spec grammar — ``"backend[:mult_name[@N]]"`` — selects a backend, a
multiplier wiring and an operand width at once, with the same strictness
as ``repro`` (no whitespace, no empty parts, ASCII-digit widths).

Accumulator contract: every integer contraction accumulates in the int32
ring (sums wrap mod 2^32), as in ``repro``.

NOTE: approximate wirings map (0,0) → a nonzero compensation value, so
zero padding of the contraction dimension injects spurious contributions;
every backend that pads corrects for the wiring's f(0,0).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import lut as lut_lib
from repro_torch.core import multiplier as mult
from repro_torch.kernels import build
from repro_torch.nn import quant
from repro_torch.obs.meter import current_meter as _current_meter
from repro_torch.obs.trace import trace_span

Tensor = torch.Tensor

_K_CHUNK = 16  # k-slab size for the bit-exact contraction


# ---------------------------------------------------------------------------
# Metadata
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SubstrateMeta:
    """Static facts about a substrate, for dispatch-free reasoning.

    bit_exact:        product values are bit-identical to the hardware netlist.
    scalar_faithful:  ``dot_int(a, b) == Σ_k scalar(a_k, b_k)`` exactly.
    preferred_backend: "cuda" for kernels that only pay off on the card,
                      "any" otherwise.
    cost_hint:        dominant execution resource ("tensor-core" | "int32-alu"
                      | "gather" | "scalar-emulation").
    width:            operand width N of the scalar-product unit (bits).
    """

    name: str
    mult_name: str
    bit_exact: bool
    scalar_faithful: bool
    preferred_backend: str
    cost_hint: str
    width: int = mult.N_BITS

    @property
    def mult_key(self) -> str:
        """Wiring + width key, as it appears in spec strings (``@8`` implicit)."""
        if self.width == mult.N_BITS:
            return self.mult_name
        return f"{self.mult_name}@{self.width}"

    @property
    def spec(self) -> str:
        return f"{self.name}:{self.mult_key}"

    @property
    def label(self) -> str:
        """Bare backend for default wirings at default width, full spec
        otherwise."""
        if self.mult_name in ("exact", "proposed") and self.width == mult.N_BITS:
            return self.name
        return self.spec


# ---------------------------------------------------------------------------
# Contraction policies: dimension numbers + quantization
# ---------------------------------------------------------------------------

#: jax ``dot_general``-style dimension numbers:
#: ``((lhs_contracting, rhs_contracting), (lhs_batch, rhs_batch))``.
DimensionNumbers = Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]],
                         Tuple[Tuple[int, ...], Tuple[int, ...]]]

#: Plain matmul dims: contract the last lhs axis with the first rhs axis.
MATMUL_DIMS: DimensionNumbers = (((-1,), (0,)), ((), ()))


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Float→intN quantization boundary policy for ``dot_general``.

    bits:     operand width to quantize to (None → the substrate's
              ``meta.width``; must not exceed it).
    x_mode:   activation scale granularity — ``"per_tensor"`` or
              ``"per_channel"`` (one scale per flattened lhs free element).
    w_mode:   weight scale granularity — ``"per_channel"`` (one scale per
              flattened rhs free element) or ``"per_tensor"``.
    x_scale / w_scale:
              pinned scales; values quantize as ``round(v / scale)``.
              Shapes broadcast against the normalized operand layouts: lhs
              ``(B, M, 1)`` and rhs ``(B, 1, N)``.
    eps:      epsilon guard for the dynamic scale ``max(absmax, eps) / qmax``.
    """

    bits: Optional[int] = None
    x_mode: str = "per_tensor"
    w_mode: str = "per_channel"
    x_scale: Optional[Tensor] = None
    w_scale: Optional[Tensor] = None
    eps: float = 1e-8

    def __post_init__(self):
        for field_name, mode in (("x_mode", self.x_mode),
                                 ("w_mode", self.w_mode)):
            if mode not in ("per_tensor", "per_channel"):
                raise ValueError(
                    f"QuantPolicy.{field_name} must be 'per_tensor' or "
                    f"'per_channel', got {mode!r}")
        if self.bits is not None and not (2 <= self.bits <= 16):
            raise ValueError(
                f"QuantPolicy.bits must be in [2, 16], got {self.bits}")
        if self.eps <= 0:
            raise ValueError(f"QuantPolicy.eps must be > 0, got {self.eps}")


@dataclasses.dataclass(frozen=True)
class ContractionSpec:
    """Everything ``dot_general`` needs beyond the two operands.

    dimension_numbers: jax ``dot_general`` style (negative axes allowed).
                       Output layout: ``(batch..., lhs_free..., rhs_free...)``.
    quant:             None → integer-domain contraction (operands must be
                       integers); a :class:`QuantPolicy` → float operands
                       through the quantization boundary.
    site:              optional contraction-site name (``"conv.edge.center"``
                       — see :mod:`repro_torch.nn.plan`); purely
                       observational, the result never depends on it.

    ``repro``'s ``partitioning`` field is not ported (ROADMAP.md, queue 1
    item 11), so ``site`` is the third positional field here.
    """

    dimension_numbers: DimensionNumbers = MATMUL_DIMS
    quant: Optional[QuantPolicy] = None
    site: Optional[str] = None

    @staticmethod
    def matmul(quant: Optional[QuantPolicy] = None,
               site: Optional[str] = None) -> "ContractionSpec":
        """Plain ``(…, K) @ (K, N)`` spec."""
        return ContractionSpec(MATMUL_DIMS, quant, site)


# -- ambient contraction override (the QAT layer's injection point) ---------

_DOT_OVERRIDE_STATE = threading.local()


def current_dot_override():
    """The ambient contraction override installed by
    :func:`dot_override_scope`, or None. Read at call time by call sites
    that route through the ambient plan (``models.common.dense``)."""
    return getattr(_DOT_OVERRIDE_STATE, "value", None)


@contextlib.contextmanager
def dot_override_scope(fn):
    """Install an ambient contraction override for the duration of the block.

    ``fn(spec_str, x, w, cspec) -> Tensor`` replaces the default
    ``get_substrate(spec_str).dot_general(x, w, cspec)`` at every consulting
    call site, so higher layers change *how* a resolved (site → spec)
    assignment contracts without this layer importing them:
    ``repro_torch.train.qat.qat_scope`` installs its straight-through
    wrapper here. ``None`` clears the override for the block. Thread-local:
    a block that runs on another thread (autograd's device thread, which
    recomputes a checkpointed layer) re-enters it explicitly.
    """
    prev = getattr(_DOT_OVERRIDE_STATE, "value", None)
    _DOT_OVERRIDE_STATE.value = fn
    try:
        yield fn
    finally:
        _DOT_OVERRIDE_STATE.value = prev


# ---------------------------------------------------------------------------
# Dimension-number normalization + contraction planning
# ---------------------------------------------------------------------------


def _norm_axes(axes, ndim: int, what: str) -> Tuple[int, ...]:
    out = []
    for d in axes:
        d = int(d)
        if not -ndim <= d < ndim:
            raise ValueError(
                f"{what} dimension {d} out of range for rank-{ndim} operand")
        out.append(d % ndim)
    if len(set(out)) != len(out):
        raise ValueError(f"duplicate {what} dimensions: {tuple(axes)}")
    return tuple(out)


class _Plan(NamedTuple):
    """Permutes/reshapes taking arbitrary dimension numbers to the canonical
    batched form ``(B, M, K) @ (B, K, N) -> (B, M, N)``."""

    dims: DimensionNumbers
    lhs_perm: Tuple[int, ...]
    rhs_perm: Tuple[int, ...]
    b: int
    m: int
    k: int
    n: int
    out_shape: Tuple[int, ...]

    def lhs3(self, x: Tensor) -> Tensor:
        return x.permute(self.lhs_perm).reshape(self.b, self.m, self.k)

    def rhs3(self, w: Tensor) -> Tensor:
        return w.permute(self.rhs_perm).reshape(self.b, self.k, self.n)

    def unflatten(self, out3: Tensor) -> Tensor:
        return out3.reshape(self.out_shape)


def _plan_contraction(lhs_shape, rhs_shape,
                      dimension_numbers: DimensionNumbers) -> _Plan:
    try:
        (lc, rc), (lb, rb) = dimension_numbers
    except (TypeError, ValueError) as e:
        raise ValueError(
            "dimension_numbers must be ((lhs_contracting, rhs_contracting), "
            f"(lhs_batch, rhs_batch)); got {dimension_numbers!r}") from e
    lnd, rnd = len(lhs_shape), len(rhs_shape)
    lc = _norm_axes(lc, lnd, "lhs contracting")
    rc = _norm_axes(rc, rnd, "rhs contracting")
    lb = _norm_axes(lb, lnd, "lhs batch")
    rb = _norm_axes(rb, rnd, "rhs batch")
    if len(lc) != len(rc) or len(lb) != len(rb):
        raise ValueError(
            f"contracting/batch dimension lists must pair up: "
            f"lhs {lc}/{lb} vs rhs {rc}/{rb}")
    if set(lc) & set(lb) or set(rc) & set(rb):
        raise ValueError(
            "a dimension cannot be both contracting and batch: "
            f"lhs {lc}∩{lb}, rhs {rc}∩{rb}")
    for dl, dr in zip(lc, rc):
        if lhs_shape[dl] != rhs_shape[dr]:
            raise ValueError(
                f"contracting dimension mismatch: lhs dim {dl} has size "
                f"{lhs_shape[dl]}, rhs dim {dr} has size {rhs_shape[dr]}")
    for dl, dr in zip(lb, rb):
        if lhs_shape[dl] != rhs_shape[dr]:
            raise ValueError(
                f"batch dimension mismatch: lhs dim {dl} has size "
                f"{lhs_shape[dl]}, rhs dim {dr} has size {rhs_shape[dr]}")
    lfree = tuple(d for d in range(lnd) if d not in lc and d not in lb)
    rfree = tuple(d for d in range(rnd) if d not in rc and d not in rb)

    def prod(dims, shape):
        return int(np.prod([shape[d] for d in dims], dtype=np.int64)) if dims else 1

    out_shape = tuple([lhs_shape[d] for d in lb]
                      + [lhs_shape[d] for d in lfree]
                      + [rhs_shape[d] for d in rfree])
    return _Plan(
        dims=((lc, rc), (lb, rb)),
        lhs_perm=lb + lfree + lc,
        rhs_perm=rb + rc + rfree,
        b=prod(lb, lhs_shape), m=prod(lfree, lhs_shape),
        k=prod(lc, lhs_shape), n=prod(rfree, rhs_shape),
        out_shape=out_shape,
    )


def _quantize_operand(t3: Tensor, mode: str, pinned_scale, contract_axis: int,
                      bits: int, eps: float):
    """Quantize a normalized ``(B, ·, ·)`` operand per the policy.

    Returns (int values in the width's storage dtype, f32 scale). The
    dynamic branch is ``quant.quantize`` (epsilon-guarded scale, so an
    all-zero tensor quantizes to exact zeros); a pinned scale skips the
    absmax and quantizes as ``round(v / scale)``.
    """
    if pinned_scale is None:
        axes = None if mode == "per_tensor" else (contract_axis,)
        q = quant.quantize(t3, axes=axes, bits=bits, eps=eps)
        return q.values, q.scale
    qm = quant.qmax(bits)
    scale = torch.as_tensor(pinned_scale, dtype=torch.float32, device=t3.device)
    q = torch.clamp(torch.round(t3.to(torch.float32) / scale), -qm, qm)
    return q.to(quant.storage_dtype(bits)), scale


# ---------------------------------------------------------------------------
# Shared contraction machinery
# ---------------------------------------------------------------------------


def _bitexact_contract(a3: Tensor, b3: Tensor, product_fn, f00: int) -> Tensor:
    """sum_k f(a[b,m,k], b[b,k,n]) for an arbitrary intN×intN→int32 model on
    (B,M,K)@(B,K,N), walked in k-slabs of ``_K_CHUNK``; zero-padding of the
    last slab is corrected with the model's ``f00``."""
    bsz, m, k = a3.shape
    n = b3.shape[2]
    pad = (-k) % _K_CHUNK
    a3 = F.pad(a3.to(torch.int32), (0, pad))
    b3 = F.pad(b3.to(torch.int32), (0, 0, 0, pad))
    acc = torch.zeros((bsz, m, n), dtype=torch.int32, device=a3.device)
    for k0 in range(0, k + pad, _K_CHUNK):
        prod = product_fn(a3[:, :, k0:k0 + _K_CHUNK, None],
                          b3[:, None, k0:k0 + _K_CHUNK, :])  # (B, M, ck, N)
        acc += prod.sum(dim=2, dtype=torch.int32)
    if pad:
        acc -= f00 * pad
    return acc


@functools.lru_cache(maxsize=None)
def _stat_tables(mult_key: str) -> tuple[np.ndarray, np.ndarray, float]:
    """Separable error model (r[a], c[b], µ) from the width-N error LUT."""
    e = lut_lib.error_lut(mult_key).astype(np.float64)
    mu = e.mean()
    r = e.mean(axis=1) - 0.5 * mu
    c = e.mean(axis=0) - 0.5 * mu
    return r.astype(np.float32), c.astype(np.float32), float(mu)


def _exact_int_matmul(a3: Tensor, b3: Tensor) -> Tensor:
    """Exact integer (B,M,K)@(B,K,N) in the int32 ring.

    Not a kernel (``repro`` leaves it to XLA). ``torch.matmul`` has no int32
    path on CUDA, so the product runs in float64: exact while every partial
    sum stays below 2^53, which holds for N ≤ 16 operands (|product| ≤ 2^30)
    at any K below 2^23. The result is cast back through int64 with int32
    wraparound, which is what the reference's int32 accumulator returns.
    """
    out = torch.matmul(a3.to(torch.float64), b3.to(torch.float64))
    return out.to(torch.int64).to(torch.int32)


def _require_tensor(x, what: str) -> Tensor:
    if not torch.is_tensor(x):
        raise TypeError(f"{what} must be a torch tensor (its device decides "
                        f"where the contraction runs), got {type(x).__name__}")
    return x


def _is_int(t: Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex
                or t.dtype == torch.bool)


class _SubstrateBase:
    """Shared ``dot_general`` plumbing."""

    meta: SubstrateMeta
    #: the scalar-product model's f(0,0) — the k-padding correction unit.
    _f00: int = 0

    def scalar(self, a: Tensor, b: Tensor) -> Tensor:
        raise NotImplementedError

    def _contract3(self, a3: Tensor, b3: Tensor) -> Tensor:
        """(B,M,K)@(B,K,N) integer contraction (exact int32-ring adder)."""
        raise NotImplementedError

    def _stor(self, x: Tensor) -> Tensor:
        """Cast integer operands to the width's storage dtype (int8/int16)."""
        return x.to(quant.storage_dtype(self.meta.width))

    def dot_int(self, a: Tensor, b: Tensor) -> Tensor:
        """2-D (M,K)@(K,N) integer contraction (exact int32-ring adder)."""
        a = _require_tensor(a, "a")
        b = _require_tensor(b, "b")
        if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(f"dot_int needs (M,K)@(K,N), got "
                             f"{tuple(a.shape)} @ {tuple(b.shape)}")
        return self._contract3(a[None], b[None])[0]

    def _meter_hook(self, plan: _Plan, a3: Optional[Tensor],
                    b3: Optional[Tensor], site: Optional[str] = None) -> None:
        """Record this contraction on the ambient telemetry meter, if any.

        One global read when no :func:`repro_torch.obs.meter.telemetry_scope`
        is active. The record reads shapes only (no device sync); the
        opt-in error probe samples the integer operands. Outputs are
        bit-identical either way.
        """
        meter = _current_meter()
        if meter is None:
            return
        meter.record_contraction(self.meta, plan.b, plan.m, plan.k, plan.n,
                                 site=site)
        if (meter.error_probe and a3 is not None
                and self.meta.mult_name != "exact" and _is_int(a3)):
            meter.probe(self.meta, self.scalar, a3, b3, site=site)

    def dot_general(self, x: Tensor, w: Tensor,
                    spec: Optional[ContractionSpec] = None) -> Tensor:
        """General contraction of ``x`` and ``w`` under this substrate.

        Output layout matches ``jax.lax.dot_general``:
        ``(batch..., lhs_free..., rhs_free...)``.
        """
        spec = spec if spec is not None else ContractionSpec()
        x = _require_tensor(x, "x")
        w = _require_tensor(w, "w")
        plan = _plan_contraction(tuple(x.shape), tuple(w.shape),
                                 spec.dimension_numbers)
        if spec.quant is None:
            if not (_is_int(x) and _is_int(w)):
                raise TypeError(
                    "integer-domain dot_general (spec.quant=None) needs "
                    f"integer operands, got {x.dtype}/{w.dtype}; pass a "
                    "QuantPolicy to contract float tensors")
            a3, b3 = plan.lhs3(x), plan.rhs3(w)
            self._meter_hook(plan, a3, b3, site=spec.site)
            return plan.unflatten(self._contract3(a3, b3))
        q = spec.quant
        bits = q.bits if q.bits is not None else self.meta.width
        if bits > self.meta.width:
            raise ValueError(
                f"QuantPolicy.bits={bits} exceeds the substrate operand "
                f"width {self.meta.width} ({self.meta.spec}) — wider codes "
                "would wrap in the narrower multiplier")
        with trace_span("substrate.dot_general", "substrate",
                        spec=self.meta.spec, site=spec.site):
            qa, sa = _quantize_operand(plan.lhs3(x), q.x_mode, q.x_scale,
                                       contract_axis=2, bits=bits, eps=q.eps)
            qb, sb = _quantize_operand(plan.rhs3(w), q.w_mode, q.w_scale,
                                       contract_axis=1, bits=bits, eps=q.eps)
            self._meter_hook(plan, qa, qb, site=spec.site)
            out3 = self._contract3(qa, qb).to(torch.float32) * (sa * sb)
            return plan.unflatten(out3).to(x.dtype)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self.meta.spec}>"


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


def _reject_wiring(backend: str, mult_name: str | None) -> None:
    """Exact backends take no multiplier wiring — a suffix is a confused
    spec, not a no-op."""
    if mult_name not in (None, "exact"):
        raise ValueError(
            f"{backend} is an exact backend and takes no multiplier wiring "
            f"(got {mult_name!r}); use approx_bitexact/approx_lut/approx_cuda "
            "to select a wiring.")


def _split_suffix(mult_name: str | None) -> tuple[str, int]:
    """Wiring suffix (possibly carrying ``@N``) → (base_name, width); an
    empty wiring name in front of a width (``"@4"``) is rejected."""
    base, n = mult.split_width(mult_name or "proposed")
    if not base:
        raise ValueError(
            f"malformed multiplier suffix {mult_name!r}: a width needs a "
            "wiring name (mult_name[@N]), e.g. 'proposed@4'")
    return base, n


class ExactSubstrate(_SubstrateBase):
    """Float reference: plain dot in the compute dtype, exact int contraction.

    The float path ignores the :class:`QuantPolicy` — this backend *is* the
    unquantized reference.
    """

    def __init__(self, mult_name: str | None = None):
        _reject_wiring("exact", mult_name)
        self._f00 = 0
        self.meta = SubstrateMeta("exact", "exact", bit_exact=True,
                                  scalar_faithful=True, preferred_backend="any",
                                  cost_hint="tensor-core")

    def scalar(self, a, b):
        return mult.exact_multiply(a, b)

    def _contract3(self, a3, b3):
        return _exact_int_matmul(self._stor(a3), self._stor(b3))

    def dot_general(self, x, w, spec: Optional[ContractionSpec] = None):
        spec = spec if spec is not None else ContractionSpec()
        if spec.quant is None:
            return super().dot_general(x, w, spec)
        x = _require_tensor(x, "x")
        w = _require_tensor(w, "w").to(x.dtype)
        plan = _plan_contraction(tuple(x.shape), tuple(w.shape),
                                 spec.dimension_numbers)
        self._meter_hook(plan, None, None, site=spec.site)  # no probe
        return plan.unflatten(torch.matmul(plan.lhs3(x), plan.rhs3(w)))


class Int8Substrate(_SubstrateBase):
    """Symmetric int8 quantization boundary, exact integer contraction."""

    def __init__(self, mult_name: str | None = None):
        _reject_wiring("int8", mult_name)
        self._f00 = 0
        self.meta = SubstrateMeta("int8", "exact", bit_exact=True,
                                  scalar_faithful=True, preferred_backend="any",
                                  cost_hint="tensor-core")

    def scalar(self, a, b):
        return mult.exact_multiply(a, b)

    def _contract3(self, a3, b3):
        return _exact_int_matmul(self._stor(a3), self._stor(b3))


class BitexactSubstrate(_SubstrateBase):
    """Every scalar product through the closed-form multiplier model (plain
    torch). Any wiring at any width 3..16."""

    def __init__(self, mult_name: str | None = None):
        base, n = _split_suffix(mult_name)
        _, self._fn, n = mult.resolve_multiplier(base, n)
        zero = torch.zeros((), dtype=torch.int32)
        self._f00 = int(self._fn(zero, zero))
        self.meta = SubstrateMeta("approx_bitexact", base, bit_exact=True,
                                  scalar_faithful=True, preferred_backend="any",
                                  cost_hint="scalar-emulation", width=n)

    def scalar(self, a, b):
        return self._fn(a, b)

    def _contract3(self, a3, b3):
        return _bitexact_contract(self._stor(a3), self._stor(b3), self._fn,
                                  self._f00)


class LutSubstrate(_SubstrateBase):
    """Gather-based contraction through the (2^N)² product LUT (N ≤ 8)."""

    def __init__(self, mult_name: str | None = None):
        base, n = _split_suffix(mult_name)
        key, _, n = mult.resolve_multiplier(base, n)
        if n > lut_lib.MAX_LUT_BITS:
            raise ValueError(
                f"approx_lut needs an enumerable product table (width <= "
                f"{lut_lib.MAX_LUT_BITS}, got {n}); use approx_bitexact for "
                "wider operands")
        self._key = key
        self._f00 = lut_lib.f00(key)
        self.meta = SubstrateMeta("approx_lut", base, bit_exact=True,
                                  scalar_faithful=True, preferred_backend="any",
                                  cost_hint="gather", width=n)

    def _table(self, device) -> Tensor:
        return build.device_constant(("lut", self._key), device,
                                     lambda: lut_lib.build_lut(self._key))

    def scalar(self, a, b):
        a = torch.as_tensor(a)
        return lut_lib.lut_multiply(a, b, self._table(a.device))

    def _contract3(self, a3, b3):
        table = self._table(a3.device)
        n = self.meta.width
        size, off = 1 << n, 1 << (n - 1)

        def gather(x, y):
            return table[((x + off) & (size - 1)).long(),
                         ((y + off) & (size - 1)).long()]

        return _bitexact_contract(self._stor(a3), self._stor(b3), gather,
                                  self._f00)


class StatSubstrate(_SubstrateBase):
    """Exact integer contraction + separable statistical error model.

    E[e(a,b)] ≈ r[a] + c[b] − µ, where e is the multiplier's error LUT and
    r/c its row/column means. The correction is defined at contraction
    level (``scalar_faithful=False``): ``dot_int`` sums the per-operand
    float32 terms and truncates once per output element, while ``scalar``
    truncates per product. Widths ≤ 8.
    """

    def __init__(self, mult_name: str | None = None):
        base, n = _split_suffix(mult_name)
        key, _, n = mult.resolve_multiplier(base, n)
        if n > lut_lib.MAX_LUT_BITS:
            raise ValueError(
                "approx_stat fits its separable error model on the "
                f"exhaustive error LUT (width <= {lut_lib.MAX_LUT_BITS}, "
                f"got {n}); use approx_bitexact for wider operands")
        self._key = key
        self._f00 = None  # the correction is not separable per product
        self.meta = SubstrateMeta("approx_stat", base, bit_exact=False,
                                  scalar_faithful=False, preferred_backend="any",
                                  cost_hint="tensor-core", width=n)

    def _rc(self, device) -> tuple[Tensor, Tensor]:
        """The model's (r, c) float32 tables on ``device``, uploaded once."""
        r, c, _mu = _stat_tables(self._key)
        return (build.device_constant(("stat_r", self._key), device, lambda: r),
                build.device_constant(("stat_c", self._key), device, lambda: c))

    def scalar(self, a, b):
        n = self.meta.width
        off = 1 << (n - 1)
        a = mult.wrap_operand(torch.as_tensor(a).to(torch.int32), n)
        b = mult.wrap_operand(torch.as_tensor(b).to(torch.int32), n)
        r, c = self._rc(a.device)
        corr = r[(a + off).long()] + c[(b + off).long()]
        return a * b + corr.to(torch.int32)

    def _contract3(self, a3, b3):
        n = self.meta.width
        off = 1 << (n - 1)
        # wrap into the width's operand domain first, so the exact
        # contraction and the correction gathers see the operands the scalar
        # model does
        aw = mult.wrap_operand(a3.to(torch.int32), n)
        bw = mult.wrap_operand(b3.to(torch.int32), n)
        exact = _exact_int_matmul(self._stor(aw), self._stor(bw))
        r, c = self._rc(a3.device)
        ra = r[(aw + off).long()].sum(dim=2)  # (B, M)
        cb = c[(bw + off).long()].sum(dim=1)  # (B, N)
        corr = ra[:, :, None] + cb[:, None, :]
        return exact + corr.to(torch.int32)


class CudaSubstrate(_SubstrateBase):
    """The hand-written CUDA kernels, for every wiring at widths 3..8.

    Counterpart of ``repro``'s ``PallasSubstrate``, with its two kernel
    strategies behind one spec family, both bit-identical to
    ``approx_bitexact`` at the same wiring and width:

    * ``"closed_form"`` — the wiring's closed form: contractions through
      ``kernels/approx_matmul``, convolutions through the closed-form kind
      of ``kernels/fused_conv``;
    * ``"lut"`` — one read per product of the wiring's flat (2^N · 2^N,)
      product table: contractions through ``kernels/lut_matmul``,
      convolutions through the LUT kind of ``kernels/fused_conv``. The
      automatic choice for product models with no CSP closed form
      (``"exact"``); forceable with ``kernel="lut"``.

    ``kernel="auto"`` (the default) takes the closed form where the wiring
    has one; ``kernel="closed_form"`` raises for ``"exact"``. The batch
    dims of ``dot_general`` become the kernels' grid z, not a Python loop.
    On CPU tensors the kernels run their plain versions.
    """

    def __init__(self, mult_name: str | None = None, kernel: str = "auto"):
        base, n = _split_suffix(mult_name)
        key, _, n = mult.resolve_multiplier(base, n)
        if n > lut_lib.MAX_LUT_BITS:
            raise ValueError(
                f"approx_cuda serves widths <= {lut_lib.MAX_LUT_BITS} (got "
                f"{n}); use approx_bitexact for wider operands")
        if kernel not in ("auto", "closed_form", "lut"):
            raise ValueError(
                f"unknown approx_cuda kernel strategy {kernel!r} "
                "(known: auto, closed_form, lut)")
        from repro_torch.kernels.closed_form import make_closed_form

        self._key = key
        self._f00 = lut_lib.f00(key)
        self._product_fn = None
        if kernel in ("auto", "closed_form"):
            try:
                self._product_fn = make_closed_form(key)
            except ValueError:  # no CSP structure (e.g. "exact")
                if kernel == "closed_form":
                    raise
        self._kernel_kind = "closed_form" if self._product_fn else "lut"
        self.meta = SubstrateMeta(
            "approx_cuda", base, bit_exact=True, scalar_faithful=True,
            preferred_backend="cuda",
            cost_hint="int32-alu" if self._product_fn else "gather", width=n)

    def scalar(self, a, b):
        if self._product_fn is not None:
            return self._product_fn(a, b)
        return lut_lib.lut_multiply(a, b, lut_lib.build_lut(self._key))

    def _contract3(self, a3, b3):
        if self._product_fn is not None:
            from repro_torch.kernels.approx_matmul.ops import closed_form_matmul

            return closed_form_matmul(a3, b3, self._key)
        from repro_torch.kernels.lut_matmul.ops import device_table, lut_matmul

        return lut_matmul(a3, b3, device_table(self._key, a3.device))

    def fused_conv2d(self, imgs: Tensor, kernel) -> Tensor:
        """Fused 'same' conv of (B, H, W) int32 images in this substrate's
        kernel kind (``kernels/fused_conv``); bit-identical to the im2col +
        ``dot_general`` path."""
        from repro_torch.kernels.fused_conv.ops import fused_conv2d

        return fused_conv2d(imgs, kernel, self._key,
                            kernel_kind=self._kernel_kind)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_FACTORIES: Dict[str, Callable] = {}


def register_substrate(name: str, factory: Callable) -> None:
    """Register a backend under ``name``; the factory takes a mult suffix (or
    ``None`` when the spec carried no wiring)."""
    _FACTORIES[name] = factory


def list_substrates() -> list[str]:
    """Registered backend names (stable order)."""
    return sorted(_FACTORIES)


class SpecParts(NamedTuple):
    """Parsed ``"backend[:mult_name[@N]]"`` spec string."""

    backend: str
    mult_name: str
    width: int


def _split_spec(spec: str) -> tuple[str, str | None]:
    """Validated ``"backend[:mult_name[@N]]"`` split → (backend, suffix).

    Rejects malformed specs instead of silently normalizing them: an empty
    backend or wiring suffix and any whitespace are grammar errors.
    """
    s = str(spec)
    if not s or any(c.isspace() for c in s):
        raise ValueError(
            f"malformed substrate spec {spec!r}: specs follow "
            "backend[:mult_name[@N]] with no whitespace")
    name, sep, suffix = s.partition(":")
    if not name or (sep and not suffix):
        part = "backend" if not name else "wiring suffix"
        raise ValueError(
            f"malformed substrate spec {spec!r}: empty {part} — specs "
            "follow backend[:mult_name[@N]]")
    return name, (suffix if sep else None)


def parse_spec(spec: str) -> SpecParts:
    """``"backend[:mult_name[@N]]"`` → (backend, mult_name, width)."""
    name, suffix = _split_spec(spec)
    base, width = mult.split_width(suffix or "proposed")
    if not base:
        raise ValueError(
            f"malformed substrate spec {spec!r}: empty wiring name before "
            "'@' — specs follow backend[:mult_name[@N]]")
    return SpecParts(name, base, width)


@functools.lru_cache(maxsize=None)
def get_substrate(spec: str = "exact", mult_name: str | None = None):
    """Resolve a spec string to a (cached) substrate instance.

    An explicit ``mult_name`` (which may carry ``@N``) overrides the spec's
    suffix. Approx backends default a missing wiring to ``"proposed"`` at
    width 8; exact backends reject any suffix.
    """
    name, suffix = _split_spec(spec)
    if name not in _FACTORIES:
        raise ValueError(
            f"unknown product substrate: {name!r} (known: {list_substrates()})")
    return _FACTORIES[name](mult_name or suffix or None)


def as_substrate(s):
    """Accept either a spec string or an already-resolved substrate."""
    if isinstance(s, str):
        return get_substrate(s)
    return s


register_substrate("exact", ExactSubstrate)
register_substrate("int8", Int8Substrate)
register_substrate("approx_bitexact", BitexactSubstrate)
register_substrate("approx_lut", LutSubstrate)
register_substrate("approx_stat", StatSubstrate)
register_substrate("approx_cuda", CudaSubstrate)
register_substrate("approx_pallas", CudaSubstrate)  # specs written for repro
