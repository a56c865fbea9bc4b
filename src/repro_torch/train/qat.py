"""Approximation-aware training (QAT): a differentiable approximate forward.

Counterpart of ``repro.train.qat``. The integer contraction of
:mod:`repro_torch.nn.substrate` has no useful gradient: the quantization
rounds, and its integer codes leave the autograd graph. The
straight-through estimator (STE) makes it trainable:

* **forward** — exactly the substrate's own ``dot_general``: quantize, the
  wiring's integer product (on the card, the CUDA kernels), dequantize. It
  runs inside ``torch.autograd.Function.forward``, where autograd records
  nothing, so the kernels see the int8 codes as in serving. Values are
  bit-identical to inference on that substrate.
* **backward** — the float32 gradient of ``x @ w`` under the same
  dimension numbers, with the quantize → product → dequantize chain taken
  as the identity, cast to each operand's dtype. With
  ``QATPolicy(moment_correction=True)``, the separable error model behind
  ``approx_stat`` (``f(a, b) ≈ a·b + r(a) + c(b) − µ``) adds its slopes
  ``r'(a)`` and ``c'(b)``, sampled at the operand codes the forward used.
  ``repro`` has no backward kernel: this is plain torch.

:func:`qat_scope` installs the STE through
:func:`repro_torch.nn.substrate.dot_override_scope`, so every
``models.common.dense`` keeps resolving its site through the plan and each
site trains under its own wiring. ``QATPolicy(forward="stat")`` rewrites
each resolved spec to its ``approx_stat`` counterpart.

The module also carries the trainable edge-detection workload: a float 3×3
kernel and an affine output calibration whose forward is the planned
tap-group contraction of :func:`repro_torch.nn.conv.edge_detect_planned`,
and its :func:`finetune_edge` recovery loop.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import lut as lut_lib
from repro_torch.kernels import build
from repro_torch.nn import conv as conv_lib
from repro_torch.nn import plan as plan_mod
from repro_torch.nn import substrate as psub

Tensor = torch.Tensor

_FORWARD_MODES = ("bitexact", "stat")


@dataclasses.dataclass(frozen=True)
class QATPolicy:
    """How a resolved (site → spec) assignment contracts during training.

    forward:            ``"bitexact"`` runs each resolved spec as it is (the
                        deployment numerics); ``"stat"`` rewrites approximate
                        specs through :func:`repro_torch.nn.plan.stat_spec`
                        to the separable error-moment model, same wiring and
                        width.
    moment_correction:  add the error model's ``r'(a)`` / ``c'(b)`` slopes
                        to the STE backward. Off by default.
    """

    forward: str = "bitexact"
    moment_correction: bool = False

    def __post_init__(self):
        if self.forward not in _FORWARD_MODES:
            raise ValueError(
                f"QATPolicy.forward must be one of {_FORWARD_MODES}; "
                f"got {self.forward!r}")

    def forward_spec(self, spec_str: str) -> str:
        """The spec the QAT forward actually runs for ``spec_str``."""
        return (plan_mod.stat_spec(spec_str) if self.forward == "stat"
                else spec_str)

    def describe(self) -> Dict[str, Any]:
        """JSON-serializable record (checkpoint manifests, bundles)."""
        return {"forward": self.forward,
                "moment_correction": self.moment_correction}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "QATPolicy":
        return cls(forward=d.get("forward", "bitexact"),
                   moment_correction=bool(d.get("moment_correction", False)))


# ---------------------------------------------------------------------------
# the straight-through contraction
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _slope_tables(mult_key: str):
    """Central differences of the separable error model's r and c tables
    (rows by signed operand value, as ``core.lut.error_lut``): the
    first-order sensitivities of the expected error to each operand."""
    r, c, _mu = psub._stat_tables(mult_key)
    return (np.gradient(r.astype(np.float64)).astype(np.float32),
            np.gradient(c.astype(np.float64)).astype(np.float32))


def _unplan3(t3: Tensor, shape, perm) -> Tensor:
    """Invert ``_Plan.lhs3`` / ``rhs3``: (B, ·, ·) → the operand's layout."""
    inv = tuple(int(i) for i in np.argsort(perm))
    return t3.reshape(tuple(shape[p] for p in perm)).permute(inv)


def _moment_terms(sub, cspec: psub.ContractionSpec, plan, x: Tensor,
                  w: Tensor, g: Tensor):
    """Error-moment STE correction terms (dx_corr, dw_corr).

    With the separable model ``out[m,n] = sx·sw[n]·Σ_k (a·b + r(a) + c(b) −
    µ)``, ``a = x/sx``, ``b = w/sw``: ``∂out/∂x[m,k] += sw[n]·r'(a[m,k])`` and
    ``∂out/∂w[k,n] += sx[m]·c'(b[k,n])``. The codes come from the forward's
    own quantization policy.
    """
    q = cspec.quant
    n = sub.meta.width
    bits = q.bits if q.bits is not None else n
    off = 1 << (n - 1)
    qa, sa = psub._quantize_operand(plan.lhs3(x), q.x_mode, q.x_scale,
                                    contract_axis=2, bits=bits, eps=q.eps)
    qb, sb = psub._quantize_operand(plan.rhs3(w), q.w_mode, q.w_scale,
                                    contract_axis=1, bits=bits, eps=q.eps)
    key = sub.meta.mult_key
    rp = build.device_constant(("qat_slope_r", key), x.device,
                               lambda: _slope_tables(key)[0])
    cp = build.device_constant(("qat_slope_c", key), x.device,
                               lambda: _slope_tables(key)[1])
    g3 = g.to(torch.float32).reshape(plan.b, plan.m, plan.n)
    sa = sa.to(torch.float32)
    sb = sb.to(torch.float32)
    ai = ((qa.to(torch.int32) + off) & ((1 << n) - 1)).long()
    bi = ((qb.to(torch.int32) + off) & ((1 << n) - 1)).long()
    # Σ_n g[m,n]·sw[n] and Σ_m g[m,n]·sx[m] (scales broadcast: scalar or
    # per channel, (B,1,N) / (B,M,1))
    gw = (g3 * sb).sum(dim=2, keepdim=True)           # (B, M, 1)
    ga = (g3 * sa).sum(dim=1, keepdim=True)           # (B, 1, N)
    dx3 = rp[ai] * gw                                 # (B, M, K)
    dw3 = cp[bi] * ga                                 # (B, K, N)
    return (_unplan3(dx3, x.shape, plan.lhs_perm),
            _unplan3(dw3, w.shape, plan.rhs_perm))


def _moment_correctable(sub, cspec: psub.ContractionSpec) -> bool:
    return (cspec.quant is not None and sub.meta.mult_name != "exact"
            and sub.meta.width <= lut_lib.MAX_LUT_BITS)


class _StraightThrough(torch.autograd.Function):
    """Forward: ``sub.dot_general(x, w, cspec)``; backward: the float VJP
    of ``x @ w`` under ``cspec``'s dimension numbers (+ moment terms)."""

    @staticmethod
    def forward(ctx, x, w, sub, cspec, moment):
        ctx.save_for_backward(x, w)
        ctx.sub, ctx.cspec, ctx.moment = sub, cspec, moment
        return sub.dot_general(x, w, cspec)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        plan = psub._plan_contraction(tuple(x.shape), tuple(w.shape),
                                      ctx.cspec.dimension_numbers)
        want = [i for i, need in enumerate(ctx.needs_input_grad[:2]) if need]
        with torch.enable_grad():
            xf = x.detach().requires_grad_(0 in want)
            wf = w.detach().requires_grad_(1 in want)
            out = plan.unflatten(torch.matmul(plan.lhs3(xf.to(torch.float32)),
                                              plan.rhs3(wf.to(torch.float32))))
            got = torch.autograd.grad(out, [(xf, wf)[i] for i in want],
                                      g.to(torch.float32))
        grads = [None, None]
        for i, t in zip(want, got):
            grads[i] = t
        if ctx.moment and _moment_correctable(ctx.sub, ctx.cspec):
            dxc, dwc = _moment_terms(ctx.sub, ctx.cspec, plan, x, w, g)
            for i, corr in ((0, dxc), (1, dwc)):
                if grads[i] is not None:
                    grads[i] = grads[i] + corr.to(grads[i].dtype)
        return grads[0], grads[1], None, None, None


def qat_dot_general(x: Tensor, w: Tensor, spec_str: str,
                    cspec: Optional[psub.ContractionSpec] = None,
                    policy: Optional[QATPolicy] = None) -> Tensor:
    """Differentiable contraction of float operands on an approximate spec.

    Forward values are bit-identical to
    ``get_substrate(policy.forward_spec(spec_str)).dot_general(x, w, cspec)``;
    the backward is the straight-through estimator of the module docstring.
    ``exact`` runs the substrate's float path, which autograd already
    differentiates.
    """
    policy = policy if policy is not None else QATPolicy()
    cspec = (cspec if cspec is not None
             else psub.ContractionSpec.matmul(quant=psub.QuantPolicy()))
    if cspec.quant is None:
        raise ValueError(
            "QAT contractions need a QuantPolicy (float operands); the "
            "integer-domain dot_general has no float gradient to estimate")
    sub = psub.get_substrate(policy.forward_spec(spec_str))
    if sub.meta.name == "exact":
        return sub.dot_general(x, w, cspec)
    return _StraightThrough.apply(x, w, sub, cspec, policy.moment_correction)


@contextlib.contextmanager
def qat_scope(policy: Optional[QATPolicy] = None):
    """Route every plan-resolved model contraction through the STE.

    Installs :func:`qat_dot_general` as the ambient
    :func:`repro_torch.nn.substrate.dot_override_scope` hook, so
    ``models.common.dense`` contracts differentiably on whatever spec the
    plan resolves per site. Thread-local: wrap the loss call, as
    :class:`repro_torch.train.loop.TrainLoop` does.
    """
    policy = policy if policy is not None else QATPolicy()

    def _override(spec_str, x, w, cspec):
        return qat_dot_general(x, w, spec_str, cspec, policy)

    with psub.dot_override_scope(_override):
        yield policy


# ---------------------------------------------------------------------------
# trainable edge-detection workload (the paper's application, QAT-ified)
# ---------------------------------------------------------------------------


def init_edge_params(device="cpu") -> Dict[str, Tensor]:
    """Float Laplacian kernel + affine output calibration (gain·resp + bias).

    At init the forward reproduces :func:`repro_torch.nn.conv.edge_detect_planned`
    bit for bit (gain 1, bias 0, integer-valued kernel).
    """
    return {"kernel": torch.as_tensor(conv_lib.LAPLACIAN, dtype=torch.float32,
                                      device=device),
            "gain": torch.ones((), dtype=torch.float32, device=device),
            "bias": torch.zeros((), dtype=torch.float32, device=device)}


#: pinned unit scales: pixels and coefficients are already integer-domain
#: values, so quantization is a pure round() (the identity at init)
_EDGE_QUANT = psub.QuantPolicy(x_mode="per_tensor", w_mode="per_tensor",
                               x_scale=1.0, w_scale=1.0)


def edge_response(params: Dict[str, Tensor], imgs_u8: Tensor, plan,
                  policy: Optional[QATPolicy] = None) -> Tensor:
    """Differentiable planned edge response (float, 8-bit scale, unclipped).

    Mirrors :func:`repro_torch.nn.conv.edge_detect_planned`: per tap group
    the pixels map into the resolved substrate's width and the group
    contracts on that substrate through :func:`qat_dot_general` (on the card
    the narrow designs of the contraction kernels), so coefficient
    gradients flow; group responses rescale to the 8-bit range and sum, then
    the calibration applies. Widths must be in [5, 8], so the centre tap 8
    stays inside the symmetric quantizer's range.
    """
    plan = plan_mod.as_plan(plan)
    imgs = conv_lib._images(imgs_u8)
    kernel = params["kernel"].reshape(-1)
    total = None
    for name, taps in conv_lib._EDGE_TAP_GROUPS:
        site = f"{conv_lib.EDGE_SITE}.{name}"
        spec_str = plan.resolve(site)
        n = getattr(psub.get_substrate(spec_str).meta, "width", 8)
        if not 5 <= n <= 8:
            raise ValueError(
                f"QAT edge plan widths must be in [5, 8]; site {site} "
                f"resolved to {spec_str!r} (width {n})")
        px = conv_lib.to_signed_pixels(imgs, n).to(torch.float32)
        patches = conv_lib._im2col(px, 3, 3, taps)
        coeffs = kernel[list(taps)].reshape(len(taps), 1)
        cspec = psub.ContractionSpec(conv_lib._CONV_DIMS, quant=_EDGE_QUANT,
                                     site=site)
        raw = qat_dot_general(patches, coeffs, spec_str, cspec, policy)[..., 0]
        r = raw * float(1 << (8 - n))
        total = r if total is None else total + r
    return params["gain"] * total + params["bias"]


def edge_reference_response(imgs_u8: Tensor) -> Tensor:
    """Exact float Laplacian response at the 8-bit scale (training target)."""
    px = conv_lib.to_signed_pixels(imgs_u8, 8).to(torch.float32)
    patches = conv_lib._im2col(px, 3, 3)
    k = torch.as_tensor(conv_lib.LAPLACIAN, dtype=torch.float32,
                        device=px.device).reshape(-1)
    return (patches * k).sum(-1)


def edge_maps(params: Dict[str, Tensor], imgs_u8: Tensor, plan,
              policy: Optional[QATPolicy] = None) -> Tensor:
    """uint8 edge maps of the QAT edge model (round, clip)."""
    resp = edge_response(params, imgs_u8, plan, policy)
    return torch.clamp(torch.round(resp), 0, 255).to(torch.uint8)


def edge_psnr(params: Dict[str, Tensor], imgs_u8: Tensor, plan,
              policy: Optional[QATPolicy] = None) -> float:
    """PSNR (dB) of the QAT edge model against the exact-multiplier maps."""
    ref = conv_lib.edge_detect_batched(imgs_u8, "exact")
    return conv_lib.psnr(ref, edge_maps(params, imgs_u8, plan, policy))


@torch.no_grad()
def calibrate_edge(params: Dict[str, Tensor], imgs_u8: Tensor, plan,
                   policy: Optional[QATPolicy] = None) -> Dict[str, Tensor]:
    """Closed-form affine calibration: the least-squares (gain, bias) of
    ``gain·resp + bias ≈ target`` on the unclipped responses, from one
    forward pass."""
    k = params["kernel"]
    base = {**params, "gain": torch.ones((), dtype=torch.float32, device=k.device),
            "bias": torch.zeros((), dtype=torch.float32, device=k.device)}
    resp = edge_response(base, imgs_u8, plan, policy).reshape(-1)
    target = edge_reference_response(imgs_u8).reshape(-1)
    rm, tm = resp.mean(), target.mean()
    var = torch.clamp_min(((resp - rm) ** 2).mean(), 1e-6)
    gain = ((resp - rm) * (target - tm)).mean() / var
    bias = tm - gain * rm
    return {**params, "gain": gain.to(torch.float32),
            "bias": bias.to(torch.float32)}


def _copy(params: Dict[str, Tensor]) -> Dict[str, Tensor]:
    return {k: v.detach().clone() for k, v in params.items()}


def finetune_edge(imgs_u8: Tensor, plan, *, steps: int = 120, lr: float = 0.1,
                  policy: Optional[QATPolicy] = None,
                  params: Optional[Dict[str, Tensor]] = None,
                  calibrate: bool = True) -> Dict[str, Any]:
    """QAT fine-tune of the edge model under ``plan``'s wirings.

    The loss is the MSE between the unclipped QAT response and the exact
    float Laplacian response. Returns ``{"params", "losses", "psnr_pre",
    "psnr_post"}``, both PSNRs on the bit-exact forward whatever
    ``policy.forward`` is, and the params of the lowest loss seen (the
    start included). The images' device runs everything.
    """
    from repro_torch.optim import adamw

    policy = policy if policy is not None else QATPolicy()
    plan = plan_mod.as_plan(plan)
    imgs = conv_lib._images(imgs_u8)
    params = (_copy(params) if params is not None
              else init_edge_params(imgs.device))
    eval_policy = QATPolicy(forward="bitexact")
    psnr_pre = edge_psnr(params, imgs, plan, eval_policy)
    target = edge_reference_response(imgs)

    def loss_fn(p):
        resp = edge_response(p, imgs, plan, policy)
        return torch.mean((resp - target) ** 2)

    with torch.no_grad():
        best = (float(loss_fn(params)), _copy(params))
        if calibrate:
            params = calibrate_edge(params, imgs, plan, policy)
            cal_loss = float(loss_fn(params))
            if cal_loss < best[0]:
                best = (cal_loss, _copy(params))
    opt = adamw(weight_decay=0.0)
    state = opt.init(params)
    losses: List[float] = []
    for _ in range(int(steps)):
        prev = _copy(params)  # the update below is in place
        for t in params.values():
            t.requires_grad_(True)
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, list(params.values()))
        for t in params.values():
            t.requires_grad_(False)
        opt.update(dict(zip(params, grads)), state, params, lr)
        losses.append(float(loss.detach()))  # the loss at `prev`, pre-update
        if losses[-1] < best[0]:
            best = (losses[-1], prev)
    if steps:
        with torch.no_grad():
            final = float(loss_fn(params))
        if final < best[0]:
            best = (final, _copy(params))
    params = best[1]
    psnr_post = edge_psnr(params, imgs, plan, eval_policy)
    return {"params": params, "losses": losses,
            "psnr_pre": float(psnr_pre), "psnr_post": float(psnr_post)}
