"""2-D convolution under the approximate multiplier (paper §4).

Counterpart of ``repro.nn.conv``. The paper's application: 3×3 Laplacian
edge detection where every pixel×coefficient product runs through the
approximate signed multiplier, followed by exact accumulation.

Two execution paths:

* :func:`conv2d_int` — the reference single-image loop over kernel taps,
  taking an arbitrary scalar-product function (the parity oracle);
* :func:`conv2d_batched` — batched NHW(C) 'same' convolution: the
  substrate's fused conv kernel where it has one (``approx_cuda``), else one
  im2col + substrate contraction. Both paths contract the same zero-padded
  tap products in the same int32 ring, so they are bit-identical.
* :func:`edge_detect_planned` — the Laplacian split into tap groups, each
  contracted on the substrate a :class:`~repro_torch.nn.plan.SubstratePlan`
  assigns to its site.

Pixels map to the signed operand domain of the substrate's width by an
arithmetic shift (0..255 → 0..2^(N-1)-1); kernel coefficients outside the
signed N-bit range wrap (the Laplacian's center tap 8 wraps to −8 at N=4).
Edge maps are rescaled back to the 8-bit output range before clipping.

Functions here take torch tensors for images; the tensor's device decides
where the work runs.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import multiplier as mult
from repro_torch.obs.meter import current_meter

Tensor = torch.Tensor

LAPLACIAN = np.array([[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]], dtype=np.int32)


def _images(x, what: str = "images") -> Tensor:
    if not torch.is_tensor(x):
        raise TypeError(f"{what} must be a torch tensor (its device decides "
                        f"where the work runs), got {type(x).__name__}")
    return x


def to_signed_pixels(img: Tensor, n: int = 8) -> Tensor:
    """uint8 image(s) (0..255) → signed n-bit operand domain (0..2^(n-1)-1)."""
    x = _images(img).to(torch.int32)
    return (x >> (9 - n)) if n <= 9 else (x << (n - 9))


def _rescale_raw(raw: Tensor, n: int) -> Tensor:
    """Map a width-n conv response back to the 8-bit output range (pixels
    scale as 2^(n-8) relative to the n=8 harness)."""
    if n == 8:
        return raw
    return (raw << (8 - n)) if n < 8 else (raw >> (n - 8))


def _kernel_tensor(kernel, device) -> Tensor:
    return torch.as_tensor(np.asarray(kernel.cpu() if torch.is_tensor(kernel)
                                      else kernel)).to(torch.int32).to(device)


def conv2d_int(img: Tensor, kernel, product_fn: Callable[[Tensor, Tensor], Tensor]
               ) -> Tensor:
    """Zero-padded 'same' 2-D convolution with a custom scalar product.

    img: (H, W) int32; kernel: (kh, kw) ints. Accumulation is exact int32.
    Reference implementation — the batched pipeline is :func:`conv2d_batched`.
    """
    img = _images(img, "img").to(torch.int32)
    kernel = _kernel_tensor(kernel, "cpu")
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    x = F.pad(img, (pw, pw, ph, ph))
    h, w = img.shape
    out = torch.zeros((h, w), dtype=torch.int32, device=img.device)
    for di in range(kh):
        for dj in range(kw):
            coeff = torch.full((), int(kernel[di, dj]), dtype=torch.int32,
                               device=img.device)
            out = out + product_fn(x[di:di + h, dj:dj + w], coeff)
    return out


def _im2col(imgs: Tensor, kh: int, kw: int, taps=None) -> Tensor:
    """(B, H, W) int32, zero 'same' padding → (B, H, W, len(taps)) patches of
    the flat row-major tap indices ``taps`` (default: all kh·kw). Slices
    only, so no index tensor is copied to the device."""
    _, h, w = imgs.shape
    ph, pw = kh // 2, kw // 2
    x = F.pad(imgs, (pw, pw, ph, ph))
    taps = range(kh * kw) if taps is None else taps
    cols = [x[:, t // kw:t // kw + h, t % kw:t % kw + w] for t in taps]
    return torch.stack(cols, dim=-1)


# im2col patches are (B, H, W, taps); contract the tap axis with the
# flattened kernel
_CONV_DIMS = (((3,), (0,)), ((), ()))


def _meter_fused(s, imgs: Tensor, kernel, kh: int, kw: int, site=None) -> None:
    """Telemetry for the fused conv path, which bypasses ``dot_general``.

    Records the contraction the fused kernel performs — per pixel, one
    tap-axis dot: ``(B, H·W, kh·kw) @ (kh·kw, 1)`` — on the ambient meter,
    so fused and im2col runs report identical MAC/energy totals. The
    opt-in error probe samples a small leading-rows im2col slab (the
    fused kernel contracts the same zero-padded tap products).
    """
    meter = current_meter()
    if meter is None:
        return
    b, h, w = imgs.shape
    meter.record_contraction(s.meta, b, h * w, kh * kw, 1, site=site)
    if meter.error_probe and s.meta.mult_name != "exact":
        slab = _im2col(imgs[:1, :8], kh, kw)  # (1, ≤8, W, taps)
        taps = _kernel_tensor(kernel, imgs.device).reshape(1, kh * kw, 1)
        meter.probe(s.meta, s.scalar, slab.reshape(1, -1, kh * kw), taps,
                    site=site)


def conv2d_batched(imgs: Tensor, kernel, substrate="approx_bitexact",
                   partitioning=None, fused: "bool | None" = None,
                   site: "str | None" = None) -> Tensor:
    """Batched 'same' integer convolution under a substrate.

    imgs: (B, H, W) or NHWC (B, H, W, C) integer tensor (channels are
    convolved independently with the same kernel); kernel: (kh, kw) ints.
    Returns int32 of imgs' shape.

    ``partitioning``: optional
    :class:`repro_torch.nn.substrate.Partitioning` — shards the im2col
    contraction over its mesh (bit-identical for bit-exact substrates).

    ``fused`` selects the substrate's fused conv kernel: ``None`` (default)
    picks it whenever the substrate has ``fused_conv2d`` (``approx_cuda``)
    and no partitioning was requested; ``True`` forces it (raising where
    unavailable or partitioned: the fused kernel contracts K in full on
    one rank); ``False`` forces the im2col + ``dot_general`` path. Both are
    bit-identical. ``site`` names the contraction site (observational
    only).
    """
    from repro_torch.nn import substrate as sub

    s = sub.as_substrate(substrate)
    imgs = _images(imgs).to(torch.int32)
    nhwc = imgs.dim() == 4
    if nhwc:  # fold channels into the batch: depthwise, shared kernel
        b, h, w, c = imgs.shape
        imgs = imgs.permute(0, 3, 1, 2).reshape(b * c, h, w)
    if imgs.dim() != 3:
        raise ValueError(f"imgs must be (B,H,W) or (B,H,W,C); got {tuple(imgs.shape)}")
    kh, kw = tuple(kernel.shape) if hasattr(kernel, "shape") else np.shape(kernel)
    if fused is None:
        fused = partitioning is None and hasattr(s, "fused_conv2d")
    if fused:
        if not hasattr(s, "fused_conv2d"):
            raise ValueError(
                f"fused=True but substrate {s.meta.spec} has no fused conv "
                "kernel (only approx_cuda does); use fused=False")
        if partitioning is not None:
            raise ValueError(
                "fused=True is incompatible with partitioning — the fused "
                "kernel contracts K in full inside one device kernel")
        _meter_fused(s, imgs, kernel, kh, kw, site=site)
        out = s.fused_conv2d(imgs, kernel)
    else:
        # the only path that needs the taps on the device: the fused kernel
        # takes them by value, so it adds no blocking host→device copy
        kernel_t = _kernel_tensor(kernel, imgs.device)
        patches = _im2col(imgs, kh, kw)  # (B, H, W, kh·kw)
        spec = sub.ContractionSpec(_CONV_DIMS, partitioning=partitioning,
                                   site=site)
        out = s.dot_general(patches, kernel_t.reshape(kh * kw, 1),
                            spec)[..., 0]
    if nhwc:
        out = out.reshape(b, c, h, w).permute(0, 2, 3, 1)
    return out


def edge_detect(img_u8: Tensor, mult_name: str = "proposed") -> Tensor:
    """Laplacian edge map of one (H, W) uint8 image with the named multiplier
    (single-image reference path, tap loop); returns a uint8 map."""
    _, fn, n = mult.resolve_multiplier(mult_name)
    px = to_signed_pixels(img_u8, n)
    raw = conv2d_int(px, LAPLACIAN, fn)
    return torch.clamp(_rescale_raw(raw, n), 0, 255).to(torch.uint8)


def edge_detect_batched(imgs_u8: Tensor, substrate="approx_bitexact",
                        partitioning=None) -> Tensor:
    """Laplacian edge maps for a (B, H, W) uint8 batch under one substrate.

    Pixels are mapped into the substrate's operand width and the response
    rescaled back to the 8-bit output range. Under a ``partitioning`` the
    contraction is sharded over its mesh (every rank passes the whole
    batch and gets every map), bit-identical for bit-exact substrates.
    Returns (B, H, W) uint8 on the input's device.
    """
    from repro_torch.nn import substrate as sub

    s = sub.as_substrate(substrate)
    n = s.meta.width
    px = to_signed_pixels(imgs_u8, n)
    raw = conv2d_batched(px, LAPLACIAN, s, partitioning=partitioning,
                         site=EDGE_SITE)
    return torch.clamp(_rescale_raw(raw, n), 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# planned (multi-site) edge detection
# ---------------------------------------------------------------------------

#: site name of the uniform whole-kernel edge contraction
EDGE_SITE = "conv.edge"

#: the planned path's tap groups: each is a *split* of the 3×3 Laplacian —
#: (site leaf, flat tap indices into the row-major kernel). The center tap
#: (coefficient 8) dominates the response; the ring taps (all −1) are the
#: smoothing term and tolerate cheaper substrates.
_EDGE_TAP_GROUPS = (("center", (4,)), ("ring", (0, 1, 2, 3, 5, 6, 7, 8)))


def edge_tap_sites() -> tuple:
    """The planned edge workload's site names (``conv.edge.<group>``)."""
    return tuple(f"{EDGE_SITE}.{name}" for name, _ in _EDGE_TAP_GROUPS)


def edge_detect_planned(imgs_u8: Tensor, plan, partitioning=None) -> Tensor:
    """Laplacian edge maps under a per-site :class:`~repro_torch.nn.plan.SubstratePlan`.

    The 3×3 conv splits into tap groups — ``conv.edge.center`` (the ×8 tap)
    and ``conv.edge.ring`` (the eight −1 taps) — each contracted on the
    substrate the plan assigns to its site, with pixels mapped to that
    substrate's width and the response rescaled by it, then summed in the
    exact int32 adder. Every substrate corrects its own f(0,0) padding, so a
    uniform plan reproduces :func:`edge_detect_batched` exactly. Per-group
    widths ≤ 8 rescale by left shifts, which distribute over the adder.
    ``partitioning`` shards each group's contraction over its mesh.
    Returns (B, H, W) uint8 on the input's device.
    """
    from repro_torch.kernels import build
    from repro_torch.nn import plan as plan_mod
    from repro_torch.nn import substrate as sub

    plan = plan_mod.as_plan(plan)
    imgs_u8 = _images(imgs_u8)
    lap = LAPLACIAN.reshape(-1)
    total = None
    for name, taps in _EDGE_TAP_GROUPS:
        site = f"{EDGE_SITE}.{name}"
        s = sub.get_substrate(plan.resolve(site))
        n = s.meta.width
        px = to_signed_pixels(imgs_u8, n)
        patches = _im2col(px, 3, 3, taps)
        coeffs = build.device_constant(
            ("edge_taps", name), imgs_u8.device,
            lambda taps=taps: lap[list(taps)].reshape(len(taps), 1))
        spec = sub.ContractionSpec(_CONV_DIMS, partitioning=partitioning,
                                   site=site)
        raw = s.dot_general(patches, coeffs, spec)[..., 0]
        r = _rescale_raw(raw, n)
        total = r if total is None else total + r
    return torch.clamp(total, 0, 255).to(torch.uint8)


def psnr(ref, test, peak: float = 255.0) -> float:
    """PSNR in dB between two uint8 images (paper Fig. 9 metric), computed in
    float32 like the reference."""
    def f32(x):
        if torch.is_tensor(x):
            return x.to(torch.float32)
        return torch.from_numpy(np.array(x, dtype=np.float32))

    r = f32(ref)
    t = f32(test).to(r.device)
    mse = torch.mean((r - t) ** 2)
    if float(mse) == 0:
        return float("inf")
    return float(10.0 * torch.log10(peak ** 2 / mse))


def conv2d_float(x: Tensor, kernel) -> Tensor:
    """Float reference conv ('same', zero pad) used by NN-layer tests: the
    taps summed in ``repro``'s order, each ``kernel[di, dj] * window``."""
    kernel = torch.as_tensor(kernel, device=x.device)
    kh, kw = kernel.shape
    xp = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2))
    h, w = x.shape
    out = torch.zeros_like(x)
    for di in range(kh):
        for dj in range(kw):
            out = out + kernel[di, dj] * xp[di:di + h, dj:dj + w]
    return out
