"""Procedural test images for the edge-detection application (no network,
no binary assets — images are generated, deterministic, and license-free).

A copy of ``repro.data.images``: the same generators give the same uint8
arrays in both packages."""
from __future__ import annotations

import numpy as np


def test_image(h: int = 96, w: int = 96) -> np.ndarray:
    """Geometric test card: gradient + rectangle + disk (strong edges)."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = (xx * 255 / w).astype(np.float64)
    img[h // 4:h // 2, w // 4:w // 2] = 220
    img[(yy - 3 * h // 4) ** 2 + (xx - 3 * w // 4) ** 2 < (h // 6) ** 2] = 30
    return img.astype(np.uint8)


def image_batch(n: int = 8, h: int = 64, w: int = 64, seed: int = 0,
                noise: float = 0.0) -> np.ndarray:
    """(n, h, w) uint8 batch of distinct procedural images.

    Alternates shifted geometric test cards with photo-statistics images so a
    batch exercises both hard edges and natural gradients — the batched
    edge-detection pipeline (``nn.conv.edge_detect_batched``) consumes this.
    ``noise`` adds i.i.d. Gaussian sensor noise of that std (in pixel units)
    to every image, for robustness sweeps of the approximate edge maps.
    """
    base = test_image(h, w)
    out = np.empty((n, h, w), np.uint8)
    for i in range(n):
        if i % 2 == 0:
            out[i] = np.roll(base, (i * 3) % w, axis=1)
        else:
            out[i] = photo_like(h, w, seed=seed + i)
    if noise > 0:
        out = _add_noise(out, noise, seed)
    return out


def _add_noise(imgs: np.ndarray, std: float, seed: int) -> np.ndarray:
    """Gaussian sensor noise of ``std`` pixel units, clipped back to uint8."""
    r = np.random.default_rng(seed + 0x5EED)
    noisy = imgs.astype(np.float64) + r.normal(0, std, imgs.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


MIXED_SHAPES = ((48, 64), (64, 64), (33, 47), (64, 96), (96, 96), (17, 129))


def mixed_shape_batch(n: int = 8, shapes=MIXED_SHAPES, seed: int = 0,
                      noise: float = 0.0) -> list:
    """List of n uint8 images cycling through heterogeneous (h, w) shapes.

    The ragged counterpart of :func:`image_batch` — same alternation of
    shifted test cards and photo-statistics images, but cycling shapes that
    include non-multiples of common bucket granularities, so shape-bucketing
    and padding paths (``serving.EdgeDetectService``) are exercised by a real
    generator instead of hand-built arrays.
    """
    if not shapes:
        raise ValueError("shapes must be non-empty")
    out = []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        if i % 2 == 0:
            img = np.roll(test_image(h, w), (seed + 3 * i) % w, axis=1)
        else:
            img = photo_like(h, w, seed=seed + i)
        out.append(_add_noise(img, noise, seed + i) if noise > 0 else img)
    return out


def photo_like(h: int = 128, w: int = 128, seed: int = 3) -> np.ndarray:
    """Natural-statistics image: low-frequency background + objects + texture."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w))
    for _ in range(6):
        fy, fx = r.uniform(0.5, 3, 2)
        ph = r.uniform(0, 2 * np.pi, 2)
        img += r.uniform(20, 60) * np.cos(2 * np.pi * fy * yy / h + ph[0]) \
            * np.cos(2 * np.pi * fx * xx / w + ph[1])
    img += 128
    img[h // 5:h // 2, w // 6:w // 3] += 60
    img[(yy - 2 * h // 3) ** 2 + (xx - 2 * w // 3) ** 2 < (h // 5) ** 2] -= 70
    img += r.normal(0, 6, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)
