"""Perlin gradient noise + noisy-depth baseline generation.

Counterpart of ``efficientdepthestimation_tpu/benchmark/noise.py`` (the
DepthRenderer ``utils.perlin`` + ``create_noisy_depth_maps``,
Benchmark/benchmark.py:799-842): ground-truth depth overlaid with 3 octaves
of Perlin noise (cell scales 32/16/8). The JAX package seeds the global
``np.random`` with 42; here an explicit ``np.random.RandomState(seed)`` is
passed down, which draws the same numbers, so the maps are the same bit for
bit.
"""

from __future__ import annotations

import datetime
import os

import numpy as np

from efficientdepthestimation_tpu_torch.utils.timer import Timer

__all__ = ["perlin", "overlay_noise", "create_noisy_depth_maps"]


def perlin(width: int, height: int, rng: np.random.RandomState,
           scale: int = 32) -> np.ndarray:
    """Classic 2-D Perlin gradient noise, one value per pixel.

    ``scale`` is the lattice cell size in pixels; the lattice gradients'
    angles are drawn from ``rng`` (benchmark.py:819).
    """
    gx = width // scale + 2
    gy = height // scale + 2
    angles = rng.uniform(0, 2 * np.pi, (gy, gx))
    gradients = np.stack([np.cos(angles), np.sin(angles)], axis=-1)

    xs = np.arange(width) / scale
    ys = np.arange(height) / scale
    xi = xs.astype(int)
    yi = ys.astype(int)
    xf = (xs - xi)[None, :]
    yf = (ys - yi)[:, None]

    def fade(t):
        return t * t * t * (t * (t * 6 - 15) + 10)

    u, v = fade(xf), fade(yf)

    def dot_grad(iy, ix, dy, dx):
        g = gradients[iy + dy][:, xi + dx]  # (H, W, 2)
        return g[..., 0] * (xf - dx) + g[..., 1] * (yf - dy)

    n00 = dot_grad(yi, xi, 0, 0)
    n01 = dot_grad(yi, xi, 0, 1)
    n10 = dot_grad(yi, xi, 1, 0)
    n11 = dot_grad(yi, xi, 1, 1)
    x0 = n00 + u * (n01 - n00)
    x1 = n10 + u * (n11 - n10)
    return x0 + v * (x1 - x0)


def overlay_noise(image: np.ndarray, rng: np.random.RandomState,
                  scale: int = 32) -> np.ndarray:
    """GT depth (H, W[, 1]) uint8-ish + normalized perlin → renormalized uint8
    (benchmark.py:800-815)."""
    height, width = image.shape[:2]
    noise = perlin(width, height, rng, scale)
    noise = (noise - noise.min()) / (noise.max() - noise.min())
    noise = 255 * noise
    if image.ndim == 3:
        noise = noise[..., None]
    new_image = image.astype(np.float64) + noise
    new_image = new_image / new_image.max()
    return (255 * new_image).astype(np.uint8)


def create_noisy_depth_maps(output_path: str, depth_maps,
                            seed: int = 42) -> datetime.timedelta:
    """Write 3-octave noisy versions of ``depth_maps`` (iterable of (H, W)
    metre-scaled or uint8 arrays) as {i:06d}.png."""
    from PIL import Image

    timer = Timer()
    with timer:
        os.makedirs(output_path, exist_ok=True)
        existing = len(os.listdir(output_path))
        depth_maps = list(depth_maps)
        if existing == len(depth_maps):
            print("Found cached results, skipping...")
            return timer.elapsed

        rng = np.random.RandomState(seed)
        for i, depth in enumerate(depth_maps):
            depth = np.asarray(depth)
            if depth.dtype != np.uint8:
                dmax = max(float(depth.max()), np.finfo(np.float32).tiny)
                depth = (255 * depth / dmax).astype(np.uint8)
            if depth.ndim == 3:
                depth = depth[..., 0]
            depth = depth[..., None]
            for scale in (32, 16, 8):
                depth = overlay_noise(depth, rng, scale)
            Image.fromarray(depth.squeeze()).save(
                os.path.join(output_path, f"{i:06d}.png"))
            print(f"\rProgress: [{i:03,d}/{len(depth_maps):03,d}] - "
                  f"Elapsed Time: {timer.elapsed}", end="")
        print()
    return timer.elapsed
