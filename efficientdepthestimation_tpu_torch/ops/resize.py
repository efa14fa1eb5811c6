"""Resampling with PyTorch ``align_corners=True`` and PIL semantics.

Both resizes are separable, so each is two small matrix products with
interpolation matrices built on the host from float64 arithmetic (the same
functions as ``efficientdepthestimation_tpu/ops/resize.py``). PIL's antialiased
resampler is not ``F.interpolate(antialias=True)``; the matrices reproduce it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "bilinear_align_corners_matrix",
    "resize_bilinear_align_corners",
    "upsample_align_corners",
    "resize_nearest_torch",
    "nearest_torch_indices",
    "pil_resize_matrix",
    "pil_nearest_indices",
    "pil_resize",
    "device_constant",
]


@functools.lru_cache(maxsize=None)
def bilinear_align_corners_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) matrix for 1-D align_corners=True bilinear.

    torch maps output index ``i`` to source coordinate
    ``i * (in_size - 1) / (out_size - 1)`` (and 0 when out_size == 1).
    """
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    if out_size == 1:
        mat[0, 0] = 1.0
        return mat.astype(np.float32)
    scale = (in_size - 1) / (out_size - 1)
    src = np.arange(out_size, dtype=np.float64) * scale
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = src - lo
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo), 1.0 - frac)
    np.add.at(mat, (rows, hi), frac)
    return mat.astype(np.float32)


def _pil_filter(name: str):
    name = name.lower()
    if name == "bilinear":
        def triangle(x):
            x = np.abs(x)
            return np.where(x < 1.0, 1.0 - x, 0.0)

        return triangle, 1.0
    if name == "bicubic":
        a = -0.5  # Keys cubic, Pillow's default

        def cubic(x):
            x = np.abs(x)
            return np.where(
                x < 1.0,
                ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
            )

        return cubic, 2.0
    if name == "box":
        def box(x):
            return np.where((x > -0.5) & (x <= 0.5), 1.0, 0.0)

        return box, 0.5
    raise ValueError(f"Unsupported PIL filter '{name}'")


@functools.lru_cache(maxsize=None)
def pil_resize_matrix(in_size: int, out_size: int,
                      filter: str = "bilinear") -> np.ndarray:
    """Dense (out_size, in_size) matrix reproducing PIL's 1-D resampler.

    PIL widens the filter support by the scale factor when downsampling
    (antialiasing) and normalizes weights per output pixel.
    """
    fn, support = _pil_filter(filter)
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        j = np.arange(lo, hi)
        w = fn((j + 0.5 - center) / filterscale)
        total = w.sum()
        if total != 0:
            w = w / total
        mat[i, lo:hi] = w
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def pil_nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Source index per output pixel for PIL NEAREST resampling."""
    scale = in_size / out_size
    idx = ((np.arange(out_size) + 0.5) * scale).astype(np.int64)
    return np.minimum(idx, in_size - 1)


@functools.lru_cache(maxsize=64)
def device_constant(make, *args, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``make(*args)`` as a tensor on ``device``, built and copied once.

    A host-to-device copy of a pageable array inside the serving loop can
    stall the host on the stream, so each constant is kept on the device.
    It is made outside inference mode even when first asked for inside it,
    so that a later forward with autograd may still use it.
    """
    with torch.inference_mode(False):
        return torch.as_tensor(make(*args), dtype=dtype, device=device)


def _apply_separable(x: torch.Tensor, h_mat, w_mat) -> torch.Tensor:
    """Apply 1-D resampling matrices along H and W of an NHWC tensor."""
    x = torch.einsum("Hh,nhwc->nHwc", h_mat, x)
    return torch.einsum("Ww,nhwc->nhWc", w_mat, x).contiguous()


def resize_bilinear_align_corners(x: torch.Tensor,
                                  size: tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize matching torch ``align_corners=True``."""
    h_out, w_out = int(size[0]), int(size[1])
    _, h_in, w_in, _ = x.shape
    if (h_in, w_in) == (h_out, w_out):
        return x
    kw = dict(dtype=x.dtype, device=x.device)
    return _apply_separable(
        x,
        device_constant(bilinear_align_corners_matrix, h_in, h_out, **kw),
        device_constant(bilinear_align_corners_matrix, w_in, w_out, **kw),
    )


def upsample_align_corners(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Upsample NHWC by an integer factor with align_corners=True semantics."""
    _, h, w, _ = x.shape
    return resize_bilinear_align_corners(x, (h * factor, w * factor))


@functools.lru_cache(maxsize=None)
def nearest_torch_indices(in_size: int, out_size: int) -> np.ndarray:
    """Source index per output pixel of ``F.interpolate(mode='nearest')``:
    ``floor(i · in / out)``, in float64 as the JAX package computes it."""
    idx = (np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def resize_nearest_torch(x: torch.Tensor,
                         size: tuple[int, int]) -> torch.Tensor:
    """NHWC nearest resize matching torch ``interpolate(mode='nearest')``."""
    h_out, w_out = int(size[0]), int(size[1])
    _, h_in, w_in, _ = x.shape
    if (h_in, w_in) == (h_out, w_out):
        return x
    kw = dict(dtype=torch.int64, device=x.device)
    rows = device_constant(nearest_torch_indices, h_in, h_out, **kw)
    cols = device_constant(nearest_torch_indices, w_in, w_out, **kw)
    return x[:, rows][:, :, cols]


def pil_resize(x: torch.Tensor, size: tuple[int, int],
               filter: str = "bilinear",
               quantize_uint8: bool = False) -> torch.Tensor:
    """NHWC resize matching ``PIL.Image.resize`` (float path).

    ``quantize_uint8`` rounds half to even and clips to [0, 255] after
    resampling, matching the uint8 storage PIL applies between stages.
    """
    h_out, w_out = int(size[0]), int(size[1])
    _, h_in, w_in, _ = x.shape
    if (h_in, w_in) != (h_out, w_out):
        if filter.lower() == "nearest":
            kw = dict(dtype=torch.int64, device=x.device)
            rows = device_constant(pil_nearest_indices, h_in, h_out, **kw)
            cols = device_constant(pil_nearest_indices, w_in, w_out, **kw)
            x = x[:, rows][:, :, cols]
        else:
            kw = dict(dtype=x.dtype, device=x.device)
            x = _apply_separable(
                x,
                device_constant(pil_resize_matrix, h_in, h_out, filter, **kw),
                device_constant(pil_resize_matrix, w_in, w_out, filter, **kw),
            )
    if quantize_uint8:
        x = torch.clamp(torch.round(x), 0.0, 255.0)
    return x
