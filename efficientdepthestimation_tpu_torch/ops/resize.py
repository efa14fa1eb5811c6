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
from torch._guards import detect_fake_mode

from efficientdepthestimation_tpu_torch.parallel import spatial

__all__ = [
    "bilinear_align_corners_matrix",
    "resize_bilinear_align_corners",
    "resize_whole",
    "band_matrix",
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


def device_constant(make, *args, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``make(*args)`` as a tensor on ``device``, built and copied once.

    A host-to-device copy of a pageable array inside the serving loop can
    stall the host on the stream, so each constant is kept on the device.
    It is made outside inference mode even when first asked for inside it,
    so that a later forward with autograd may still use it. Within a
    fake-tensor trace (``torch.export``, ``torch.library.opcheck``) it is
    made anew, a constant of the traced graph, and kept out of the cache;
    symbolic sizes are taken at their traced values.
    """
    args = tuple(int(a) if isinstance(a, torch.SymInt) else a for a in args)
    if detect_fake_mode() is not None:
        return torch.as_tensor(make(*args), dtype=dtype, device=device)
    return _cached_constant(make, *args, dtype=dtype, device=device)


@functools.lru_cache(maxsize=64)
def _cached_constant(make, *args, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.as_tensor(make(*args), dtype=dtype, device=device)


def _apply_separable(x: torch.Tensor, h_mat, w_mat) -> torch.Tensor:
    """Apply 1-D resampling matrices along H and W of an NHWC tensor."""
    x = torch.einsum("Hh,nhwc->nHwc", h_mat, x)
    return torch.einsum("Ww,nhwc->nhWc", w_mat, x).contiguous()


def resize_bilinear_align_corners(x: torch.Tensor,
                                  size: tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize matching torch ``align_corners=True``.

    Of a band of rows (``parallel.spatial.row_sharded``): this rank's rows
    of the output, its rows of the global matrix applied to the source rows
    they read, fetched from their owners."""
    ctx = spatial.active()
    if ctx is not None:
        return _resize_band(ctx, x, size)
    return resize_whole(x, size)


def resize_whole(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``resize_bilinear_align_corners`` of ``x`` as a whole tensor, under
    any context: for an op that was handed its rows."""
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


def band_matrix(in_size: int, out_size: int, start: int, stop: int,
                lo: int, hi: int) -> np.ndarray:
    """Rows ``[start, stop)`` and source columns ``[lo, hi)`` of
    ``bilinear_align_corners_matrix(in_size, out_size)``."""
    return bilinear_align_corners_matrix(in_size, out_size)[start:stop,
                                                            lo:hi]


def _resize_band(ctx, x: torch.Tensor, size) -> torch.Tensor:
    h_out, w_out = int(size[0]), int(size[1])
    h_in, w_in = ctx.height(x), x.shape[2]
    if (h_in, w_in) == (h_out, w_out):
        return x
    rows = ctx.fetch(x, h_in, h_out, lambda a, b: spatial.resize_rows(
        a, b, h_in, h_out))
    start, stop = ctx.rows(h_out)
    lo, hi = spatial.resize_rows(start, stop, h_in, h_out)
    kw = dict(dtype=x.dtype, device=x.device)
    ctx.note(h_out, w_out)
    return _apply_separable(
        rows,
        device_constant(band_matrix, h_in, h_out, start, stop, lo, hi, **kw),
        device_constant(bilinear_align_corners_matrix, w_in, w_out, **kw),
    )


def upsample_align_corners(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Upsample NHWC by an integer factor with align_corners=True semantics."""
    h, w = spatial.global_hw(x)
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


@functools.lru_cache(maxsize=None)
def pil_resize_taps(in_size: int, out_size: int,
                    filter: str = "bilinear") -> tuple[np.ndarray, np.ndarray]:
    """The band of ``pil_resize_matrix``: per output index its first source
    index ``lo`` (out_size,) and the weights of sources ``lo + t``
    (out_size, taps), zero past the band; ``lo + t`` stays in range."""
    mat = pil_resize_matrix(in_size, out_size, filter)
    nz = mat != 0
    lo = np.where(nz.any(1), nz.argmax(1), 0)
    hi = np.where(nz.any(1), in_size - nz[:, ::-1].argmax(1), 1)
    taps = int((hi - lo).max())
    lo = np.minimum(lo, in_size - taps)
    weights = np.stack([mat[np.arange(out_size), lo + t] for t in range(taps)],
                       axis=1)
    return lo.astype(np.int64), weights


def _pil_tap_starts(in_size: int, out_size: int, filter: str) -> np.ndarray:
    return pil_resize_taps(in_size, out_size, filter)[0]


def _pil_tap_weights(in_size: int, out_size: int, filter: str) -> np.ndarray:
    return pil_resize_taps(in_size, out_size, filter)[1]


#: The JAX and jaxlib versions whose XLA CPU dot ``xla_cpu_fuses_sum`` was
#: read off. The rule is that backend's GEMM blocking, not a property of
#: the resize: another XLA version may block otherwise, and then the
#: port's uint8 levels part from JAX's at ties again (the C8 test fails).
XLA_CPU_RULE_FITTED_ON = "jax 0.9.0, jaxlib 0.9.0"


def xla_cpu_fuses_sum(out_size: int) -> bool:
    """Whether the JAX package's f32 resize on the CPU adds each tap to its
    partial sum with one rounding (a fused multiply-add) rather than two.

    XLA's CPU dot of (M, K) by the (K, out) matrix rounds each product and
    each sum, except when ``(out - 1) % 64 >= 48``, where it fuses them
    (measured at M ≥ 72 rows, which every pass of an image at least 24
    pixels across has). Summed in ascending tap order either way. The rule
    was read off one XLA version (``XLA_CPU_RULE_FITTED_ON``) and is tied
    to it.
    """
    return (out_size - 1) % 64 >= 48


def _pil_pass(x: torch.Tensor, in_size: int, out_size: int, axis: int,
              filter: str) -> torch.Tensor:
    """One pass of ``pil_resize`` along ``axis`` (1 or 2).

    A pass that upsamples reads two source pixels an output, and is rounded
    as the JAX package rounds it on the CPU: the two taps added in
    ascending order, fused or not as ``xla_cpu_fuses_sum`` says, in
    elementwise IEEE operations, so that the CPU and the card give the same
    bits (a fused step in f64, where an f32 product is exact, rounded once
    to f32). A pass that reads more (a downsample) is a matrix product, as
    the pass was before: XLA sums its taps in blocks this does not mirror.
    """
    lo, weights = pil_resize_taps(in_size, out_size, filter)
    if weights.shape[1] > 2:
        mat = device_constant(pil_resize_matrix, in_size, out_size, filter,
                              dtype=x.dtype, device=x.device)
        eq = "Hh,nhwc->nHwc" if axis == 1 else "Ww,nhwc->nhWc"
        return torch.einsum(eq, mat, x)
    fused = xla_cpu_fuses_sum(out_size)
    shape = [1] * x.dim()
    shape[axis] = out_size
    idx = device_constant(_pil_tap_starts, in_size, out_size, filter,
                          dtype=torch.int64, device=x.device)
    w = device_constant(_pil_tap_weights, in_size, out_size, filter,
                        dtype=torch.float64 if fused else x.dtype,
                        device=x.device)
    acc = None
    for t in range(weights.shape[1]):
        src = x.index_select(axis, idx + t)
        wt = w[:, t].reshape(shape)
        if fused:
            term = wt * src.double()
            acc = term if acc is None else acc.double() + term
            acc = acc.to(x.dtype)
        else:
            term = wt * src
            acc = term if acc is None else acc + term
    return acc


def pil_resize(x: torch.Tensor, size: tuple[int, int],
               filter: str = "bilinear",
               quantize_uint8: bool = False) -> torch.Tensor:
    """NHWC resize matching ``PIL.Image.resize`` (float path).

    ``quantize_uint8`` rounds half to even and clips to [0, 255] after
    resampling, matching the uint8 storage PIL applies between stages. A
    value that lies on a rounding tie within f32 error rounds to the side
    that the JAX package's summation order gives it, so a pass that
    upsamples is then summed tap by tap as that package sums it on the CPU
    (``_pil_pass``), not by a matrix product whose order is the library's.
    """
    h_out, w_out = int(size[0]), int(size[1])
    _, h_in, w_in, _ = x.shape
    if (h_in, w_in) != (h_out, w_out):
        if filter.lower() == "nearest":
            kw = dict(dtype=torch.int64, device=x.device)
            rows = device_constant(pil_nearest_indices, h_in, h_out, **kw)
            cols = device_constant(pil_nearest_indices, w_in, w_out, **kw)
            x = x[:, rows][:, :, cols]
        elif quantize_uint8 and x.dtype == torch.float32:
            if h_in != h_out:
                x = _pil_pass(x, h_in, h_out, 1, filter)
            if w_in != w_out:
                x = _pil_pass(x, w_in, w_out, 2, filter)
            x = x.contiguous()
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
