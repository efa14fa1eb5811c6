"""Exact algebraic rewrite of conv5×5 ∘ align-corners upsample, and the
choice of route at each Hu2018 decoder site.

The Hu2018 decoder computes ``conv5×5(bilinear_upsample(x))``. Both the
resize and the channel contraction are linear, so they commute: all 25 taps
are contracted at the small resolution first, then resized with row/column
shifted interpolation matrices whose zero rows are the conv's zero padding.
The rewrite copies ``efficientdepthestimation_tpu/ops/fused.py``: three
``torch.einsum`` matrix products.

``should_fuse`` picks, per site, between that einsum route and the
hand-written ``ops.kernels.upproj.upsample_conv`` kernel (the direct form).
Both compute the same function; only the order of accumulation differs.
Unlike the JAX package's ``should_fuse``, a roofline with a TPU's rates, it
applies a rule fitted to the two routes' times on the H100.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.ops.resize import (
    bilinear_align_corners_matrix,
    device_constant,
)
from efficientdepthestimation_tpu_torch.parallel import spatial

__all__ = ["should_fuse", "upsample_conv_pair", "upsample_conv_stacked"]

# The route at each Hu2018 decoder site, fitted to the faster of the two
# at the 40 decoder sites of ENB0-HU, ENB4-HU, RN50-HU, DN161-HU and
# SN154-HU at 228×304, timed by chip_smoke.py (``route_times``: both routes
# on the same inputs by CUDA-graph replay, bf16 at batch 128; ENB0-HU's
# sites also f32 at batch 8) on an NVIDIA H100 80GB HBM3 at a 700 W power
# limit, in two runs that agreed on every site they share (the per-site
# times are in PERF.md). The einsum route takes a site where the input
# channels times the linear upsample factor exceed this, per dtype: the
# kernel's work grows with cin × the output's pixels, the rewrite's mostly
# with the output's pixels. In bf16 the kernel won up to 256 (RN50-HU's
# D.up4) and lost from 276 (DN161-HU's D.up4); in f32, whose kernel runs
# on the CUDA cores, it won up to 48 and lost from 80. Each threshold lies
# between the two, so every measured site takes its measured route.
_EINSUM_ABOVE = {"bfloat16": 264, "float32": 64}


def should_fuse(in_hw: tuple[int, int], out_hw: tuple[int, int],
                cin: int, cout: int, dtype: torch.dtype) -> bool:
    """True where the einsum rewrite takes the site (``cin`` channels in,
    ``cout`` a branch, activations f32 or bf16), False where the kernel
    does: ``_EINSUM_ABOVE``'s rule, fitted to H100 timings. ``cout`` does
    not enter it; it stays for the JAX function's signature."""
    factor = (out_hw[0] * out_hw[1] / (in_hw[0] * in_hw[1])) ** 0.5
    return cin * factor > _EINSUM_ABOVE[str(dtype).removeprefix("torch.")]


@functools.lru_cache(maxsize=None)
def _shifted_matrices(in_size: int, out_size: int, taps: int = 5) -> np.ndarray:
    """(taps, out_size, in_size): row p of slice d is the interpolation row
    for upsampled position p + d - taps//2, zero outside (conv zero padding)."""
    base = bilinear_align_corners_matrix(in_size, out_size)
    radius = taps // 2
    shifted = np.zeros((taps, out_size, in_size), np.float32)
    for d in range(taps):
        lo = max(0, radius - d)
        hi = min(out_size, out_size + radius - d)
        shifted[d, lo:hi] = base[lo + d - radius: hi + d - radius]
    return shifted


def _band_shifted(in_size: int, out_size: int, taps: int, start: int,
                  stop: int, lo: int, hi: int) -> np.ndarray:
    """Output rows ``[start, stop)`` and source rows ``[lo, hi)`` of
    ``_shifted_matrices``."""
    return _shifted_matrices(in_size, out_size, taps)[:, start:stop, lo:hi]


def upsample_conv_stacked(x: torch.Tensor, kernels: torch.Tensor,
                          size: tuple[int, int]) -> torch.Tensor:
    """``conv2d(resize_bilinear_align_corners(x, size), kernels, pad=taps//2)``
    for NHWC ``x`` and HWIO ``kernels`` (taps, taps, ci, co); (n, H, W, co).
    Of a band of rows (``parallel.spatial.row_sharded``), this rank's rows
    of it: the row matrices' rows of the block, applied to the source rows
    they read, fetched from their owners."""
    taps = kernels.shape[0]
    _, hs, ws, _ = x.shape
    h_out, w_out = int(size[0]), int(size[1])
    kw = dict(dtype=x.dtype, device=x.device)
    ctx = spatial.active()
    if ctx is None:
        a = device_constant(_shifted_matrices, hs, h_out, taps, **kw)
    else:
        hs = ctx.height(x)

        def reads(start, stop):
            return spatial.upsample_conv_rows(start, stop, hs, h_out, taps)

        x = ctx.fetch(x, hs, h_out, reads)
        start, stop = ctx.rows(h_out)
        a = device_constant(_band_shifted, hs, h_out, taps, start, stop,
                            *reads(start, stop), **kw)
        ctx.note(h_out, w_out)
    b = device_constant(_shifted_matrices, ws, w_out, taps, **kw)
    z = torch.einsum("nhwc,pqco->nhwpqo", x, kernels.to(x.dtype))
    v = torch.einsum("qWw,nhwpqo->nhWpo", b, z)
    return torch.einsum("pHh,nhWpo->nHWo", a, v).contiguous()


def upsample_conv_pair(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
                       size: tuple[int, int]
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both UpProjection branches (HWIO ``k1``, ``k2``) in one pass over the
    stacked kernels."""
    co = k1.shape[-1]
    y = upsample_conv_stacked(x, torch.cat([k1, k2], dim=-1), size)
    return y[..., :co], y[..., co:]
