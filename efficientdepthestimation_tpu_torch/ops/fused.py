"""Exact algebraic rewrite of conv5×5 ∘ align-corners upsample.

The Hu2018 decoder computes ``conv5×5(bilinear_upsample(x))``. Both the
resize and the channel contraction are linear, so they commute: all 25 taps
are contracted at the small resolution first, then resized with row/column
shifted interpolation matrices whose zero rows are the conv's zero padding.
This module copies ``efficientdepthestimation_tpu/ops/fused.py``:
``should_fuse`` keeps the same constants, so the same sites take the same
path; the rewrite itself is three ``torch.einsum`` matrix products.

The direct form (``should_fuse`` false) runs through the hand-written
``ops.kernels.upproj.upsample_conv`` kernel instead.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.ops.resize import (
    bilinear_align_corners_matrix,
    device_constant,
)

__all__ = ["should_fuse", "fuse_costs", "upsample_conv_pair"]

# Roofline rates of the JAX package's cost model (a TPU v5e chip, derated).
# Only their ratio matters for the choice; they were not measured on the
# H100 (ROADMAP: re-derive them there).
_FLOPS_PER_S = 1.0e14
_BYTES_PER_S = 5.5e11
_BPE = 2  # bf16 activations on the serving path


def _roofline(flops: float, bytes_: float) -> float:
    return max(flops / _FLOPS_PER_S, bytes_ / _BYTES_PER_S)


def fuse_costs(in_hw: tuple[int, int], out_hw: tuple[int, int],
               cin: int, cout: int, taps: int = 5) -> tuple[float, float]:
    """(direct, fused) estimated seconds per frame per branch."""
    t2 = taps * taps
    in_px = in_hw[0] * in_hw[1]
    out_px = out_hw[0] * out_hw[1]

    d_flops = 2 * out_px * t2 * cin * cout + 2 * out_px * cin * (in_hw[0] + taps)
    d_bytes = _BPE * (in_px * cin + 2 * 2 * out_px * cin + out_px * cout)
    direct = _roofline(d_flops, d_bytes)

    f_flops = (
        2 * in_px * t2 * cin * cout
        + 2 * in_hw[0] * out_hw[1] * taps * cout * taps * in_hw[1]
        + 2 * out_px * cout * taps * in_hw[0]
    )
    f_bytes = _BPE * (
        in_px * cin + 2 * in_px * t2 * cout
        + 2 * in_hw[0] * out_hw[1] * taps * cout
        + out_px * cout
    )
    fused = _roofline(f_flops, f_bytes)
    return direct, fused


def should_fuse(in_hw: tuple[int, int], out_hw: tuple[int, int],
                cin: int, cout: int, taps: int = 5) -> bool:
    """True where the rewrite is cheaper under the roofline model."""
    direct, fused = fuse_costs(in_hw, out_hw, cin, cout, taps)
    return fused < direct


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


def _upsample_conv_multi(x: torch.Tensor, kernels: torch.Tensor,
                         size: tuple[int, int]) -> torch.Tensor:
    """``conv2d(resize_bilinear_align_corners(x, size), kernels, pad=taps//2)``
    for NHWC ``x`` and HWIO ``kernels`` (taps, taps, ci, co); (n, H, W, co)."""
    taps = kernels.shape[0]
    _, hs, ws, _ = x.shape
    h_out, w_out = int(size[0]), int(size[1])
    kw = dict(dtype=x.dtype, device=x.device)
    a = device_constant(_shifted_matrices, hs, h_out, taps, **kw)
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
    y = _upsample_conv_multi(x, torch.cat([k1, k2], dim=-1), size)
    return y[..., :co], y[..., co:]
