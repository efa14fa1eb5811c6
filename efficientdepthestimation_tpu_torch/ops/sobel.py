"""Sobel gradient operator (fixed-weight 3×3 stencil), NHWC.

Counterpart of ``efficientdepthestimation_tpu/ops/sobel.py`` (reference
ReSIDE/sobel.py:5-23): a constant-kernel conv producing (Gx, Gy) with zero
padding 1. The training loss's kernel pair (``ops/kernels/fused_loss.py``)
computes the same stencil inside its kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.ops.conv import conv2d
from efficientdepthestimation_tpu_torch.ops.resize import device_constant

__all__ = ["SOBEL_KX", "SOBEL_KY", "sobel_gradients"]

SOBEL_KX = np.array([[1.0, 0.0, -1.0], [2.0, 0.0, -2.0], [1.0, 0.0, -1.0]],
                    np.float32)
SOBEL_KY = np.array([[1.0, 2.0, 1.0], [0.0, 0.0, 0.0], [-1.0, -2.0, -1.0]],
                    np.float32)


def _sobel_oihw() -> np.ndarray:
    """OIHW kernel: 2 output channels (Gx, Gy), 1 input channel, 3×3."""
    return np.stack([SOBEL_KX, SOBEL_KY])[:, None]


def sobel_gradients(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (gx, gy), each (N, H, W, 1), for a single-channel NHWC input."""
    k = device_constant(_sobel_oihw, dtype=x.dtype, device=x.device)
    out = conv2d(x, k, padding=1)
    return out[..., 0:1], out[..., 1:2]
