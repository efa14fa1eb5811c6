"""Eval-mode batch normalization with PyTorch numerics, in f32.

EfficientNet's BatchNorms use eps 1e-3; the Hu2018 decoder's use PyTorch's
default 1e-5. The caller passes the eps.
"""

from __future__ import annotations

import torch

__all__ = ["fold_bn", "batch_norm"]


def fold_bn(weight: torch.Tensor, bias: torch.Tensor,
            running_mean: torch.Tensor, running_var: torch.Tensor,
            eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as f32 ``(scale, shift)``: ``y = x * scale + shift``."""
    scale = torch.rsqrt(running_var.float() + eps) * weight.float()
    return scale, bias.float() - running_mean.float() * scale


def batch_norm(x: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor) -> torch.Tensor:
    """Apply a folded BatchNorm to NHWC ``x`` in f32; the result has x's
    dtype, as the JAX package's ``BatchNorm`` casts back."""
    return (x * scale + shift).to(x.dtype)
