"""Shared modules on NHWC tensors, with PyTorch parameter names.

Counterpart of ``efficientdepthestimation_tpu/models/common.py``. Submodules
carry the JAX package's module names, so a JAX parameter path joined with
'.' is the key here once its leaf is renamed (``checkpoints.convert``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from efficientdepthestimation_tpu_torch.ops.conv import conv2d
from efficientdepthestimation_tpu_torch.ops.norm import batch_norm, fold_bn

__all__ = ["Conv", "BatchNorm"]


class Conv(nn.Module):
    """2-D convolution of NHWC input with an OIHW ``weight``."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding=0, groups: int = 1, bias: bool = False):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(
            torch.empty(cout, cin // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        # PyTorch's own conv initialisation
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        if self.bias is not None:
            bound = 1.0 / math.sqrt(self.weight[0].numel())
            nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, stride=self.stride,
                      padding=self.padding, groups=self.groups,
                      bias=self.bias)


class BatchNorm(nn.Module):
    """BatchNorm2d on NHWC input with PyTorch's train/eval semantics, in f32.

    * eval: the running statistics, folded (``ops.norm.fold_bn``).
    * train: the batch's biased variance ``E[x²] − E[x]²`` in f32 normalizes;
      the running statistics move as ``(1 − momentum)·r + momentum·batch``,
      the variance's with the unbiased ``var·n/(n−1)`` (the JAX package's
      ``BatchNorm``, ``models/common.py:108-122``).

    The output is computed from ``x.float()`` and cast back to x's dtype;
    ``weight``/``bias`` may be bf16 (mixed precision), the statistics stay
    f32.
    """

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """f32 ``(scale, shift)`` of ``ops.norm.fold_bn``."""
        return fold_bn(self.weight, self.bias, self.running_mean,
                       self.running_var, self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return batch_norm(x, *self.folded())
        xf = x.float()
        mean = xf.mean(dim=(0, 1, 2))
        var = xf.square().mean(dim=(0, 1, 2)) - mean.square()
        n = x.shape[0] * x.shape[1] * x.shape[2]
        with torch.no_grad():
            m = self.momentum
            unbiased = var * (n / max(n - 1, 1))
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (xf * inv + (self.bias - mean * inv)).to(x.dtype)
