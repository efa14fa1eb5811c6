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
    """Eval-mode BatchNorm2d on NHWC input, computed in f32.

    Only running statistics are used: training-mode batch statistics belong
    to the training slice of the port (ROADMAP A10).
    """

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """f32 ``(scale, shift)`` of ``ops.norm.fold_bn``."""
        return fold_bn(self.weight, self.bias, self.running_mean,
                       self.running_var, self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "training-mode BatchNorm is not ported yet (ROADMAP A10); "
                "call .eval()")
        return batch_norm(x, *self.folded())
