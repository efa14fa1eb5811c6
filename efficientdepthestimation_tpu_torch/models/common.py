"""Shared modules on NHWC tensors, with PyTorch parameter names.

Counterpart of ``efficientdepthestimation_tpu/models/common.py``. Submodules
carry the JAX package's module names, so a JAX parameter path joined with
'.' is the key here once its leaf is renamed (``checkpoints.convert``).
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from efficientdepthestimation_tpu_torch.ops.conv import conv2d
from efficientdepthestimation_tpu_torch.ops.norm import batch_norm, fold_bn

__all__ = ["Conv", "BatchNorm", "frozen_statistics", "randomize_"]


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
    f32. ``track_statistics = False`` (``frozen_statistics``) keeps the
    running statistics as they are in training.
    """

    track_statistics = True

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
        if self.track_statistics:
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (n / max(n - 1, 1))
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (xf * inv + (self.bias - mean * inv)).to(x.dtype)


@contextlib.contextmanager
def frozen_statistics(model: nn.Module):
    """Within the block, every ``BatchNorm`` of ``model`` in training mode
    normalizes by its batch but leaves its running statistics as they are:
    for a forward that must not move them, such as the recompute of a
    checkpointed forward or a gradient probe."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    saved = [m.track_statistics for m in norms]
    for m in norms:
        m.track_statistics = False
    try:
        yield
    finally:
        for m, flag in zip(norms, saved):
            m.track_statistics = flag


def randomize_(model: nn.Module, seed: int) -> nn.Module:
    """Redraw every weight and BatchNorm statistic of a model on the CPU, in
    place, from ``torch.Generator().manual_seed(seed)`` in module order: a
    model without a checkpoint, the same on every machine.

    Conv weights are LeCun-uniform, U(±√(3 / fan_in)), which keeps the
    outputs of the released configurations O(0.1-10) at 228×304 (He's
    √(6 / fan_in) grows them by orders of magnitude, and the EfficientNet
    models' bf16 forwards then part from their f32 ones); conv biases
    U(±1/√fan_in); BatchNorm weights 1 ± 0.2, biases and running means
    ± 0.2 and running variances 0.5-1.5, so that every eval fold is
    non-trivial.
    """
    gen = torch.Generator().manual_seed(seed)

    def uniform_(t: torch.Tensor, lo: float, hi: float) -> None:
        t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                fan_in = m.weight[0].numel()
                bound = math.sqrt(3.0 / fan_in)
                uniform_(m.weight, -bound, bound)
                if m.bias is not None:
                    bound = 1.0 / math.sqrt(fan_in)
                    uniform_(m.bias, -bound, bound)
            elif isinstance(m, BatchNorm):
                uniform_(m.weight, 0.8, 1.2)
                uniform_(m.bias, -0.2, 0.2)
                uniform_(m.running_mean, -0.2, 0.2)
                uniform_(m.running_var, 0.5, 1.5)
    return model
