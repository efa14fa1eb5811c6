"""Shared modules on NHWC tensors, with PyTorch parameter names.

Counterpart of ``efficientdepthestimation_tpu/models/common.py``. Submodules
carry the JAX package's module names, so a JAX parameter path joined with
'.' is the key here once its leaf is renamed (``checkpoints.convert``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch import nn

from efficientdepthestimation_tpu_torch.ops.conv import conv2d
from efficientdepthestimation_tpu_torch.ops.norm import batch_norm, fold_bn
from efficientdepthestimation_tpu_torch.parallel.mesh import (
    differentiable_all_reduce,
)

__all__ = ["Conv", "BatchNorm", "frozen_statistics", "randomize_",
           "BatchShare", "batch_share", "per_sample_uniform"]


@dataclasses.dataclass(frozen=True)
class BatchShare:
    """This process's share of a data-parallel training batch: its local
    rows are global rows ``[start, start + n)`` of a batch of ``total``
    rows, and ``group`` (a ``torch.distributed`` process group) joins the
    ranks whose shares make up that batch."""

    group: object
    start: int
    total: int


_SHARE: BatchShare | None = None


@contextlib.contextmanager
def batch_share(share: BatchShare | None):
    """Within the block, training forwards see ``share``: every training
    ``BatchNorm`` normalizes by the statistics of the global batch
    (all-reduced over ``share.group``, as GSPMD makes them in JAX), and
    ``per_sample_uniform`` draws for the global batch and keeps the local
    rows. ``None`` (a world of one) changes nothing."""
    global _SHARE
    saved, _SHARE = _SHARE, share
    try:
        yield
    finally:
        _SHARE = saved


def per_sample_uniform(n: int, generator: torch.Generator,
                       device) -> torch.Tensor:
    """U[0, 1) draws (n, 1, 1, 1), one a sample of the local batch: under a
    ``batch_share`` those of the global batch's draw at this rank's rows, so
    that W ranks draw what one process draws for the whole batch."""
    if _SHARE is None:
        return torch.rand((n, 1, 1, 1), generator=generator, device=device)
    u = torch.rand((_SHARE.total, 1, 1, 1), generator=generator,
                   device=device)
    return u[_SHARE.start:_SHARE.start + n]


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

    Under a ``batch_share`` the training statistics are the global batch's:
    the per-channel Σx, Σx² and the element count are all-reduced over the
    share's group in one differentiable collective
    (``parallel.mesh.differentiable_all_reduce``, whose backward sums the
    gradients of every rank) before the normalization, and the global
    count enters the unbiased running variance. Every rank issues the same
    collectives, also with ``frozen_statistics`` and in a recompute.
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
        n = x.shape[0] * x.shape[1] * x.shape[2]
        if _SHARE is None:
            mean = xf.mean(dim=(0, 1, 2))
            var = xf.square().mean(dim=(0, 1, 2)) - mean.square()
        else:
            c = xf.shape[-1]
            local = torch.cat([xf.sum(dim=(0, 1, 2)),
                               xf.square().sum(dim=(0, 1, 2)),
                               xf.new_full((1,), float(n))])
            total = differentiable_all_reduce(local, _SHARE.group)
            n = total[2 * c]  # a tensor: no host read mid-forward
            mean = total[:c] / n
            var = total[c:2 * c] / n - mean.square()
        if self.track_statistics:
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (n / (max(n - 1, 1) if _SHARE is None
                                       else (n - 1).clamp(min=1)))
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
