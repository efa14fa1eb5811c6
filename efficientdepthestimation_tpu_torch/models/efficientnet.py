"""EfficientNet feature encoder (eval), on NHWC tensors.

Counterpart of ``efficientdepthestimation_tpu/models/efficientnet.py``: the
efficientnet-pytorch 0.6.3 behaviour (MBConv blocks, swish, BatchNorm eps
1e-3, static same padding from the variant's canonical resolution) with the
reference's four encoder taps. Each block's depthwise conv, BatchNorm, swish
and squeeze-excite mean run as one ``depthwise_bn_swish`` kernel launch, as
``efficientnet_apply_fused`` does in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from efficientdepthestimation_tpu_torch.models.common import BatchNorm, Conv
from efficientdepthestimation_tpu_torch.ops.conv import same_padding_static
from efficientdepthestimation_tpu_torch.ops.kernels.depthwise import (
    depthwise_bn_swish,
)

__all__ = ["EfficientNetFeatures", "MBConvBlock", "EFFICIENTNET_PARAMS",
           "efficientnet_block_channels", "efficientnet_stage_splits"]

# (width_mult, depth_mult, canonical resolution, dropout)
EFFICIENTNET_PARAMS = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
}

# Base (B0) stages: (repeats, kernel, stride, expand, cin, cout, se)
_BASE_STAGES = (
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
)

# 4-way encoder split boundaries (reference ReSIDE/models/modules.py:168-183;
# the final bound is the block count).
_SPLIT_INDICES = {
    "efficientnet-b0": (0, 3, 5, 8),
    "efficientnet-b1": (0, 5, 8, 16),
    "efficientnet-b2": (0, 5, 8, 16),
    "efficientnet-b3": (0, 5, 8, 18),
    "efficientnet-b4": (0, 6, 10, 22),
    "efficientnet-b5": (0, 8, 13, 27),
    "efficientnet-b6": (0, 9, 15, 31),
    "efficientnet-b7": (0, 11, 18, 38),
}


def round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def _block_plan(variant: str):
    """Per-block args. efficientnet-pytorch 0.6.3 pads every conv from the
    global canonical image size, so each block gets ``(res, res)``."""
    width, depth, res, _ = EFFICIENTNET_PARAMS[variant]
    plan = []
    stem_out = round_filters(32, width)
    for repeats, k, s, expand, cin, cout, se in _BASE_STAGES:
        cin_r = round_filters(cin, width)
        cout_r = round_filters(cout, width)
        for i in range(round_repeats(repeats, depth)):
            plan.append(dict(kernel=k, stride=s if i == 0 else 1,
                             expand=expand, cin=cin_r if i == 0 else cout_r,
                             cout=cout_r, se=se, image_size=(res, res)))
    return stem_out, plan


def efficientnet_block_channels(variant: str) -> list[int]:
    """Output channels at the 4 encoder taps (last block's cout per split)."""
    return [_block_plan(variant)[1][b - 1]["cout"]
            for b in efficientnet_stage_splits(variant)[1:]]


def efficientnet_stage_splits(variant: str) -> list[int]:
    _, plan = _block_plan(variant)
    return list(_SPLIT_INDICES[variant]) + [len(plan)]


class MBConvBlock(nn.Module):
    """Expand 1×1 → fused depthwise/BN/swish → squeeze-excite → project 1×1."""

    def __init__(self, kernel: int, stride: int, expand: int, cin: int,
                 cout: int, se: float, image_size: tuple[int, int]):
        super().__init__()
        mid = cin * expand
        self.expand, self.stride, self.residual = expand, stride, (
            stride == 1 and cin == cout)
        self.pad = same_padding_static(image_size, (kernel, kernel),
                                       (stride, stride))
        if expand != 1:
            self._expand_conv = Conv(cin, mid, 1)
            self._bn0 = BatchNorm(mid, eps=1e-3)
        self._depthwise_conv = Conv(mid, mid, kernel, stride, self.pad,
                                    groups=mid)
        self._bn1 = BatchNorm(mid, eps=1e-3)
        self.has_se = se > 0
        if self.has_se:
            n_sq = max(1, int(cin * se))
            self._se_reduce = Conv(mid, n_sq, 1, bias=True)
            self._se_expand = Conv(n_sq, mid, 1, bias=True)
        self._project_conv = Conv(mid, cout, 1)
        self._bn2 = BatchNorm(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "training-mode MBConv is not ported yet (ROADMAP A10)")
        inputs = x
        if self.expand != 1:
            x = F.silu(self._bn0(self._expand_conv(x)))
        # (C, 1, k, k) -> (k, k, C)
        taps = self._depthwise_conv.weight[:, 0].permute(1, 2, 0)
        scale, shift = self._bn1.folded()
        x, sums = depthwise_bn_swish(x, taps.to(x.dtype).contiguous(), scale,
                                     shift, stride=self.stride,
                                     padding=self.pad)
        if self.has_se:
            mean = (sums / (x.shape[1] * x.shape[2])).to(x.dtype)
            sq = F.silu(self._se_reduce(mean[:, None, None, :]))
            x = torch.sigmoid(self._se_expand(sq)) * x
        x = self._bn2(self._project_conv(x))
        if self.residual:
            x = x + inputs
        return x


class EfficientNetFeatures(nn.Module):
    """Stem + MBConv blocks, returning the reference's 4 encoder taps."""

    def __init__(self, variant: str = "efficientnet-b0"):
        super().__init__()
        res = EFFICIENTNET_PARAMS[variant][2]
        stem_out, plan = _block_plan(variant)
        self._conv_stem = Conv(3, stem_out, 3, 2,
                               same_padding_static((res, res), (3, 3), (2, 2)))
        self._bn0 = BatchNorm(stem_out, eps=1e-3)
        self._blocks = nn.ModuleList(MBConvBlock(**args) for args in plan)
        self.splits = set(efficientnet_stage_splits(variant)[1:])

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """NHWC images -> 4 NHWC taps."""
        x = F.silu(self._bn0(self._conv_stem(x)))
        taps = []
        for i, block in enumerate(self._blocks):
            x = block(x)
            if i + 1 in self.splits:
                taps.append(x)
        return tuple(taps)
