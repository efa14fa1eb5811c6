"""EfficientNet feature encoder, on NHWC tensors.

Counterpart of ``efficientdepthestimation_tpu/models/efficientnet.py``: the
efficientnet-pytorch 0.6.3 behaviour (MBConv blocks, swish, BatchNorm eps
1e-3 and momentum 0.01, static same padding from the variant's canonical
resolution, drop-connect) with the reference's four encoder taps. In eval
each block's depthwise conv, BatchNorm, swish and squeeze-excite mean run as
one ``depthwise_bn_swish`` kernel launch, as ``efficientnet_apply_fused``
does in the JAX package, unless ``ops.conv.depthwise_impl`` selects the
"xla" or "shift" form, which run the conv (cuDNN's grouped conv, or the
per-tap sum), the BN on running statistics and swish as ops of their own.
In training, where BatchNorm uses batch statistics and cannot be folded,
the depthwise conv is a plain grouped conv, as the JAX package's
``MBConvBlock`` trains through XLA's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from efficientdepthestimation_tpu_torch.models.common import (
    BatchNorm,
    Conv,
    per_sample_uniform,
)
from efficientdepthestimation_tpu_torch.ops.conv import (
    avg_pool_global,
    depthwise_mode,
    same_padding_static,
)
from efficientdepthestimation_tpu_torch.ops.kernels.depthwise import (
    depthwise_bn_swish,
)
from efficientdepthestimation_tpu_torch.parallel.spatial import global_hw

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
    """Expand 1×1 → depthwise/BN/swish → squeeze-excite → project 1×1, and
    the residual (with drop-connect in training) where stride 1 keeps C.
    Baked (``models.common.bake_``), the expand and project convs carry
    their BatchNorms, and the depthwise kernel's taps and ``_bn1``'s fold
    are computed once."""

    CONV_BN = (("_expand_conv", "_bn0"), ("_project_conv", "_bn2"))

    def __init__(self, kernel: int, stride: int, expand: int, cin: int,
                 cout: int, se: float, image_size: tuple[int, int]):
        super().__init__()
        mid = cin * expand
        self.expand, self.stride, self.residual = expand, stride, (
            stride == 1 and cin == cout)
        self.pad = same_padding_static(image_size, (kernel, kernel),
                                       (stride, stride))
        bn = dict(eps=1e-3, momentum=0.01)
        if expand != 1:
            self._expand_conv = Conv(cin, mid, 1)
            self._bn0 = BatchNorm(mid, **bn)
        self._depthwise_conv = Conv(mid, mid, kernel, stride, self.pad,
                                    groups=mid)
        self._bn1 = BatchNorm(mid, **bn)
        self.has_se = se > 0
        if self.has_se:
            n_sq = max(1, int(cin * se))
            self._se_reduce = Conv(mid, n_sq, 1, bias=True)
            self._se_expand = Conv(n_sq, mid, 1, bias=True)
        self._project_conv = Conv(mid, cout, 1)
        self._bn2 = BatchNorm(cout, **bn)
        self.register_buffer("baked_taps", None)

    def _taps(self, dtype: torch.dtype) -> torch.Tensor:
        """The depthwise weight as the kernel's (k, k, C) taps."""
        taps = self._depthwise_conv.weight[:, 0].permute(1, 2, 0)
        return taps.to(dtype).contiguous()

    def bake(self) -> None:
        self.baked_taps = self._taps(self._depthwise_conv.weight.dtype)

    def forward(self, x: torch.Tensor,
                drop_mask: torch.Tensor | None = None,
                keep: float = 1.0) -> torch.Tensor:
        """``drop_mask`` (N, 1, 1, 1) of 0/1 in x's dtype, training only:
        drop-connect ``x / keep * drop_mask`` on the residual branch."""
        if self.training or depthwise_mode() != "pallas":
            return self._forward_unfused(x, drop_mask, keep)
        inputs = x
        if self.expand != 1:
            x = F.silu(self._bn0(self._expand_conv(x)))
        taps = (self.baked_taps if self.baked_taps is not None
                else self._taps(x.dtype))
        scale, shift = self._bn1.folded()
        x, sums = depthwise_bn_swish(x, taps, scale, shift,
                                     stride=self.stride, padding=self.pad)
        if self.has_se:
            h, w = global_hw(x)  # a band's sums are the whole plane's
            mean = (sums / (h * w)).to(x.dtype)
            sq = F.silu(self._se_reduce(mean[:, None, None, :]))
            x = torch.sigmoid(self._se_expand(sq)) * x
        x = self._bn2(self._project_conv(x))
        if self.residual:
            x = x + inputs
        return x

    def _forward_unfused(self, x, drop_mask, keep):
        """``MBConvBlock.__call__`` of the JAX package
        (``models/efficientnet.py:146-180``): the depthwise conv as
        ``ops.conv.conv2d`` computes it, and the BNs on batch statistics in
        training, on running ones in eval."""
        inputs = x
        if self.expand != 1:
            x = F.silu(self._bn0(self._expand_conv(x)))
        x = F.silu(self._bn1(self._depthwise_conv(x)))
        if self.has_se:
            squeezed = avg_pool_global(x)
            squeezed = F.silu(self._se_reduce(squeezed))
            x = torch.sigmoid(self._se_expand(squeezed)) * x
        x = self._bn2(self._project_conv(x))
        if self.residual:
            if drop_mask is not None:
                x = x / keep * drop_mask
            x = x + inputs
        return x


class EfficientNetFeatures(nn.Module):
    """Stem + MBConv blocks, returning the reference's 4 encoder taps.

    In training, residual block ``i`` of ``n`` drops its branch per sample
    with probability ``drop_connect_rate · i / n`` (``efficientnet.py:263,
    282``); 0 turns drop-connect off. Under a data-parallel
    ``models.common.batch_share`` the masks are the global batch's, at this
    rank's rows.
    """

    CONV_BN = (("_conv_stem", "_bn0"),)

    def __init__(self, variant: str = "efficientnet-b0",
                 drop_connect_rate: float = 0.2):
        super().__init__()
        res = EFFICIENTNET_PARAMS[variant][2]
        stem_out, plan = _block_plan(variant)
        self.variant = variant
        self.drop_connect_rate = drop_connect_rate
        self._conv_stem = Conv(3, stem_out, 3, 2,
                               same_padding_static((res, res), (3, 3), (2, 2)))
        self._bn0 = BatchNorm(stem_out, eps=1e-3, momentum=0.01)
        self._blocks = nn.ModuleList(MBConvBlock(**args) for args in plan)
        self.splits = set(efficientnet_stage_splits(variant)[1:])

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, ...]:
        """NHWC images -> 4 NHWC taps. In training with drop-connect on,
        the masks are drawn from ``generator`` (on x's device)."""
        x = F.silu(self._bn0(self._conv_stem(x)))
        taps = []
        n_blocks = len(self._blocks)
        for i, block in enumerate(self._blocks):
            rate = self.drop_connect_rate * i / n_blocks
            if self.training and block.residual and rate > 0:
                if generator is None:
                    raise ValueError("drop-connect in training needs a "
                                     "torch.Generator")
                keep = 1.0 - rate
                u = per_sample_uniform(x.shape[0], generator, x.device)
                x = block(x, (u < keep).to(x.dtype), keep)
            else:
                x = block(x)
            if i + 1 in self.splits:
                taps.append(x)
        return tuple(taps)
