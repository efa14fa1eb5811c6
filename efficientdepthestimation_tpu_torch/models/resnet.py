"""ResNet feature extractor (18/34/50/101/152), on NHWC tensors.

Counterpart of ``efficientdepthestimation_tpu/models/resnet.py``: the
torchvision-v1 ResNet of the reference (stride on ``conv2`` of the
bottleneck, 7×7/2 stem, 3×3/2 max pool with padding 1) as a backbone of
four taps, the outputs of ``layer1``..``layer4``; there is no classifier
head. Module names give the JAX package's paths (``conv1``, ``layer1.0``,
``downsample.0``); every BatchNorm has PyTorch's eps 1e-5 and momentum 0.1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from efficientdepthestimation_tpu_torch.models.common import BatchNorm, Conv
from efficientdepthestimation_tpu_torch.ops.conv import max_pool

__all__ = ["ResNetFeatures", "BasicBlock", "Bottleneck", "RESNET_LAYERS",
           "resnet_block_channels"]

RESNET_LAYERS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


def resnet_block_channels(name: str) -> list[int]:
    block, _ = RESNET_LAYERS[name]
    expansion = 1 if block == "basic" else 4
    return [64 * expansion, 128 * expansion, 256 * expansion, 512 * expansion]


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(Conv(cin, cout, 1, stride), BatchNorm(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, 3, stride, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm(planes)
        self.downsample = (_downsample(inplanes, planes, stride)
                           if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride, 1)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = (_downsample(inplanes, planes * 4, stride)
                           if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNetFeatures(nn.Module):
    """Stem + layer1..4, returning the four stage outputs (NHWC)."""

    def __init__(self, variant: str = "resnet50"):
        super().__init__()
        self.variant = variant
        block_name, layers = RESNET_LAYERS[variant]
        block = BasicBlock if block_name == "basic" else Bottleneck
        self.conv1 = Conv(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                     layers)):
            stride = 1 if stage == 0 else 2
            seq = []
            for i in range(blocks):
                s = stride if i == 0 else 1
                downsample = i == 0 and (s != 1 or
                                         inplanes != planes * block.expansion)
                seq.append(block(inplanes, planes, s, downsample))
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*seq))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, ...]:
        """NHWC images -> 4 NHWC taps. ``generator`` is accepted for the
        decoders' common call and unused: ResNet has no drop-connect."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool(x, 3, 2, padding=1)
        taps = []
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            taps.append(x)
        return tuple(taps)
