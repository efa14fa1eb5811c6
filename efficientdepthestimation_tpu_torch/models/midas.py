"""MiDaS-style residual decoder, MidasNet and Discriminator, on NHWC tensors.

Counterpart of ``efficientdepthestimation_tpu/models/midas.py`` (reference
ReSIDE/models/lasinger2019.py:123-491):

* pre-activation ``ResidualBlock`` / ``BottleneckBlock``, whose 1×1
  projection ``down_sample`` takes the *raw* input;
* ``DecoderBlock``: ``out = prev + res1(enc); out = res2(out)``, then a
  bilinear align-corners resize to the next encoder scale. The deepest
  block has no ``prev`` and never runs its ``res_block2``, which is built
  all the same so that a checkpoint loads key for key;
* ``MidasDecoder``: the blocks top-down over the reversed taps, to sizes
  [s(t3), s(t2), s(t1), 2·s(t1)], then the head: 3×3 conv to 128 + BN +
  ReLU, resize to ``output_size``, 3×3 conv to 32 + BN + ReLU, 1×1 conv to
  one channel with bias, and ReLU iff ``non_negative``;
* ``MidasNet``: an encoder and the decoder; sizes are HW here, the
  checkpoint's header stores them WH (``checkpoints.serialization``);
* ``Discriminator``: the reference's patch critic, which no entry point
  uses.

Every BatchNorm outside the encoder has PyTorch's eps 1e-5 and momentum 0.1.
An EfficientNet encoder runs its depthwise kernel in eval, as under Hu2018.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from efficientdepthestimation_tpu_torch.models.common import BatchNorm, Conv
from efficientdepthestimation_tpu_torch.ops.conv import avg_pool_global
from efficientdepthestimation_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
)

__all__ = ["ResidualBlock", "BottleneckBlock", "DecoderBlock",
           "MidasDecoder", "MidasNet", "Discriminator"]


def _projection(cin: int, cout: int, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(Conv(cin, cout, 1, stride), BatchNorm(cout))


class ResidualBlock(nn.Module):
    """ReLU → 3×3 conv (stride) → BN → ReLU → 3×3 conv → BN, plus the input
    or, with ``project``, its 1×1 projection."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 project: bool = False):
        super().__init__()
        self.conv1 = Conv(cin, features, 3, stride, 1)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, 3, 1, 1)
        self.bn2 = BatchNorm(features)
        self.down_sample = (_projection(cin, features, stride) if project
                            else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1(self.conv1(F.relu(x)))
        out = self.bn2(self.conv2(F.relu(out)))
        res = x if self.down_sample is None else self.down_sample(x)
        return out + res


class BottleneckBlock(nn.Module):
    """Pre-activation 1×1 → 3×3 → 1×1 at ``features // 4`` channels inside,
    plus the input or its 1×1 projection."""

    def __init__(self, cin: int, features: int, project: bool = False):
        super().__init__()
        mid = max(1, features // 4)
        self.conv1 = Conv(cin, mid, 1)
        self.bn1 = BatchNorm(mid)
        self.conv2 = Conv(mid, mid, 3, 1, 1)
        self.bn2 = BatchNorm(mid)
        self.conv3 = Conv(mid, features, 1)
        self.bn3 = BatchNorm(features)
        self.down_sample = _projection(cin, features) if project else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1(self.conv1(F.relu(x)))
        out = self.bn2(self.conv2(F.relu(out)))
        out = self.bn3(self.conv3(F.relu(out)))
        res = x if self.down_sample is None else self.down_sample(x)
        return out + res


def _make_block(block_type: str, features: int, in_features: int
                ) -> nn.Module:
    project = in_features != features
    if block_type == "bottleneck":
        return BottleneckBlock(in_features, features, project=project)
    return ResidualBlock(in_features, features, project=project)


class DecoderBlock(nn.Module):

    def __init__(self, features: int, in_features: int,
                 block_type: str = "residual"):
        super().__init__()
        self.res_block1 = _make_block(block_type, features, in_features)
        self.res_block2 = _make_block(block_type, features, features)

    def forward(self, enc: torch.Tensor, prev: torch.Tensor | None,
                size: tuple[int, int]) -> torch.Tensor:
        if prev is None:  # the deepest block: res_block2 is never run
            out = self.res_block1(enc)
        else:
            out = self.res_block2(prev + self.res_block1(enc))
        return resize_bilinear_align_corners(out, size)


class MidasDecoder(nn.Module):
    """``num_features="auto"`` means the first tap's channels."""

    def __init__(self, encoder_block_channels: Sequence[int],
                 num_features: int | str = "auto",
                 non_negative: bool = False, block_type: str = "residual"):
        super().__init__()
        channels = [int(c) for c in encoder_block_channels]
        f = channels[0] if num_features == "auto" else int(num_features)
        self.feature_count = f
        self.non_negative = non_negative
        self.blocks = nn.ModuleList(DecoderBlock(f, c, block_type)
                                    for c in reversed(channels))
        self.conv1 = Conv(f, 128, 3, 1, 1)
        self.bn1 = BatchNorm(128)
        self.conv2 = Conv(128, 32, 3, 1, 1)
        self.bn2 = BatchNorm(32)
        self.conv3 = Conv(32, 1, 1, bias=True)

    def decode(self, taps: Sequence[torch.Tensor]) -> torch.Tensor:
        """The decoder blocks over the taps: features at twice the first
        tap's size."""
        sizes = [tuple(t.shape[1:3]) for t in reversed(taps[:-1])]
        sizes.append((sizes[-1][0] * 2, sizes[-1][1] * 2))
        out = None
        for block, enc, size in zip(self.blocks, reversed(taps), sizes):
            out = block(enc, out, size)
        return out

    def head(self, x: torch.Tensor,
             output_size: tuple[int, int]) -> torch.Tensor:
        """Decoder features to (N, *output_size, 1) depth."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = resize_bilinear_align_corners(x, output_size)
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.conv3(x)
        return F.relu(x) if self.non_negative else x

    def forward(self, taps: Sequence[torch.Tensor],
                output_size: tuple[int, int]) -> torch.Tensor:
        return self.head(self.decode(taps), output_size)


class MidasNet(nn.Module):
    """Encoder + MiDaS decoder: NHWC (N, h, w, 3) images to (N,
    *output_size, 1) depth. ``output_size`` and ``input_size`` are HW;
    ``input_size`` is metadata only."""

    def __init__(self, encoder: nn.Module,
                 encoder_block_channels: Sequence[int],
                 output_size: tuple[int, int] = (114, 152),
                 input_size: tuple[int, int] | None = None,
                 num_features: int | str = "auto",
                 non_negative: bool = False):
        super().__init__()
        self.output_size = tuple(output_size)
        self.input_size = None if input_size is None else tuple(input_size)
        self.encoder = encoder
        self.decoder = MidasDecoder(encoder_block_channels, num_features,
                                    non_negative)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` draws an EfficientNet encoder's drop-connect masks
        in training."""
        taps = self.encoder(x, generator=generator)
        return self.decoder(taps, self.output_size)


class Discriminator(nn.Module):
    """The reference's patch-style GAN critic (lasinger2019.py:426-491):
    NHWC (N, h, w, in_channels) to (N, 1, 1, 1)."""

    def __init__(self, in_channels: int = 4):
        super().__init__()
        self.in_channels = in_channels
        self.net = nn.Sequential(
            Conv(in_channels, 32, 7, bias=True), BatchNorm(32),
            ResidualBlock(32, 64, 2, project=True),
            ResidualBlock(64, 128, 2, project=True),
            ResidualBlock(128, 256, 2, project=True),
            ResidualBlock(256, 1024, 2, project=True),
            nn.ReLU(), Conv(1024, 1, 1, bias=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool_global(self.net(x))
