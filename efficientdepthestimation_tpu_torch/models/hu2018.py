"""Hu2018 decoder (D + MFF + R) and the assembled model, NHWC.

Counterpart of ``efficientdepthestimation_tpu/models/hu2018.py``
(reference ReSIDE/models/modules.py:16-298, net.py:17-39). Each
UpProjection computes both 5×5 branches of ``conv(upsample(x))`` in one
pass over branch-stacked kernels: through the exact einsum rewrite
(``ops.fused.upsample_conv_pair``) where ``should_fuse`` picks it, else
through the hand-written ``upsample_conv`` kernel, whose gradient is the
VJP of the plain composition. ``module.train()`` selects batch statistics in
every BatchNorm, as ``train=True`` does in the JAX package.

Under ``ops.quant.quantized_convs`` a kernel site whose stacked
(5, 5, cin, 2·features) conv passes the int8 gate is computed as the resize,
then the int8 conv: the JAX package quantizes the conv of its direct
composition there, and the kernel has no int8 form. The einsum route stays
float in both packages. ``mff_apply_merged`` runs the eval MFF with its four
branch tails merged into one 64-channel stream (``HuDepthModel``'s
``mff_merge``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from efficientdepthestimation_tpu_torch.models.common import BatchNorm, Conv
from efficientdepthestimation_tpu_torch.ops import quant
from efficientdepthestimation_tpu_torch.ops.conv import conv2d
from efficientdepthestimation_tpu_torch.ops.fused import (
    should_fuse,
    upsample_conv_pair,
)
from efficientdepthestimation_tpu_torch.ops.kernels.upproj import upsample_conv
from efficientdepthestimation_tpu_torch.ops.norm import batch_norm
from efficientdepthestimation_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
)

__all__ = ["UpProjection", "DecoderD", "MFF", "RefineR", "HuDepthModel",
           "mff_apply_merged"]


def _hwio(weight: torch.Tensor) -> torch.Tensor:
    return weight.permute(2, 3, 1, 0)


class UpProjection(nn.Module):
    """Upsample, then two branches (5×5→BN→ReLU→3×3→BN and 5×5→BN), summed,
    ReLU. ``conv1``/``conv2`` hold only the 5×5 weights of the branches."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.features = features
        self.conv1 = Conv(cin, features, 5, padding=2)
        self.conv2 = Conv(cin, features, 5, padding=2)
        self.bn1 = BatchNorm(features)
        self.conv1_2 = Conv(features, features, 3, padding=1)
        self.bn1_2 = BatchNorm(features)
        self.bn2 = BatchNorm(features)

    def heads(self, x: torch.Tensor, size: tuple[int, int]
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Both branches' 5×5 convs of ``upsample(x, size)``, before their
        BatchNorms, by the site's route."""
        f, cin = self.features, x.shape[-1]
        k1 = _hwio(self.conv1.weight).to(x.dtype)
        k2 = _hwio(self.conv2.weight).to(x.dtype)
        if should_fuse(tuple(x.shape[1:3]), tuple(size), cin, f, x.dtype):
            return upsample_conv_pair(x, k1, k2, size)
        if quant.should_quantize((5, 5, cin, 2 * f), 1, (1, 1)):
            w = torch.cat([self.conv1.weight, self.conv2.weight])
            b = quant.quant_conv2d(resize_bilinear_align_corners(x, size),
                                   w.to(x.dtype), padding=((2, 2), (2, 2)))
        else:
            b = upsample_conv(x, torch.cat([k1, k2], dim=-1).contiguous(),
                              size)
        return b[..., :f], b[..., f:]

    def forward(self, x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
        b1, b2 = self.heads(x, size)
        b1 = self.bn1_2(self.conv1_2(F.relu(self.bn1(b1))))
        return F.relu(b1 + self.bn2(b2))


class DecoderD(nn.Module):
    """1×1 channel-halving conv, then 4 chained UpProjections."""

    def __init__(self, num_features: int):
        super().__init__()
        f = num_features // 2
        self.conv = Conv(num_features, f, 1)
        self.bn = BatchNorm(f)
        self.up1 = UpProjection(f, f // 2)
        self.up2 = UpProjection(f // 2, f // 4)
        self.up3 = UpProjection(f // 4, f // 8)
        self.up4 = UpProjection(f // 8, f // 16)

    def forward(self, taps: Sequence[torch.Tensor]) -> torch.Tensor:
        b1, b2, b3, b4 = taps
        x = F.relu(self.bn(self.conv(b4)))
        x = self.up1(x, tuple(b3.shape[1:3]))
        x = self.up2(x, tuple(b2.shape[1:3]))
        x = self.up3(x, tuple(b1.shape[1:3]))
        return self.up4(x, (b1.shape[1] * 2, b1.shape[2] * 2))


class MFF(nn.Module):
    """Each tap through an UpProjection to 16 channels at the decoder size,
    concatenated, then 5×5 conv + BN + ReLU."""

    def __init__(self, block_channel: Sequence[int], num_features: int = 64):
        super().__init__()
        for i, c in enumerate(block_channel):
            setattr(self, f"up{i + 1}", UpProjection(c, 16))
        self.conv = Conv(16 * len(block_channel), num_features, 5, padding=2)
        self.bn = BatchNorm(num_features)

    def forward(self, taps: Sequence[torch.Tensor],
                size: tuple[int, int]) -> torch.Tensor:
        ups = [getattr(self, f"up{i + 1}")(tap, size)
               for i, tap in enumerate(taps)]
        return F.relu(self.bn(self.conv(torch.cat(ups, dim=-1))))


def mff_apply_merged(mff: MFF, taps: Sequence[torch.Tensor],
                     size: tuple[int, int], *,
                     block_diag: bool = False) -> torch.Tensor:
    """The eval forward of ``mff`` with its four branch tails merged.

    The same function as ``mff(taps, size)`` in eval, from the same
    module, weights and running statistics (JAX ``models/hu2018.py:118-185``):
    each branch's 5×5 heads stay apart (each tap has its own resolution and
    route), then the four 16-channel tails run as one 64-channel stream:
    the branches' BNs concatenated (channelwise, so concatenation commutes),
    one 3×3 conv over the four ``conv1_2`` weights as a 4-group conv
    (``block_diag=True``: one dense 64×64 block-diagonal weight instead, 4×
    the operations, zeros off the blocks), BN, add, ReLU.
    """
    ups = [getattr(mff, f"up{i + 1}") for i in range(len(taps))]
    heads = [up.heads(tap, size) for up, tap in zip(ups, taps)]

    def cat_bn(x, name):
        folds = [getattr(up, name).folded() for up in ups]
        return batch_norm(x, torch.cat([s for s, _ in folds]),
                          torch.cat([b for _, b in folds]))

    x1 = F.relu(cat_bn(torch.cat([h[0] for h in heads], dim=-1), "bn1"))
    ws = [up.conv1_2.weight for up in ups]  # each (co, co, 3, 3)
    co = ws[0].shape[0]
    if block_diag:
        w = ws[0].new_zeros(len(ws) * co, len(ws) * co, 3, 3)
        for i, wi in enumerate(ws):
            w[i * co:(i + 1) * co, i * co:(i + 1) * co] = wi
        x1 = conv2d(x1, w.to(x1.dtype), padding=1)
    else:
        x1 = conv2d(x1, torch.cat(ws).to(x1.dtype), padding=1,
                    groups=len(ws))
    x1 = cat_bn(x1, "bn1_2")
    x2 = cat_bn(torch.cat([h[1] for h in heads], dim=-1), "bn2")
    x = F.relu(x1 + x2)
    return F.relu(mff.bn(mff.conv(x)))


class RefineR(nn.Module):
    """Two 5×5 conv+BN+ReLU, then a 5×5 conv to one depth channel."""

    def __init__(self, block_channel4: int):
        super().__init__()
        f = 64 + block_channel4 // 32
        self.conv0 = Conv(f, f, 5, padding=2)
        self.bn0 = BatchNorm(f)
        self.conv1 = Conv(f, f, 5, padding=2)
        self.bn1 = BatchNorm(f)
        self.conv2 = Conv(f, 1, 5, padding=2, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn0(self.conv0(x)))
        x = F.relu(self.bn1(self.conv1(x)))
        return self.conv2(x)


class HuDepthModel(nn.Module):
    """Encoder ``E`` + D/MFF/R decoders: NHWC (N, h, w, 3) images to
    (N, h/2, w/2, 1) depth."""

    def __init__(self, encoder: nn.Module, num_features: int,
                 block_channel: Sequence[int]):
        super().__init__()
        self.num_features = num_features
        self.block_channel = tuple(block_channel)
        self.E = encoder
        self.D = DecoderD(num_features)
        self.MFF = MFF(block_channel)
        self.R = RefineR(block_channel[3])

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None, *,
                mff_merge: str = "module") -> torch.Tensor:
        """``generator`` draws the encoder's drop-connect masks in
        training. ``mff_merge`` "grouped" or "blockdiag" runs the eval MFF
        through ``mff_apply_merged``, "module" as it is.

        Each intermediate is released at its last reader, the taps after
        MFF, D's and MFF's outputs once R's input is built, so an eval
        forward's peak is not its whole working set (autograd keeps what
        the backward needs)."""
        taps = self.E(x, generator=generator)
        x_d = self.D(taps)
        size = tuple(x_d.shape[1:3])
        if mff_merge == "module":
            x_mff = self.MFF(taps, size)
        else:
            x_mff = mff_apply_merged(self.MFF, taps, size,
                                     block_diag=mff_merge == "blockdiag")
        del taps
        x = torch.cat([x_d, x_mff], dim=-1)
        del x_d, x_mff
        return self.R(x)
