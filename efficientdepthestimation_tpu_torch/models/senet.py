"""SENet family feature extractors, on NHWC tensors.

Counterpart of ``efficientdepthestimation_tpu/models/senet.py``: the
reference's vendored Cadene SENet (ReSIDE/models/senet.py) as the Hu2018
encoder ``E_senet`` (modules.py:108-121), tapped after ``layer1``..
``layer4``. SENet-154 has a stem of three 3×3 convs, grouped bottlenecks
(groups 64) and 3×3 downsample convs in layers 2-4; the SE-ResNet-50/101/
152 and SE-ResNeXt-50/101-32x4d rows of the same table (senet.py:398-453)
have a 7×7 stem, the stride on ``conv1`` (SE-ResNet, the Caffe placement)
or a grouped ``conv2`` of width planes·base_width/64·groups (SE-ResNeXt),
and 1×1 downsamples. All share the Caffe ceil-mode max pool and the SE
module (reduction 16), whose 1×1 convs ``fc1``/``fc2`` carry a bias.

Module names give the JAX package's paths (``layer0.conv1``,
``layer1.0.se_module.fc1``, ``downsample.0``) through nested containers;
``checkpoints.convert`` joins them back into its dotted names. Every
BatchNorm has PyTorch's eps 1e-5 and momentum 0.1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from efficientdepthestimation_tpu_torch.models.common import BatchNorm, Conv
from efficientdepthestimation_tpu_torch.ops.conv import (
    avg_pool_global,
    max_pool,
)

__all__ = ["SENetFeatures", "SEBottleneck", "SENET_CONFIGS",
           "senet_block_channels"]

# name -> the reference's SENet(...) arguments (senet.py:389-453). layer1
# always downsamples with a 1×1 conv; down_kernel/down_pad apply to layers
# 2-4 (senet.py:289-327).
SENET_CONFIGS = {
    "senet154": dict(style="senet", layers=(3, 8, 36, 3), groups=64,
                     inplanes=128, input_3x3=True, down_kernel=3, down_pad=1),
    "se_resnet50": dict(style="se_resnet", layers=(3, 4, 6, 3), groups=1,
                        inplanes=64, input_3x3=False, down_kernel=1,
                        down_pad=0),
    "se_resnet101": dict(style="se_resnet", layers=(3, 4, 23, 3), groups=1,
                         inplanes=64, input_3x3=False, down_kernel=1,
                         down_pad=0),
    "se_resnet152": dict(style="se_resnet", layers=(3, 8, 36, 3), groups=1,
                         inplanes=64, input_3x3=False, down_kernel=1,
                         down_pad=0),
    "se_resnext50_32x4d": dict(style="se_resnext", layers=(3, 4, 6, 3),
                               groups=32, inplanes=64, input_3x3=False,
                               down_kernel=1, down_pad=0),
    "se_resnext101_32x4d": dict(style="se_resnext", layers=(3, 4, 23, 3),
                                groups=32, inplanes=64, input_3x3=False,
                                down_kernel=1, down_pad=0),
}


def senet_block_channels(name: str = "senet154") -> list[int]:
    """Every variant expands each stage to planes·4."""
    return [256, 512, 1024, 2048]


class SEBottleneck(nn.Module):
    """1×1 → 3×3 (grouped) → 1×1 to planes·4, each with BN, then
    squeeze-excite and the residual. ``style`` sets the widths and where
    the stride goes (senet.py:136-211):

    * ``senet``: 1×1 to planes·2, grouped 3×3 (stride) to planes·4;
    * ``se_resnet``: 1×1 (stride) to planes, 3×3 to planes;
    * ``se_resnext``: 1×1 to planes·base_width/64·groups, grouped 3×3
      (stride) to the same.
    """

    CONV_BN = (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"),
               ("downsample.0", "downsample.1"))

    def __init__(self, inplanes: int, planes: int, style: str = "senet",
                 groups: int = 64, reduction: int = 16, base_width: int = 4,
                 stride: int = 1, has_downsample: bool = False,
                 downsample_kernel: int = 1, downsample_padding: int = 0):
        super().__init__()
        if style == "senet":
            w1, w2, s1, s2 = planes * 2, planes * 4, 1, stride
        elif style == "se_resnet":
            w1, w2, s1, s2 = planes, planes, stride, 1
        elif style == "se_resnext":
            w1 = w2 = int(planes * base_width / 64) * groups
            s1, s2 = 1, stride
        else:
            raise ValueError(f"unknown SE bottleneck style {style!r}")
        out = planes * 4
        self.conv1 = Conv(inplanes, w1, 1, s1)
        self.bn1 = BatchNorm(w1)
        self.conv2 = Conv(w1, w2, 3, s2, 1, groups=groups)
        self.bn2 = BatchNorm(w2)
        self.conv3 = Conv(w2, out, 1)
        self.bn3 = BatchNorm(out)
        self.downsample = (nn.Sequential(
            Conv(inplanes, out, downsample_kernel, stride, downsample_padding),
            BatchNorm(out)) if has_downsample else None)
        self.se_module = nn.ModuleDict({
            "fc1": Conv(out, out // reduction, 1, bias=True),
            "fc2": Conv(out // reduction, out, 1, bias=True)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        se = F.relu(self.se_module["fc1"](avg_pool_global(out)))
        out = out * torch.sigmoid(self.se_module["fc2"](se))
        return F.relu(out + residual)


class SENetFeatures(nn.Module):
    """``layer0`` (the stem) + ``layer1``..``layer4``, returning the four
    stage outputs (NHWC). ``layers`` overrides the variant's block counts
    (a test size)."""

    def __init__(self, variant: str = "senet154",
                 layers: tuple[int, int, int, int] | None = None):
        super().__init__()
        cfg = dict(SENET_CONFIGS[variant])
        if layers is not None:
            cfg["layers"] = tuple(layers)
        self.variant = variant
        inplanes = cfg["inplanes"]
        if cfg["input_3x3"]:  # senet.py:263-276
            widths = ((3, 64), (64, 64), (64, inplanes))
            stem = {}
            for i, (cin, cout) in enumerate(widths, 1):
                stem[f"conv{i}"] = Conv(cin, cout, 3, 2 if i == 1 else 1, 1)
                stem[f"bn{i}"] = BatchNorm(cout)
        else:  # senet.py:278-283
            stem = {"conv1": Conv(3, inplanes, 7, 2, 3),
                    "bn1": BatchNorm(inplanes)}
        self.layer0 = nn.ModuleDict(stem)
        self.CONV_BN = tuple((f"layer0.conv{i}", f"layer0.bn{i}")
                             for i in range(1, len(stem) // 2 + 1))
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                     cfg["layers"])):
            stride = 1 if stage == 0 else 2
            dk, dp = ((1, 0) if stage == 0
                      else (cfg["down_kernel"], cfg["down_pad"]))
            seq = []
            for i in range(blocks):
                s = stride if i == 0 else 1
                seq.append(SEBottleneck(
                    inplanes, planes, cfg["style"], cfg["groups"], 16, 4, s,
                    i == 0 and (s != 1 or inplanes != planes * 4), dk, dp))
                inplanes = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*seq))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, ...]:
        """NHWC images -> 4 NHWC taps. ``generator`` is accepted for the
        decoders' common call and unused: SENet has no drop-connect."""
        stem = self.layer0
        for i in range(1, len(stem) // 2 + 1):
            x = F.relu(stem[f"bn{i}"](stem[f"conv{i}"](x)))
        # the Caffe pool: 3×3/2, ceil mode (senet.py:285-287)
        x = max_pool(x, 3, 2, padding=0, ceil_mode=True)
        taps = []
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            taps.append(x)
        return tuple(taps)
