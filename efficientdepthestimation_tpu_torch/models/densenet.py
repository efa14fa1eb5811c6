"""DenseNet feature extractor (121/169/201/161), on NHWC tensors.

Counterpart of ``efficientdepthestimation_tpu/models/densenet.py``: the
reference's vendored old-torchvision DenseNet (ReSIDE/models/densenet.py)
as the Hu2018 encoder ``E_densenet`` (modules.py:78-105). Its taps are
each transition's conv output, *before* the transition's 2×2 average pool,
and ``relu(norm5)`` after the last block.

The old torchvision names hold dots inside one module name
(``features.denseblock1.denselayer1``, ``norm.1``, ``conv.2``), which a
PyTorch module name cannot; nested ``ModuleDict``s give the same
``state_dict`` keys (``features.denseblock1.denselayer1.norm.1.weight``),
and ``checkpoints.convert`` joins them back into the JAX package's names.
Every BatchNorm has PyTorch's eps 1e-5 and momentum 0.1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from efficientdepthestimation_tpu_torch.models.common import BatchNorm, Conv
from efficientdepthestimation_tpu_torch.ops.conv import avg_pool, max_pool

__all__ = ["DenseNetFeatures", "DenseLayer", "DENSENET_CONFIGS",
           "densenet_block_channels"]

# name -> (num_init_features, growth_rate, block_config)
DENSENET_CONFIGS = {
    "densenet121": (64, 32, (6, 12, 24, 16)),
    "densenet169": (64, 32, (6, 12, 32, 32)),
    "densenet201": (64, 32, (6, 12, 48, 32)),
    "densenet161": (96, 48, (6, 12, 36, 24)),
}


def densenet_block_channels(name: str) -> list[int]:
    """Channels of the four taps: each transition halves its block's."""
    init, growth, cfg = DENSENET_CONFIGS[name]
    chans, c = [], init
    for i, n in enumerate(cfg):
        c += n * growth
        if i < 3:
            c //= 2
        chans.append(c)
    return chans


class DenseLayer(nn.Module):
    """BN → ReLU → 1×1 conv to ``bn_size·growth`` → BN → ReLU → 3×3 conv to
    ``growth``, concatenated after the input."""

    def __init__(self, cin: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        width = bn_size * growth_rate
        self.norm = nn.ModuleDict({"1": BatchNorm(cin),
                                   "2": BatchNorm(width)})
        self.conv = nn.ModuleDict({"1": Conv(cin, width, 1),
                                   "2": Conv(width, growth_rate, 3,
                                             padding=1)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv["1"](F.relu(self.norm["1"](x)))
        out = self.conv["2"](F.relu(self.norm["2"](out)))
        return torch.cat([x, out], dim=-1)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 average pool, stride 2, no padding, of NHWC ``x``."""
    return avg_pool(x, 2, 2)


class DenseNetFeatures(nn.Module):
    """7×7/2 stem, 3×3/2 max pool (padding 1), four dense blocks with
    transitions between them, returning the four taps (NHWC). The stem's
    BatchNorm is the one that follows a conv: the dense layers' and
    transitions' read a concatenation or a pool, and stay BatchNorms of
    their own when baked."""

    CONV_BN = (("features.conv0", "features.norm0"),)

    def __init__(self, variant: str = "densenet161"):
        super().__init__()
        init, growth, cfg = DENSENET_CONFIGS[variant]
        self.variant = variant
        f = nn.ModuleDict({"conv0": Conv(3, init, 7, 2, 3),
                           "norm0": BatchNorm(init)})
        c = init
        for i, n in enumerate(cfg):
            f[f"denseblock{i + 1}"] = nn.ModuleDict({
                f"denselayer{j + 1}": DenseLayer(c + j * growth, growth)
                for j in range(n)})
            c += n * growth
            if i < 3:
                f[f"transition{i + 1}"] = nn.ModuleDict({
                    "norm": BatchNorm(c), "conv": Conv(c, c // 2, 1)})
                c //= 2
        f["norm5"] = BatchNorm(c)
        self.features = f

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, ...]:
        """NHWC images -> 4 NHWC taps. ``generator`` is accepted for the
        decoders' common call and unused: DenseNet has no drop-connect."""
        f = self.features
        x = max_pool(F.relu(f["norm0"](f["conv0"](x))), 3, 2, padding=1)
        taps = []
        for i in range(1, 5):
            for layer in f[f"denseblock{i}"].values():
                x = layer(x)
            if i < 4:
                t = f[f"transition{i}"]
                x = t["conv"](F.relu(t["norm"](x)))
                taps.append(x)  # before the pool (modules.py:85-88)
                x = _avg_pool2(x)
            else:
                taps.append(F.relu(f["norm5"](x)))
        return tuple(taps)
