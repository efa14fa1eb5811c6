"""Convolution with PyTorch padding semantics on NHWC tensors.

Activations are NHWC (the JAX package's layout) and kernels OIHW (PyTorch's).
``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is an NCHW view in
``channels_last`` memory, which cuDNN convolves without a copy; its output
comes back ``channels_last`` and permutes back to contiguous NHWC for free.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["conv2d", "same_padding_static", "norm_padding", "max_pool",
           "avg_pool_global"]


def norm_padding(padding) -> tuple[tuple[int, int], tuple[int, int]]:
    """Any torch-style padding as ((top, bottom), (left, right))."""
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    ph, pw = padding
    if isinstance(ph, int):
        return ((ph, ph), (pw, pw))
    return (tuple(ph), tuple(pw))


def conv2d(x: torch.Tensor, weight: torch.Tensor, *,
           stride: int | tuple[int, int] = 1, padding=0, groups: int = 1,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """2-D convolution: NHWC ``x``, OIHW ``weight``, explicit zero padding.

    Asymmetric padding (efficientnet-pytorch's static same padding) is
    applied with ``F.pad`` first; symmetric padding goes to ``F.conv2d``.
    """
    (pt, pb), (pl, pr) = norm_padding(padding)
    if pt != pb or pl != pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        pt = pl = 0
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride,
                 padding=(pt, pl), groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def same_padding_static(image_size: tuple[int, int],
                        kernel_size: tuple[int, int],
                        stride: tuple[int, int],
                        dilation: tuple[int, int] = (1, 1),
                        ) -> tuple[tuple[int, int], tuple[int, int]]:
    """TensorFlow-style 'SAME' padding computed for a *fixed* image size.

    Reproduces efficientnet-pytorch 0.6.3's ``Conv2dStaticSamePadding``
    (asymmetric, the extra pixel on the right/bottom), which the released
    checkpoints were trained with. The padding depends on the network's
    canonical image size (224 for B0), not on the runtime input.
    """
    pads = []
    for size, k, s, d in zip(image_size, kernel_size, stride, dilation):
        eff_k = (k - 1) * d + 1
        out = math.ceil(size / s)
        total = max((out - 1) * s + eff_k - size, 0)
        pads.append((total // 2, total - total // 2))
    return (pads[0], pads[1])


def max_pool(x: torch.Tensor, window: int | tuple[int, int],
             stride: int | tuple[int, int], padding: int | tuple[int, int] = 0,
             ceil_mode: bool = False) -> torch.Tensor:
    """Max pooling of NHWC ``x`` with PyTorch semantics: the padding is
    -inf, and ``ceil_mode`` keeps a last partial window that starts inside
    the input or its left padding (SENet's stem pools), as the JAX
    package's ``max_pool`` reproduces (``ops/conv.py:203-212`` there)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding,
                     ceil_mode=ceil_mode)
    return y.permute(0, 2, 3, 1).contiguous()


def avg_pool_global(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Mean over H and W of NHWC ``x`` (``nn.AdaptiveAvgPool2d(1)``)."""
    return x.mean(dim=(1, 2), keepdim=keepdims)
