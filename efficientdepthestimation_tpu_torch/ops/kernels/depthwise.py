"""Fused depthwise conv + folded BN + swish (+ SE spatial sums).

Counterpart of ``efficientdepthestimation_tpu/ops/pallas/depthwise.py``.
``depthwise_bn_swish`` launches the hand-written CUDA kernel in
``csrc/depthwise_bn_swish.cu`` on CUDA tensors and runs the plain PyTorch
version ``depthwise_bn_swish_plain`` on CPU tensors; it never falls back
from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from efficientdepthestimation_tpu_torch.ops.conv import norm_padding
from efficientdepthestimation_tpu_torch.ops.kernels import build

__all__ = ["depthwise_bn_swish", "depthwise_bn_swish_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def depthwise_bn_swish_plain(x, taps, scale, bias, stride=(1, 1),
                             padding=((0, 0), (0, 0))):
    """The kernel's function in plain PyTorch, computed in f32."""
    (pt, pb), (pl, pr) = norm_padding(padding)
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    w = taps.float().permute(2, 0, 1).unsqueeze(1)  # (C, 1, k, k)
    acc = F.conv2d(xp.permute(0, 3, 1, 2), w, stride=_pair(stride),
                   groups=x.shape[-1]).permute(0, 2, 3, 1)
    yf = acc * scale.float() + bias.float()
    yf = yf * torch.sigmoid(yf)
    return yf.to(x.dtype).contiguous(), yf.sum(dim=(1, 2))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("depthwise_bn_swish")
    fn = lib.ede_depthwise_bn_swish
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def depthwise_bn_swish(x: torch.Tensor, taps: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor,
                       stride=(1, 1), padding=((0, 0), (0, 0))
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """``swish(depthwise_conv(x) * scale + bias)`` and its spatial sums.

    x: (B, H, W, C) bf16 or f32; taps: (k, k, C) in x's dtype, k = 3 or 5;
    scale/bias: (C,) f32, a folded eval BatchNorm (``ops.norm.fold_bn``);
    padding ((top, bottom), (left, right)) of zeros. Returns
    ``(y, sums)``: y (B, oh, ow, C) in x's dtype and sums (B, C) f32 taken
    before the cast, so the squeeze-excite mean is ``sums / (oh * ow)``.
    """
    if x.device.type == "cpu":
        return depthwise_bn_swish_plain(x, taps, scale, bias, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_bn_swish: unsupported device {x.device}")
    (pt, pb), (pl, pr) = norm_padding(padding)
    sh, sw = _pair(stride)
    if x.dtype not in _DTYPES:
        raise TypeError(f"depthwise_bn_swish: x must be f32 or bf16, "
                        f"got {x.dtype}")
    if x.dim() != 4 or taps.dim() != 3:
        raise ValueError("depthwise_bn_swish: x must be (B,H,W,C) and taps "
                         "(k,k,C)")
    b, h, w, c = x.shape
    k = taps.shape[0]
    if taps.shape != (k, k, c) or k not in (3, 5):
        raise ValueError(f"depthwise_bn_swish: taps {tuple(taps.shape)} do "
                         f"not fit x {tuple(x.shape)} (k must be 3 or 5)")
    if sh != sw:
        raise ValueError("depthwise_bn_swish: the kernel takes a square "
                         f"stride, got {(sh, sw)}")
    if taps.dtype != x.dtype or scale.dtype != torch.float32 \
            or bias.dtype != torch.float32:
        raise TypeError("depthwise_bn_swish: taps must have x's dtype and "
                        "scale/bias must be f32")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError("depthwise_bn_swish: scale/bias must be (C,)")
    for t in (taps, scale, bias):
        if t.device != x.device:
            raise ValueError("depthwise_bn_swish: all tensors must be on "
                             f"{x.device}")
    for t in (x, taps, scale, bias):
        if not t.is_contiguous():
            raise ValueError("depthwise_bn_swish: tensors must be contiguous")
    oh = (h + pt + pb - k) // sh + 1
    ow = (w + pl + pr - k) // sw + 1
    if min(b, c, oh, ow) <= 0:
        raise ValueError(f"depthwise_bn_swish: empty output for x "
                         f"{tuple(x.shape)}")
    y = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    sums = torch.empty((b, c), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ede_depthwise_bn_swish(
            _DTYPES[x.dtype], x.data_ptr(), taps.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), y.data_ptr(), sums.data_ptr(),
            b, h, w, c, oh, ow, k, sh, pt, pl, stream)
    build.check(lib, err, "depthwise_bn_swish")
    depthwise_bn_swish.launches += 1
    return y, sums


depthwise_bn_swish.launches = 0
