"""Fused depthwise conv + folded BN + swish (+ SE spatial sums).

Counterpart of ``efficientdepthestimation_tpu/ops/pallas/depthwise.py``.
``depthwise_bn_swish`` launches the hand-written CUDA kernel in
``csrc/depthwise_bn_swish.cu`` on CUDA tensors and runs the plain PyTorch
version ``depthwise_bn_swish_plain`` on CPU tensors; it never falls back
from one to the other. The kernel's source picks its block shape from the
call's shape alone (``launch_config`` asks it once a shape).
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

# The per-image counters of the sums' last-block reduction, by (device,
# stream). Each launch leaves its counters zero, so the launches of one
# stream, which run in order, share a buffer, and streams never do.
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def launch_config(b: int, oh: int, ow: int, c: int, k: int, stride: int,
                  itemsize: int, x_aligned: bool, sms: int
                  ) -> tuple[int, int, int, int, int, int, int]:
    """(vec, cv, lanes, ps, tr, tc, tpb) of the kernel for a (b, oh, ow, c)
    output on a card of ``sms`` SMs, as the kernel's source picks it
    (``choose_config`` in csrc/depthwise_bn_swish.cu), once a shape."""
    out = (ctypes.c_int * 7)()
    err = _lib().ede_depthwise_config(b, oh, ow, c, k, stride, itemsize,
                                      int(x_aligned), sms, out)
    if err:
        raise ValueError(f"depthwise_bn_swish: no block fits C={c}, k={k}")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _counters(device: torch.device, stream: torch.cuda.Stream,
              n: int) -> torch.Tensor:
    """Zeroed counters for a launch on ``stream``. A launch captured into a
    CUDA graph takes counters of its own, which the graph zeroes at every
    replay: a replay runs on any stream, in no order with the eager
    launches of the stream it was captured on."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(n, dtype=torch.int32, device=device)
    key = (device.index, stream.cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("depthwise_bn_swish")
    fn = lib.ede_depthwise_bn_swish
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 17 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ede_depthwise_config.argtypes = ([ctypes.c_int] * 9
                                         + [ctypes.POINTER(ctypes.c_int)])
    lib.ede_depthwise_config.restype = ctypes.c_int
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
    On the card the sums are the same, bit for bit, from launch to launch.
    """
    dev = x.device
    if dev.type == "cpu":
        return depthwise_bn_swish_plain(x, taps, scale, bias, stride, padding)
    if dev.type != "cuda":
        raise ValueError(f"depthwise_bn_swish: unsupported device {dev}")
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
    if sh != sw or sh not in (1, 2):
        raise ValueError("depthwise_bn_swish: the kernel takes stride 1 or "
                         f"2, got {(sh, sw)}")
    if taps.dtype != x.dtype or scale.dtype != torch.float32 \
            or bias.dtype != torch.float32:
        raise TypeError("depthwise_bn_swish: taps must have x's dtype and "
                        "scale/bias must be f32")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError("depthwise_bn_swish: scale/bias must be (C,)")
    for t in (taps, scale, bias):
        if t.device != dev:
            raise ValueError(f"depthwise_bn_swish: all tensors must be on "
                             f"{dev}")
    for t in (x, taps, scale, bias):
        if not t.is_contiguous():
            raise ValueError("depthwise_bn_swish: tensors must be contiguous")
    oh = (h + pt + pb - k) // sh + 1
    ow = (w + pl + pr - k) // sw + 1
    if min(b, c, oh, ow) <= 0:
        raise ValueError(f"depthwise_bn_swish: empty output for x "
                         f"{tuple(x.shape)}")
    vec, cv, lanes, ps, tr, tc, tpb = launch_config(
        b, oh, ow, c, k, sh, x.element_size(), x.data_ptr() % 16 == 0,
        _sms(dev.index))
    groups = _cdiv(_cdiv(oh, tr) * _cdiv(ow, tc), tpb)
    y = torch.empty((b, oh, ow, c), dtype=x.dtype, device=dev)
    sums = torch.empty((b, c), dtype=torch.float32, device=dev)
    partials = torch.empty((b, groups, c), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream()
        counters = _counters(dev, stream, b)
        err = lib.ede_depthwise_bn_swish(
            _DTYPES[x.dtype], x.data_ptr(), taps.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), y.data_ptr(), sums.data_ptr(),
            partials.data_ptr(), counters.data_ptr(), b, h, w, c, oh, ow, k,
            sh, pt, pl, vec, cv, lanes, ps, tr, tc, tpb, stream.cuda_stream)
    build.check(lib, err, "depthwise_bn_swish")
    depthwise_bn_swish.launches += 1
    return y, sums


depthwise_bn_swish.launches = 0
