"""Convolution with PyTorch padding semantics on NHWC tensors.

Activations are NHWC (the JAX package's layout) and kernels OIHW (PyTorch's).
``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is an NCHW view in
``channels_last`` memory, which cuDNN convolves without a copy; its output
comes back ``channels_last`` and permutes back to contiguous NHWC for free.

``depthwise_impl`` selects how depthwise convs (groups == channels) are
computed, and ``ops.quant.quantized_convs`` routes eligible dense convs
through int8; ``conv2d`` reads both at call time.

Under ``parallel.spatial.row_sharded`` (spatial serving) the convs and
pools here take this rank's band of rows: each computes its own block of
output rows from the input rows that block reads, the halo fetched from the
ranks that own it, with the op's padding only at the image's real top and
bottom; ``avg_pool_global`` all-reduces the bands' sums.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from efficientdepthestimation_tpu_torch.ops import quant as _quant
from efficientdepthestimation_tpu_torch.parallel import spatial

__all__ = ["conv2d", "depthwise_impl", "depthwise_mode", "same_padding_static",
           "norm_padding", "max_pool", "avg_pool", "avg_pool_global"]

# How depthwise convs are computed, read at call time (JAX binds it at
# trace time; an eager forward has no trace, so a serving fn enters its
# mode around each of its calls). The three modes compute the same
# function:
#   "pallas": the eval MBConv block runs the hand-written
#             ``depthwise_bn_swish`` kernel (depthwise conv, folded BN,
#             swish and the SE sums in one launch), the JAX package's
#             Pallas kernel's counterpart; the port's default, so that every
#             path launches the kernel unless asked otherwise. The JAX
#             package's default is "xla", its Pallas path an opt-in,
#             because there the kernel only paid off inside its fused
#             encoder; here it is the encoder's measured hot path.
#   "xla":    cuDNN's grouped conv, then the BN and swish as ops of their
#             own (the JAX package's XLA lowering);
#   "shift":  the conv as a sum over taps of strided slices × per-channel
#             taps (``_depthwise_shifted``), a reordering of the grouped
#             conv's sums, in f32 as cuDNN's are (the JAX package adds its
#             terms in the activations' dtype).
_DEPTHWISE_MODES = ("pallas", "xla", "shift")
_DEPTHWISE_IMPL = "pallas"


@contextlib.contextmanager
def depthwise_impl(mode: str):
    """Within the block, depthwise convs are computed as ``mode`` says."""
    global _DEPTHWISE_IMPL
    if mode not in _DEPTHWISE_MODES:
        raise ValueError(f"unknown depthwise impl: {mode!r}")
    prev = _DEPTHWISE_IMPL
    _DEPTHWISE_IMPL = mode
    try:
        yield
    finally:
        _DEPTHWISE_IMPL = prev


def depthwise_mode() -> str:
    """The depthwise mode in force: "pallas", "xla" or "shift"."""
    return _DEPTHWISE_IMPL


def _depthwise_shifted(x: torch.Tensor, weight: torch.Tensor, stride,
                       padding) -> torch.Tensor:
    """Depthwise conv of NHWC ``x`` and (C, 1, kh, kw) ``weight`` as a sum
    of strided slices × per-channel taps, each tap added in turn into an
    f32 sum (one ``addcmul_`` a tap), rounded once to x's dtype."""
    _, _, kh, kw = weight.shape
    (pt, pb), (pl, pr) = padding
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    oh = (xp.shape[1] - kh) // sh + 1
    ow = (xp.shape[2] - kw) // sw + 1
    taps = weight[:, 0].permute(1, 2, 0).float()  # (kh, kw, C)
    out = torch.zeros(x.shape[0], oh, ow, x.shape[3], device=x.device)
    for i in range(kh):
        for j in range(kw):
            out.addcmul_(xp[:, i:i + (oh - 1) * sh + 1:sh,
                            j:j + (ow - 1) * sw + 1:sw], taps[i, j])
    return out.to(x.dtype)


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
    Under ``depthwise_impl("shift")`` a depthwise conv takes the per-tap
    form; under ``quantized_convs`` an eligible dense conv runs in int8.
    """
    pads = norm_padding(padding)
    cout, cin_g, kh, kw = weight.shape
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    quantized = _quant.should_quantize((kh, kw, cin_g * groups, cout),
                                       groups, (1, 1))
    ctx = spatial.active()
    amax = None
    if ctx is not None and quantized:
        # the one-process scale, the whole input's amax, for every
        # quantized conv (a 1×1 one too): every rank enters the reduction
        amax = ctx.max(x.float().abs().amax() if x.shape[1]
                       else x.new_zeros((), dtype=torch.float32))
    if ctx is not None and (kh, s[0], pads[0]) != (1, 1, (0, 0)):
        (pt, pb), (pl, pr) = pads
        x, above, below, out_h = ctx.window(x, kh, s[0], pt, pb)
        ctx.note(out_h, (x.shape[2] + pl + pr - kw) // s[1] + 1)
        pads = ((above, below), (pl, pr))
    if ctx is not None and x.shape[1] == 0:  # a rank without rows here
        (_, _), (pl, pr) = pads
        return x.new_zeros((x.shape[0], 0,
                            (x.shape[2] + pl + pr - kw) // s[1] + 1, cout))
    if (_DEPTHWISE_IMPL == "shift" and groups > 1 and groups == x.shape[-1]
            and cin_g == 1 and cout == groups):
        out = _depthwise_shifted(x, weight, stride, pads)
        return out if bias is None else out + bias.to(out.dtype)
    if quantized:
        return _quant.quant_conv2d(x, weight, stride=s, padding=pads,
                                   bias=bias, amax=amax)
    (pt, pb), (pl, pr) = pads
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
    k, s, p = (_pair(window)[0], _pair(stride)[0], _pair(padding)[0])
    ctx = spatial.active()
    if ctx is not None:
        x, above, below, out_h = ctx.window(x, k, s, p, p, ceil_mode)
        out_w = spatial.window_out_height(x.shape[2], k, s, p, p, ceil_mode)
        ctx.note(out_h, out_w)
        if x.shape[1] == 0:
            return x.new_zeros((x.shape[0], 0, out_w, x.shape[3]))
        # the rows' padding, -inf, is explicit; the columns' stays the op's
        x = F.pad(x, (0, 0, 0, 0, above, below), value=float("-inf"))
        padding = (0, _pair(padding)[1])
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding,
                     ceil_mode=ceil_mode)
    return y.permute(0, 2, 3, 1).contiguous()


def avg_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Average pooling of NHWC ``x`` without padding (DenseNet's
    transitions)."""
    ctx = spatial.active()
    if ctx is not None:
        x, _, _, out_h = ctx.window(x, window, stride, 0, 0)
        out_w = spatial.window_out_height(x.shape[2], window, stride, 0, 0)
        ctx.note(out_h, out_w)
        if x.shape[1] == 0:
            return x.new_zeros((x.shape[0], 0, out_w, x.shape[3]))
    return F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(
        0, 2, 3, 1).contiguous()


def avg_pool_global(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Mean over H and W of NHWC ``x`` (``nn.AdaptiveAvgPool2d(1)``); of a
    band, the bands' sums all-reduced over the global plane."""
    ctx = spatial.active()
    if ctx is None:
        return x.mean(dim=(1, 2), keepdim=keepdims)
    h, w = spatial.global_hw(x)
    total = ctx.sum(x.float().sum(dim=(1, 2), keepdim=keepdims))
    return (total / (h * w)).to(x.dtype)


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)
