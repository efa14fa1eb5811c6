"""Dynamic-range int8 convolution for the opt-in quantized serving forms.

Counterpart of ``efficientdepthestimation_tpu/ops/quant.py``, with the same
scheme, so that the two packages quantize to the same integers:

* weights: symmetric per-output-channel scales, ``s_w = max|K[o]|/127``;
* activations: one symmetric scale a tensor, taken from the running batch
  (``s_x = max|x|/127``);
* both rounded half to even (``torch.round``, as ``jnp.round``) and clipped
  to ±127; the conv sums s8×s8 products in int32, which is exact, and the
  dequantize ``y·s_x·s_w`` is one f32 multiply.

The int32 conv is a library computation in both packages (XLA's
``conv_general_dilated`` there): here one ``torch._int_mm`` a tap over
rows of the padded int8 input, summed in int32, so that no im2col is ever
written. A 5×5 site at 2048 input channels sums at most 25·2048·127² <
2³¹, so the order of the sums cannot matter.

Which convs quantize is JAX's gate, kept as it is (``should_quantize``):
dense, undilated, ``cin % 128 == 0`` and ``kh·kw·cin ≥ 1600``. It defines
which convs change numerics, so the two packages' forwards can be held
against each other; its thresholds are not fitted to the card. Nothing
here turns on by itself: ``quantized_convs()`` must be entered around the
calls, as ``ops.conv.depthwise_impl`` is.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = ["quant_conv2d", "quantize_kernel", "quantized_convs",
           "quant_enabled", "should_quantize", "int_conv2d"]

# Consulted by ops.conv.conv2d and the Hu2018 UpProjection at call time:
# None = off, else the least kh·kw·cin a dense conv needs to quantize.
_QUANT_MIN_MACS: int | None = None


@contextlib.contextmanager
def quantized_convs(min_macs_per_px: int = 1600):
    """Within the block, eligible dense convs run in int8
    (``should_quantize``)."""
    global _QUANT_MIN_MACS
    prev = _QUANT_MIN_MACS
    _QUANT_MIN_MACS = int(min_macs_per_px)
    try:
        yield
    finally:
        _QUANT_MIN_MACS = prev


def quant_enabled() -> bool:
    return _QUANT_MIN_MACS is not None


def should_quantize(kernel_shape, groups: int, dilation) -> bool:
    """Whether a conv of HWIO ``kernel_shape`` (kh, kw, cin, cout) runs in
    int8 here: the JAX package's gate, off outside ``quantized_convs``."""
    if _QUANT_MIN_MACS is None or groups != 1:
        return False
    if tuple(dilation) != (1, 1):
        return False
    kh, kw, cin, _ = kernel_shape
    return cin % 128 == 0 and kh * kw * cin >= _QUANT_MIN_MACS


def quantize_kernel(weight: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """OIHW ``weight`` → (int8 weight, f32 scale an output channel)."""
    k = weight.float()
    scale = _per_127(k.abs().amax(dim=(1, 2, 3)))
    kq = torch.clamp(torch.round(k / scale[:, None, None, None]), -127, 127)
    return kq.to(torch.int8), scale


def _per_127(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-30) / 127``, rounded once. A Python divisor would
    let the card multiply by its reciprocal instead, an ulp off, which
    moves a quotient on a half to the other integer."""
    return amax.clamp(min=1e-30) / torch.full_like(amax, 127.0)


def _int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` of int8 rows (M, K) and weights (N, K), in int32, through
    ``torch._int_mm`` with its weights read column-major, the layout
    cuBLASLt's int8 GEMM takes. On the card it needs M > 16 and N a
    multiple of 8: the call pads both with zeros (the R head's one output
    channel) and returns the (M, N) block."""
    m, n = a.shape[0], w.shape[0]
    pad_m, pad_n = max(0, 17 - m), -n % 8
    if pad_m:
        a = F.pad(a, (0, 0, 0, pad_m))
    if pad_n:
        w = F.pad(w, (0, 0, 0, pad_n))
    out = torch._int_mm(a, w.t())
    return out[:m, :n] if pad_m or pad_n else out


def int_conv2d(xq: torch.Tensor, kq: torch.Tensor, stride=(1, 1),
               padding=((0, 0), (0, 0))) -> torch.Tensor:
    """The exact int32 conv of NHWC int8 ``xq`` and OIHW int8 ``kq`` with
    zero padding, one ``_int_mm`` a tap.

    At stride 1 each tap's rows are one contiguous stretch of the padded
    input read as (N·Hp·Wp, Cin): the output pixel of flat index r takes
    tap (i, j) from row r + i·Wp + j, so the sums run over every padded
    position and the (N, OH, OW) block is kept. Other strides copy each
    tap's strided slice into rows of its own."""
    (pt, pb), (pl, pr) = padding
    sh, sw = stride
    co, ci, kh, kw = kq.shape
    xp = F.pad(xq, (0, 0, pl, pr, pt, pb))
    n, hp, wp, _ = xp.shape
    oh, ow = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    taps = kq.permute(2, 3, 0, 1).contiguous()  # (kh, kw, co, ci)
    if (sh, sw) == (1, 1):
        flat = xp.reshape(n * hp * wp, ci)
        rows = n * hp * wp - (kh - 1) * wp - (kw - 1)
        acc = torch.zeros(n * hp * wp, co, dtype=torch.int32,
                          device=xq.device)
        for i in range(kh):
            for j in range(kw):
                off = i * wp + j
                acc[:rows] += _int_mm(flat[off:off + rows], taps[i, j])
        return acc.view(n, hp, wp, co)[:, :oh, :ow]
    acc = torch.zeros(n * oh * ow, co, dtype=torch.int32, device=xq.device)
    for i in range(kh):
        for j in range(kw):
            sl = xp[:, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sw + 1:sw]
            acc += _int_mm(sl.reshape(n * oh * ow, ci), taps[i, j])
    return acc.view(n, oh, ow, co)


def quant_conv2d(x: torch.Tensor, weight: torch.Tensor, *, stride=(1, 1),
                 padding=((0, 0), (0, 0)),
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """Dense conv of NHWC ``x`` and OIHW ``weight`` as s8×s8→s32 with an
    exact dequantize; the output has x's dtype. ``padding`` is
    ((top, bottom), (left, right)) of zeros."""
    xf = x.float()
    s_x = _per_127(xf.abs().amax())
    xq = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
    kq, s_w = quantize_kernel(weight)
    y = int_conv2d(xq, kq, tuple(stride), padding)
    out = y.float() * (s_x * s_w)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype).contiguous()
