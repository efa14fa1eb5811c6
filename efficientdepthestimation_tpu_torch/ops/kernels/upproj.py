"""Direct-path UpProjection: conv5×5 ∘ align-corners upsample in one kernel.

Counterpart of ``efficientdepthestimation_tpu/ops/pallas/upproj.py``.
``upsample_conv`` launches the hand-written CUDA kernel in
``csrc/upsample_conv.cu`` on CUDA tensors (bf16 on the tensor cores, with
the output tile from ``mma_tile``; f32 on the CUDA cores); the upsampled
intermediate never reaches device memory. On CPU tensors it runs the plain
PyTorch version ``upsample_conv_plain``; it never falls back from one to
the other. It is a
``torch.autograd.Function`` whose backward is ``upsample_conv_vjp``, the VJP
of the plain composition ``conv2d(resize(x), K)`` in x's dtype, as JAX's
``_bwd`` takes it (``upproj.py:197-200``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from efficientdepthestimation_tpu_torch.ops.kernels import build
from efficientdepthestimation_tpu_torch.ops.resize import (
    bilinear_align_corners_matrix,
    device_constant,
    resize_bilinear_align_corners,
)

__all__ = ["upsample_conv", "upsample_conv_plain", "upsample_conv_vjp",
           "mma_tile"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TAPS = 5


@functools.lru_cache(maxsize=None)
def mma_tile(h: int, w: int, c: int, o: int) -> tuple[int, int]:
    """(th, tw): the bf16 kernel's output tile for an (h, w) output, as the
    kernel's source picks it (``choose_tile`` in csrc/upsample_conv.cu),
    once a shape."""
    tile = (ctypes.c_int * 2)()
    if _lib().ede_upsample_conv_tile(h, w, c, o, tile):
        raise ValueError(f"upsample_conv: no tile fits C={c}, O={o}")
    return tile[0], tile[1]


def upsample_conv_plain(x: torch.Tensor, kernels: torch.Tensor,
                        size: tuple[int, int]) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the upsample in f32 rounded
    once to x's dtype, then the conv in f32, then the cast."""
    up = resize_bilinear_align_corners(x.float(), size).to(x.dtype).float()
    w = kernels.float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(up.permute(0, 3, 1, 2), w, padding=kernels.shape[0] // 2)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("upsample_conv")
    fn = lib.ede_upsample_conv
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ede_upsample_conv_tile.argtypes = ([ctypes.c_int] * 4
                                           + [ctypes.POINTER(ctypes.c_int)])
    lib.ede_upsample_conv_tile.restype = ctypes.c_int
    return lib


def upsample_conv_vjp(x: torch.Tensor, kernels: torch.Tensor,
                      size: tuple[int, int], g: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dkernels) of ``conv2d(resize_bilinear_align_corners(x, size),
    kernels, pad=2)`` for the cotangent ``g`` (N, H, W, O), in x's dtype:
    the conv's input and weight gradients, then the transposed resize."""
    up = resize_bilinear_align_corners(x, size).permute(0, 3, 1, 2)
    w = kernels.to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    g = g.to(x.dtype).permute(0, 3, 1, 2)
    pad = kernels.shape[0] // 2
    d_up = torch.nn.grad.conv2d_input(up.shape, w, g, padding=pad)
    d_w = torch.nn.grad.conv2d_weight(up, w.shape, g, padding=pad)
    d_up = d_up.permute(0, 2, 3, 1)
    _, hs, ws, _ = x.shape
    h, w_out = int(size[0]), int(size[1])
    if (hs, ws) != (h, w_out):
        kw = dict(dtype=x.dtype, device=x.device)
        a = device_constant(bilinear_align_corners_matrix, hs, h, **kw)
        b = device_constant(bilinear_align_corners_matrix, ws, w_out, **kw)
        d_up = torch.einsum("Ww,nhWc->nhwc", b,
                            torch.einsum("Hh,nHwc->nhwc", a, d_up))
    return (d_up.contiguous(),
            d_w.permute(2, 3, 1, 0).to(kernels.dtype).contiguous())


def _forward(x: torch.Tensor, kernels: torch.Tensor,
             size: tuple[int, int]) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return upsample_conv_plain(x, kernels, size)
    if x.device.type != "cuda":
        raise ValueError(f"upsample_conv: unsupported device {x.device}")
    if x.dtype not in _DTYPES or kernels.dtype != x.dtype:
        raise TypeError("upsample_conv: x must be f32 or bf16 and kernels "
                        f"of the same dtype, got {x.dtype}, {kernels.dtype}")
    if x.dim() != 4 or kernels.dim() != 4:
        raise ValueError("upsample_conv: x must be (N,hs,ws,C) and kernels "
                         "(5,5,C,O)")
    n, hs, ws, c = x.shape
    o = kernels.shape[-1]
    if tuple(kernels.shape[:3]) != (_TAPS, _TAPS, c):
        raise ValueError(f"upsample_conv: kernels {tuple(kernels.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    if kernels.device != x.device:
        raise ValueError(f"upsample_conv: kernels must be on {x.device}")
    if not (x.is_contiguous() and kernels.is_contiguous()):
        raise ValueError("upsample_conv: tensors must be contiguous")
    h, w = int(size[0]), int(size[1])
    if min(n, c, o, h, w) <= 0:
        raise ValueError(f"upsample_conv: empty shape x {tuple(x.shape)}, "
                         f"size {(h, w)}")
    th, tw = mma_tile(h, w, c, o) if x.dtype == torch.bfloat16 else (0, 0)
    y = torch.empty((n, h, w, o), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ede_upsample_conv(_DTYPES[x.dtype], x.data_ptr(),
                                    kernels.data_ptr(), y.data_ptr(),
                                    n, hs, ws, c, h, w, o, th, tw, stream)
    build.check(lib, err, "upsample_conv")
    upsample_conv.launches += 1
    return y


class _UpsampleConv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, kernels, size):
        ctx.save_for_backward(x, kernels)
        ctx.size = size
        return _forward(x, kernels, size)

    @staticmethod
    def backward(ctx, g):
        x, kernels = ctx.saved_tensors
        dx, dk = upsample_conv_vjp(x, kernels, ctx.size, g)
        return dx, dk, None


def upsample_conv(x: torch.Tensor, kernels: torch.Tensor,
                  size: tuple[int, int]) -> torch.Tensor:
    """``conv2d(resize_bilinear_align_corners(x, size), kernels, pad=2)``.

    x: (N, hs, ws, C) bf16 or f32; kernels: HWIO (5, 5, C, O) in x's dtype,
    both UpProjection branches stacked on O. Returns (N, H, W, O) in x's
    dtype, summed in f32. Differentiable in x and kernels.
    """
    return _UpsampleConv.apply(x, kernels, (int(size[0]), int(size[1])))


upsample_conv.launches = 0
