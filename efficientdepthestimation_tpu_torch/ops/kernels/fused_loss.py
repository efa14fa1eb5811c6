"""Fused Sobel + 4-term depth loss with its gradient, as a kernel pair.

Counterpart of ``efficientdepthestimation_tpu/ops/pallas/fused_loss.py``.
``fused_depth_loss`` is a ``torch.autograd.Function``: its forward reduces
the four loss terms to per-image sums (``fused_depth_loss_fwd``) and takes
the masked mean in PyTorch; its backward writes dL/dpred in one pass
(``fused_depth_loss_bwd``). On CUDA tensors both launch the hand-written
kernels of ``csrc/fused_depth_loss.cu``, one device operation a call with
no scratch memory; the kernels' source picks the launch shape
(``launch_config`` asks it once a shape). On CPU tensors they run the
plain PyTorch versions ``fused_depth_loss_fwd_plain`` and
``fused_depth_loss_bwd_plain``. Neither ever falls back to the other.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from efficientdepthestimation_tpu_torch.ops.kernels import build
from efficientdepthestimation_tpu_torch.ops.resize import device_constant
from efficientdepthestimation_tpu_torch.ops.sobel import (
    SOBEL_KX,
    SOBEL_KY,
    sobel_gradients,
)
from efficientdepthestimation_tpu_torch.training.loss import (
    depth_loss_maps,
    sample_mask,
)

__all__ = ["fused_depth_loss", "fused_depth_loss_fwd",
           "fused_depth_loss_fwd_plain", "fused_depth_loss_bwd",
           "fused_depth_loss_bwd_plain", "masked_total"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CUDA_INVALID_VALUE = 1


def _image_stack(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 1) or (N, H, W) → (N, H, W)."""
    if x.dim() == 4 and x.shape[-1] == 1:
        return x.reshape(x.shape[:3])
    if x.dim() != 3:
        raise ValueError(f"fused_depth_loss: expected (N,H,W[,1]), got "
                         f"{tuple(x.shape)}")
    return x


def fused_depth_loss_fwd_plain(pred: torch.Tensor,
                               target: torch.Tensor) -> torch.Tensor:
    """Per-image sums (N, 4) f32 of (log-L1 depth, dx, dy, normal) for
    (N, H, W) pred and target: ``training.loss.depth_loss_maps`` summed
    over each image."""
    maps = depth_loss_maps(pred[..., None], target[..., None])
    return torch.cat(maps, dim=-1).sum(dim=(1, 2))


def _flipped_sobel_oihw() -> np.ndarray:
    """Both Sobel kernels rotated by 180°, as one 2-in 2-out grouped conv."""
    return np.stack([SOBEL_KX[::-1, ::-1], SOBEL_KY[::-1, ::-1]])[:, None]


def fused_depth_loss_bwd_plain(pred: torch.Tensor, target: torch.Tensor,
                               mask: torch.Tensor,
                               coef: torch.Tensor) -> torch.Tensor:
    """dL/dpred (N, H, W) in pred's dtype, the formula of the JAX VJP
    (``fused_loss.py:146-189``): ``coef`` is the upstream gradient over
    Σmask·H·W, ``mask`` (N,) the per-image weights."""
    p = pred.float()[..., None]
    t = target.float()[..., None]
    gx_o, gy_o = sobel_gradients(p)
    gx_d, gy_d = sobel_gradients(t)
    diff = p - t
    d_depth = torch.sign(diff) / (torch.abs(diff) + 0.5)
    ddx = torch.sign(gx_o - gx_d) / (torch.abs(gx_o - gx_d) + 0.5)
    ddy = torch.sign(gy_o - gy_d) / (torch.abs(gy_o - gy_d) + 0.5)
    dot = gx_o * gx_d + gy_o * gy_d + 1.0
    no2 = gx_o.square() + gy_o.square() + 1.0
    no = torch.sqrt(no2)
    nd = torch.sqrt(gx_d.square() + gy_d.square() + 1.0)
    c = dot / (no * nd)
    s = -torch.sign(1.0 - c)  # d|1-c|/dc
    a = ddx + s * (gx_d / (no * nd) - c * gx_o / no2)
    b = ddy + s * (gy_d / (no * nd) - c * gy_o / no2)
    k = device_constant(_flipped_sobel_oihw, dtype=torch.float32,
                        device=pred.device)
    ab = torch.cat([a, b], dim=-1).permute(0, 3, 1, 2)
    g = F.conv2d(ab, k, padding=1, groups=2).sum(dim=1)
    dp = (d_depth[..., 0] + g) * mask.float()[:, None, None] * coef.float()
    return dp.to(pred.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("fused_depth_loss")
    lib.ede_fused_depth_loss_config.argtypes = (
        [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])
    lib.ede_fused_depth_loss_config.restype = ctypes.c_int
    lib.ede_fused_depth_loss_fwd.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
        + [ctypes.c_void_p])
    lib.ede_fused_depth_loss_fwd.restype = ctypes.c_int
    lib.ede_fused_depth_loss_bwd.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
        + [ctypes.c_void_p])
    lib.ede_fused_depth_loss_bwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def launch_config(backward: bool, dtype: torch.dtype, vec: bool, n: int,
                  h: int, w: int, device: int) -> tuple[int, ...]:
    """(cluster, band, strips, rows, threads, smem) of a kernel of the pair
    for an (n, h, w) call on card ``device``, as the kernel's source picks
    it (``choose_config`` in csrc/fused_depth_loss.cu), once a shape.
    ``cluster`` is the blocks an image, a thread-block cluster in the
    forward. A ValueError for w above 2048, which the kernels refuse."""
    out = (ctypes.c_int * 6)()
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.ede_fused_depth_loss_config(int(backward), _DTYPES[dtype],
                                              int(vec), n, h, w, out)
    if err == _CUDA_INVALID_VALUE:
        raise ValueError(f"fused_depth_loss: unsupported shape ({n},{h},{w}) "
                         "(W at most 2048)")
    build.check(lib, err, "fused_depth_loss config")
    return tuple(out)


def vector_path(*tensors: torch.Tensor) -> bool:
    """Whether the kernels take 16-byte loads and stores for these (N, H, W)
    tensors: W a multiple of 8 and every pointer 16-byte aligned; else they
    take the scalar path."""
    return tensors[0].shape[-1] % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)


def _check_pair(name: str, pred: torch.Tensor, target: torch.Tensor) -> None:
    if pred.dtype not in _DTYPES or target.dtype != torch.float32:
        raise TypeError(f"{name}: pred must be f32 or bf16 and target f32, "
                        f"got {pred.dtype}, {target.dtype}")
    if pred.dim() != 3 or pred.shape != target.shape:
        raise ValueError(f"{name}: pred and target must both be (N,H,W), "
                         f"got {tuple(pred.shape)}, {tuple(target.shape)}")
    if min(pred.shape) <= 0 or pred.shape[0] > 65535:
        raise ValueError(f"{name}: unsupported shape {tuple(pred.shape)}")
    if target.device != pred.device:
        raise ValueError(f"{name}: target must be on {pred.device}")
    if not (pred.is_contiguous() and target.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")


def fused_depth_loss_fwd(pred: torch.Tensor,
                         target: torch.Tensor) -> torch.Tensor:
    """Per-image loss sums (N, 4) f32: (log-L1 depth, dx, dy, normal).

    pred (N, H, W) f32 or bf16, target (N, H, W) f32.
    """
    if pred.device.type == "cpu":
        return fused_depth_loss_fwd_plain(pred, target)
    if pred.device.type != "cuda":
        raise ValueError(f"fused_depth_loss_fwd: unsupported device "
                         f"{pred.device}")
    _check_pair("fused_depth_loss_fwd", pred, target)
    n, h, w = pred.shape
    vec = vector_path(pred, target)
    config = launch_config(False, pred.dtype, vec, n, h, w, pred.device.index)
    sums = torch.empty((n, 4), dtype=torch.float32, device=pred.device)
    lib = _lib()
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ede_fused_depth_loss_fwd(
            _DTYPES[pred.dtype], int(vec), pred.data_ptr(), target.data_ptr(),
            sums.data_ptr(), n, h, w, *config, stream)
    build.check(lib, err, "fused_depth_loss_fwd")
    fused_depth_loss_fwd.launches += 1
    return sums


def fused_depth_loss_bwd(pred: torch.Tensor, target: torch.Tensor,
                         mask: torch.Tensor,
                         coef: torch.Tensor) -> torch.Tensor:
    """dL/dpred (N, H, W) in pred's dtype.

    mask (N,) f32 per-image weights; coef (1,) f32, the upstream gradient
    over Σmask·H·W, read by the kernel from device memory (no host sync).
    """
    if pred.device.type == "cpu":
        return fused_depth_loss_bwd_plain(pred, target, mask, coef)
    if pred.device.type != "cuda":
        raise ValueError(f"fused_depth_loss_bwd: unsupported device "
                         f"{pred.device}")
    _check_pair("fused_depth_loss_bwd", pred, target)
    n, h, w = pred.shape
    if mask.dtype != torch.float32 or coef.dtype != torch.float32 \
            or mask.shape != (n,) or coef.numel() != 1:
        raise ValueError("fused_depth_loss_bwd: mask must be (N,) f32 and "
                         "coef one f32")
    for t in (mask, coef):
        if t.device != pred.device or not t.is_contiguous():
            raise ValueError("fused_depth_loss_bwd: mask and coef must be "
                             f"contiguous on {pred.device}")
    dp = torch.empty_like(pred)
    vec = vector_path(pred, target, dp)
    config = launch_config(True, pred.dtype, vec, n, h, w, pred.device.index)
    lib = _lib()
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ede_fused_depth_loss_bwd(
            _DTYPES[pred.dtype], int(vec), pred.data_ptr(), target.data_ptr(),
            mask.data_ptr(), coef.data_ptr(), dp.data_ptr(), n, h, w,
            *config, stream)
    build.check(lib, err, "fused_depth_loss_bwd")
    fused_depth_loss_bwd.launches += 1
    return dp


fused_depth_loss_fwd.launches = 0
fused_depth_loss_bwd.launches = 0


def masked_total(sums: torch.Tensor, mask: torch.Tensor, hw: int
                 ) -> torch.Tensor:
    """The loss from per-image sums: each term's mean over the valid
    images' pixels, then depth + normal + dx + dy (``fused_loss.py:111-115``,
    reference train.py:236)."""
    per_term = (sums * mask[:, None]).sum(dim=0) / (mask.sum() * hw)
    return per_term[0] + per_term[3] + per_term[1] + per_term[2]


class _FusedDepthLoss(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pred, target, mask):
        p, t = _image_stack(pred).contiguous(), _image_stack(target)
        t = t.float().contiguous()
        ctx.save_for_backward(p, t, mask)
        ctx.pred_shape = pred.shape
        return masked_total(fused_depth_loss_fwd(p, t), mask,
                            p.shape[1] * p.shape[2])

    @staticmethod
    def backward(ctx, g):
        p, t, mask = ctx.saved_tensors
        coef = (g.float() / (mask.sum() * (p.shape[1] * p.shape[2])))
        dp = fused_depth_loss_bwd(p, t, mask, coef.reshape(1))
        return dp.reshape(ctx.pred_shape), None, None


def fused_depth_loss(pred: torch.Tensor, target: torch.Tensor,
                     num_valid=None) -> torch.Tensor:
    """The 4-term loss over NHWC (N, H, W, 1) or (N, H, W) pred/target,
    differentiable in pred. ``num_valid`` (None, an int or a 0-d tensor):
    only the first ``num_valid`` images count, and the mean is
    Σ valid / (num_valid·H·W)."""
    mask = sample_mask(pred.shape[0], num_valid, pred.device)
    return _FusedDepthLoss.apply(pred, target, mask)
