"""Fused Sobel + 4-term depth loss with its gradient, as a kernel pair.

Counterpart of ``efficientdepthestimation_tpu/ops/pallas/fused_loss.py``.
The pair is two registered ops, ``ede::fused_depth_loss_fwd`` (the four
loss terms reduced to per-image sums) and ``ede::fused_depth_loss_bwd``
(dL/dpred in one pass). Their CUDA implementations launch the
hand-written kernels of ``csrc/fused_depth_loss.cu``, one device operation
a call with no scratch memory (the kernels' source picks the launch shape;
``launch_config`` asks it once a shape); their CPU implementations are the
plain PyTorch versions ``fused_depth_loss_fwd_plain`` and
``fused_depth_loss_bwd_plain``. PyTorch's dispatcher picks one by the
tensors' device, and neither falls back to the other.

``fused_depth_loss`` calls a third op, ``ede::fused_depth_loss``: the
forward op, then the masked mean in PyTorch, with an autograd formula
(``register_autograd``) that launches the backward op. The loss, not the
sums, carries the formula: the backward kernel computes the gradient of
the four terms weighted alike, which is the loss's gradient but not that of
an arbitrary function of the sums.
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


@torch.library.custom_op("ede::fused_depth_loss_fwd", mutates_args=(),
                         device_types="cuda")
def _fwd_op(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The forward op's CUDA implementation: one launch of the kernel."""
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


@_fwd_op.register_kernel("cpu")
def _fwd_cpu(pred, target):
    return fused_depth_loss_fwd_plain(pred, target)


@_fwd_op.register_fake
def _fwd_fake(pred, target):
    return pred.new_empty((pred.shape[0], 4), dtype=torch.float32)


@torch.library.custom_op("ede::fused_depth_loss_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd_op(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
            coef: torch.Tensor) -> torch.Tensor:
    """The backward op's CUDA implementation: one launch of the kernel."""
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


@_bwd_op.register_kernel("cpu")
def _bwd_cpu(pred, target, mask, coef):
    return fused_depth_loss_bwd_plain(pred, target, mask, coef)


@_bwd_op.register_fake
def _bwd_fake(pred, target, mask, coef):
    return torch.empty_like(pred)


def fused_depth_loss_fwd(pred: torch.Tensor,
                         target: torch.Tensor) -> torch.Tensor:
    """Per-image loss sums (N, 4) f32: (log-L1 depth, dx, dy, normal).

    pred (N, H, W) f32 or bf16, target (N, H, W) f32. ``launches`` counts
    the kernel's launches (CPU calls do not count).
    """
    build.check_device("fused_depth_loss_fwd", pred.device)
    return _fwd_op(pred, target)


def fused_depth_loss_bwd(pred: torch.Tensor, target: torch.Tensor,
                         mask: torch.Tensor,
                         coef: torch.Tensor) -> torch.Tensor:
    """dL/dpred (N, H, W) in pred's dtype.

    mask (N,) f32 per-image weights; coef (1,) f32, the upstream gradient
    over Σmask·H·W, read by the kernel from device memory (no host sync).
    ``launches`` counts the kernel's launches (CPU calls do not count).
    """
    build.check_device("fused_depth_loss_bwd", pred.device)
    return _bwd_op(pred, target, mask, coef)


fused_depth_loss_fwd.launches = 0
fused_depth_loss_bwd.launches = 0


def masked_total(sums: torch.Tensor, mask: torch.Tensor, hw: int,
                 denominator=None) -> torch.Tensor:
    """The loss from per-image sums: each term's mean over the valid
    images' pixels, then depth + normal + dx + dy (``fused_loss.py:111-115``,
    reference train.py:236). ``denominator`` (an int) replaces the valid
    count ``mask.sum()`` in the mean: a data-parallel rank passes the global
    batch's, so that the ranks' losses sum to the global mean (JAX's under
    SPMD) and a rank of padding alone gives 0."""
    per_term = (sums * mask[:, None]).sum(dim=0) / (
        _count(mask, denominator) * hw)
    return per_term[0] + per_term[3] + per_term[1] + per_term[2]


def _count(mask: torch.Tensor, denominator) -> torch.Tensor:
    """The mean's valid count as a 0-d tensor on the mask's device, so that
    the mean is a division by a tensor whichever count it is (on CUDA a
    division by a host scalar is a product with its reciprocal, which may
    differ in the last bit)."""
    return (mask.sum() if denominator is None
            else mask.new_full((), float(denominator)))


@torch.library.custom_op("ede::fused_depth_loss", mutates_args=())
def _loss_op(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
             denominator: float | None) -> torch.Tensor:
    """The loss of (N, H, W) pred and f32 target from the forward op's
    sums, on every device: the sums' op dispatches by device."""
    return masked_total(fused_depth_loss_fwd(pred, target), mask,
                        pred.shape[1] * pred.shape[2], denominator)


@_loss_op.register_fake
def _loss_fake(pred, target, mask, denominator):
    return pred.new_empty((), dtype=torch.float32)


def _loss_setup_context(ctx, inputs, output):
    pred, target, mask, denominator = inputs
    ctx.save_for_backward(pred, target, mask)
    ctx.denominator = denominator


def _loss_backward(ctx, g):
    p, t, mask = ctx.saved_tensors
    coef = (g.float() / (_count(mask, ctx.denominator)
                         * (p.shape[1] * p.shape[2])))
    return fused_depth_loss_bwd(p, t, mask, coef.reshape(1)), None, None, None


_loss_op.register_autograd(_loss_backward, setup_context=_loss_setup_context)


def fused_depth_loss(pred: torch.Tensor, target: torch.Tensor,
                     num_valid=None, denominator=None) -> torch.Tensor:
    """The 4-term loss over NHWC (N, H, W, 1) or (N, H, W) pred/target,
    differentiable in pred. ``num_valid`` (None, an int or a 0-d tensor):
    only the first ``num_valid`` images count, and the mean is
    Σ valid / (num_valid·H·W). A data-parallel rank passes its share of the
    valid rows as ``num_valid`` and the global batch's valid count as
    ``denominator``, which then replaces ``num_valid`` in the mean; with
    ``denominator=None`` nothing changes."""
    mask = sample_mask(pred.shape[0], num_valid, pred.device)
    p = _image_stack(pred).contiguous()
    t = _image_stack(target).float().contiguous()
    return _loss_op(p, t, mask,
                    None if denominator is None else float(denominator))
