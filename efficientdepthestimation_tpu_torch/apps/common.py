"""Checkpoint loading and the serving forward of the port.

Counterpart of ``efficientdepthestimation_tpu/apps/common.py``. This slice
ports the monolithic path: uint8 frames → PIL-parity preprocess → model in
the serving dtype → f32 depth, optionally upsampled (align corners) to the
frame size. Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
    MAGIC,
    load_checkpoint,
)
from efficientdepthestimation_tpu_torch.data.transforms import (
    eval_preprocess_image_only,
)
from efficientdepthestimation_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
)

__all__ = ["resolve_device", "load_any_checkpoint", "make_infer_fn",
           "make_serving_fn"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, which must then be present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    return device


def load_any_checkpoint(path: str, *, device=None) -> nn.Module:
    """The model of a native ``.ede`` checkpoint, a Hu2018 state or a
    self-describing MidasNet, on ``device``, eval."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic != MAGIC:
        raise NotImplementedError(
            "only native .ede checkpoints are ported; .pth import is "
            "ROADMAP item A8")
    model, _ = load_checkpoint(path)
    return model.to(device)


def make_infer_fn(model: nn.Module, *, upsample_to=None, dtype=None,
                  preprocess: bool = False, device=None):
    """Forward on a copy of ``model`` cast to ``dtype`` on ``device``.

    The returned fn takes NHWC images on any device: normalized f32 images,
    or with ``preprocess=True`` raw uint8 frames, which go through
    ``eval_preprocess_image_only`` first. It returns f32 NHWC depth,
    upsampled to ``upsample_to`` (H, W) when given. As in the JAX package,
    ``dtype`` casts every floating-point weight, bias and statistic.
    """
    device = resolve_device(device)
    model = copy.deepcopy(model).to(device).eval()
    if dtype is not None:
        model = model.to(dtype)

    @torch.inference_mode()
    def infer(images) -> torch.Tensor:
        images = torch.as_tensor(images).to(device)
        if preprocess:
            images = eval_preprocess_image_only(images)
        if dtype is not None:
            images = images.to(dtype)
        out = model(images).float()
        if upsample_to is not None:
            out = resize_bilinear_align_corners(out, upsample_to)
        return out

    return infer


def make_serving_fn(model: nn.Module, *, upsample_to=(480, 640),
                    dtype=torch.bfloat16, preprocess: bool = True,
                    device=None):
    """The serving pipeline every app routes through: uint8 frames in, f32
    depth at frame size out, bf16 in between. The JAX package chooses
    among staged, tiled and int8 forms here; the port has the monolithic
    form only (ROADMAP A13)."""
    return make_infer_fn(model, upsample_to=upsample_to, dtype=dtype,
                         preprocess=preprocess, device=device)
