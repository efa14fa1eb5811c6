"""Batched eval preprocessing with PIL semantics, on the device.

Counterpart of the eval and demo pipelines of
``efficientdepthestimation_tpu/data/transforms.py`` (reference
loaddata.py:68-85, loaddata_demo.py:23-38): uint8 NHWC frames → PIL
bilinear Scale(240) with uint8 rounding → CenterCrop 228×304 → ImageNet
normalize, as f32 NHWC.
"""

from __future__ import annotations

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.ops.resize import (
    device_constant,
    pil_resize,
)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "normalize_imagenet",
           "scale_short_side_size", "center_crop_box", "scale_short_side",
           "center_crop", "eval_preprocess_image_only", "demo_preprocess"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _f32(values: tuple[float, ...]) -> np.ndarray:
    return np.array(values, np.float32)


def normalize_imagenet(images: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std on [0,1] NHWC images."""
    kw = dict(dtype=images.dtype, device=images.device)
    return ((images - device_constant(_f32, IMAGENET_MEAN, **kw))
            / device_constant(_f32, IMAGENET_STD, **kw))


def scale_short_side_size(h: int, w: int, size: int) -> tuple[int, int]:
    """PIL Scale(size) output dims (nyu_transform.py:105-116)."""
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        return int(size * h / w), size
    return size, int(size * w / h)


def center_crop_box(h: int, w: int, th: int, tw: int) -> tuple[int, int]:
    """Top-left corner of a PIL-arithmetic center crop (nyu_transform.py:146)."""
    return int(round((h - th) / 2.0)), int(round((w - tw) / 2.0))


def scale_short_side(x: torch.Tensor, size: int, filter: str,
                     quantize_uint8: bool) -> torch.Tensor:
    _, h, w, _ = x.shape
    return pil_resize(x, scale_short_side_size(h, w, size), filter,
                      quantize_uint8=quantize_uint8)


def center_crop(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    _, h, w, _ = x.shape
    if (h, w) == (th, tw):
        return x
    y1, x1 = center_crop_box(h, w, th, tw)
    return x[:, y1:y1 + th, x1:x1 + tw, :]


def eval_preprocess_image_only(images_u8: torch.Tensor,
                               crop_hw: tuple[int, int] = (228, 304)
                               ) -> torch.Tensor:
    """Image half of the eval pipeline: uint8 (N,H,W,3) → f32 (N,228,304,3)."""
    images = scale_short_side(images_u8.float(), 240, "bilinear", True)
    images = center_crop(images, *crop_hw)
    return normalize_imagenet(images / 255.0).contiguous()


def demo_preprocess(images_u8: torch.Tensor,
                    crop_hw: tuple[int, int] = (228, 304),
                    scale_wh: tuple[int, int] = (320, 240)) -> torch.Tensor:
    """Single-image/demo pipeline: fixed-size scale, crop, normalize."""
    w, h = scale_wh
    images = pil_resize(images_u8.float(), (h, w), "bilinear",
                        quantize_uint8=True)
    images = center_crop(images, *crop_hw)
    return normalize_imagenet(images / 255.0).contiguous()
