"""Batched preprocessing with PIL semantics, on the device.

Counterpart of ``efficientdepthestimation_tpu/data/transforms.py``:

* eval and demo (reference loaddata.py:68-85, loaddata_demo.py:23-38):
  uint8 NHWC frames → PIL bilinear Scale(240) with uint8 rounding →
  CenterCrop 228×304 → ImageNet normalize, as f32 NHWC;
* train (loaddata.py:32-65): Scale(240) → RandomHorizontalFlip →
  RandomRotate(5°) as the JAX package's three-shear → CenterCrop (depth then
  bicubic to half the crop) → ToTensor (8-bit depth ×10/255 → metres) →
  Lighting(0.1, ImageNet PCA) → ColorJitter in random order → Normalize.
  The random draws are made apart from the math (``draw_augmentation``), so
  a test can hand both packages the same draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.ops.resize import (
    device_constant,
    pil_resize,
)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "IMAGENET_PCA_EIGVAL",
           "IMAGENET_PCA_EIGVEC", "normalize_imagenet",
           "scale_short_side_size", "center_crop_box", "scale_short_side",
           "center_crop", "eval_preprocess", "eval_preprocess_image_only",
           "demo_preprocess",
           "draw_augmentation", "train_preprocess"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# loaddata.py:33-40
IMAGENET_PCA_EIGVAL = (0.2175, 0.0188, 0.0045)
IMAGENET_PCA_EIGVEC = ((-0.5675, 0.7192, 0.4009),
                       (-0.5808, -0.0045, -0.8140),
                       (-0.5836, -0.6948, 0.4203))


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


def eval_preprocess(images_u8: torch.Tensor, depths_u16: torch.Tensor,
                    crop_hw: tuple[int, int] = (228, 304)
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Test-split preprocessing (reference loaddata.py:68-85), on the
    images' device.

    images_u8 (N, 480, 640, 3) uint8; depths_u16 (N, 480, 640[, 1]) 16-bit
    millimetres (uint16, or any integer dtype that holds them). Returns
    normalized f32 images (N, *crop_hw, 3) and f32 depths in metres
    (N, *crop_hw, 1): PIL-NEAREST Scale(240), the same center crop, ÷1000
    (nyu_transform.py:173) as XLA computes a division by a constant, a
    product with its f32 reciprocal, so the depths are the JAX package's
    bit for bit.
    """
    if depths_u16.dim() == 3:
        depths_u16 = depths_u16[..., None]
    depths = scale_short_side(depths_u16.float(), 240, "nearest", False)
    depths = center_crop(depths, *crop_hw) * (1.0 / 1000.0)
    return (eval_preprocess_image_only(images_u8, crop_hw),
            depths.contiguous())


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


def _fractional_shift(x: torch.Tensor, s: torch.Tensor, axis: int,
                      max_abs: float) -> torch.Tensor:
    """Per-line fractional translation along ``axis`` (1=y or 2=x), zero-fill.

    ``out[..., p] = in[..., p + s(line)]`` with linear interpolation in the
    fractional part of ``s`` (N, L), L the length of the other spatial axis:
    a static sum of rolled copies weighted per line, as the JAX package
    computes it. ``max_abs`` bounds |s| and fixes the taps.
    """
    size = x.shape[axis]
    k0 = torch.floor(s)
    if axis == 1:
        def expand(t):  # (N, W) -> per-column y-shift
            return t[:, None, :, None]
    else:
        def expand(t):  # (N, H) -> per-row x-shift
            return t[:, :, None, None]
    f = expand(s - k0)
    pos = torch.arange(size, device=x.device)
    taps = int(np.ceil(max_abs))
    out = torch.zeros_like(x)
    for k in range(-taps, taps + 1):
        # tap k samples in[p + k]: weight (1-f) when k == floor(s), f when
        # k == floor(s)+1; out-of-range source positions contribute zero.
        wk = (expand((k0 == k).float()) * (1.0 - f)
              + expand((k0 == k - 1).float()) * f)
        valid = (pos + k >= 0) & (pos + k < size)
        valid = (valid[None, :, None, None] if axis == 1
                 else valid[None, None, :, None])
        out = out + torch.roll(x, -k, axis) * torch.where(valid, wk, 0.0)
    return out


def _rotate_shear(x: torch.Tensor, angle_deg: torch.Tensor,
                  max_angle_deg: float = 5.0) -> torch.Tensor:
    """Rotate an NHWC batch about the image centre (per-sample angles) by
    the Paeth three-shear Sx(a)·Sy(b)·Sx(a), a = tan(θ/2), b = −sin(θ),
    zero-filled (the JAX package's ``_rotate_shear``, which stands in for
    the reference's scipy order-2 rotate)."""
    _, h, w, _ = x.shape
    theta = -angle_deg * math.pi / 180.0
    max_t = abs(max_angle_deg) * np.pi / 180.0
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yc = torch.arange(h, dtype=torch.float32, device=x.device) - cy
    xc = torch.arange(w, dtype=torch.float32, device=x.device) - cx
    a = torch.tan(theta / 2.0)[:, None]
    b = -torch.sin(theta)[:, None]
    max_a = np.tan(max_t / 2.0) * max(cy, h - 1 - cy)
    max_b = np.sin(max_t) * max(cx, w - 1 - cx)
    x = _fractional_shift(x, a * yc[None, :], axis=2, max_abs=max_a)
    x = _fractional_shift(x, b * xc[None, :], axis=1, max_abs=max_b)
    return _fractional_shift(x, a * yc[None, :], axis=2, max_abs=max_a)


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    """nyu_transform.py:242-249 luma weights, as 3 equal channels."""
    g = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return torch.stack([g, g, g], dim=-1)


def draw_augmentation(generator: torch.Generator,
                      n: int) -> dict[str, torch.Tensor]:
    """The random draws of ``train_preprocess`` for ``n`` samples, on the
    generator's device, with the JAX package's distributions
    (``transforms.py:275, 282, 297, 305-307, 319``): ``flip`` (N,) bool
    p=0.5; ``angles`` (N,) U(−5, 5) degrees; ``alpha`` (N, 3) N(0, 0.1²);
    ``order`` a permutation of the 3 jitters; ``a_b``, ``a_c``, ``a_s`` (N,)
    U(−0.4, 0.4)."""
    kw = dict(generator=generator, device=generator.device)
    return {
        "flip": torch.rand(n, **kw) < 0.5,
        "angles": torch.rand(n, **kw) * 10.0 - 5.0,
        "alpha": torch.randn(n, 3, **kw) * 0.1,
        "order": torch.randperm(3, **kw),
        "a_b": torch.rand(n, **kw) * 0.8 - 0.4,
        "a_c": torch.rand(n, **kw) * 0.8 - 0.4,
        "a_s": torch.rand(n, **kw) * 0.8 - 0.4,
    }


def train_preprocess(images_u8: torch.Tensor, depths_u8: torch.Tensor,
                     draws: dict[str, torch.Tensor],
                     crop_hw: tuple[int, int] = (228, 304),
                     depth_hw: tuple[int, int] | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Training preprocessing and augmentation, batched on the images'
    device (``efficientdepthestimation_tpu/data/transforms.py:253-327``).

    images_u8 (N, 480, 640, 3) uint8; depths_u8 (N, 480, 640[, 1]) uint8,
    stored ×25.5 per metre. ``draws`` from ``draw_augmentation``. Returns
    normalized f32 images (N, *crop_hw, 3) and f32 depths in metres
    (N, *depth_hw, 1); ``depth_hw`` defaults to half the crop.
    """
    if depth_hw is None:
        depth_hw = (crop_hw[0] // 2, crop_hw[1] // 2)
    if depths_u8.dim() == 3:
        depths_u8 = depths_u8[..., None]
    n = images_u8.shape[0]
    dev = images_u8.device
    draws = {k: v.to(dev) for k, v in draws.items() if k != "order"} | {
        "order": [int(i) for i in draws["order"]]}

    images = scale_short_side(images_u8.float(), 240, "bilinear", True)
    depths = scale_short_side(depths_u8.float(), 240, "nearest", False)

    flip = draws["flip"][:, None, None, None]
    images = torch.where(flip, images.flip(2), images)
    depths = torch.where(flip, depths.flip(2), depths)

    # One 4-channel rotate: image and depth share the shear weights.
    rotated = _rotate_shear(torch.cat([images, depths], dim=-1),
                            draws["angles"].float())
    images = torch.clamp(torch.round(rotated[..., :3]), 0, 255)
    depths = rotated[..., 3:]

    images = center_crop(images, *crop_hw)
    depths = center_crop(depths, *crop_hw)
    depths = pil_resize(depths, depth_hw, "bicubic")

    images = images / 255.0
    depths = depths / 255.0 * 10.0

    kw = dict(dtype=torch.float32, device=dev)
    eigvec = device_constant(_f32, IMAGENET_PCA_EIGVEC, **kw)
    eigval = device_constant(_f32, IMAGENET_PCA_EIGVAL, **kw)
    rgb = torch.sum(eigvec[None] * draws["alpha"][:, None, :]
                    * eigval[None, None, :], dim=-1)
    images = images + rgb[:, None, None, :]

    a_b, a_c, a_s = (draws[k].reshape(n, 1, 1, 1) for k in ("a_b", "a_c",
                                                          "a_s"))

    def brightness(img):
        return img * (1.0 - a_b)

    def contrast(img):
        gs_mean = _grayscale(img).mean(dim=(1, 2, 3), keepdim=True)
        return img + a_c * (gs_mean - img)

    def saturation(img):
        return img + a_s * (_grayscale(img) - img)

    jitters = (brightness, contrast, saturation)
    for i in draws["order"]:
        images = jitters[i](images)
    return normalize_imagenet(images).contiguous(), depths.contiguous()
