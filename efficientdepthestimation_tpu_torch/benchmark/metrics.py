"""Visual quality metrics: SSIM, PSNR, LPIPS (AlexNet) in torch, MIFD (cv2).

Counterpart of ``efficientdepthestimation_tpu/benchmark/metrics.py``
(Benchmark/benchmark.py:32-154 and 1381-1506). SSIM uses the scipy-style
truncated Gaussian window (11×11, σ=1.5) as a depthwise conv; PSNR asserts
[0,1] inputs; MIFD is SIFT+ratio-test mean reprojection distance on the host
(not a tensor op); LPIPS is the AlexNet variant, which loads converted
official weights when available (they cannot be redistributed/downloaded
here), otherwise the tracker records NaN, which the running averages ignore.
SSIM, PSNR and LPIPS run on the device of their inputs; the tracker's on its
``device``, the CUDA card unless the caller asks for the CPU.
"""

from __future__ import annotations

import functools
import os
import warnings

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.apps.common import resolve_device
from efficientdepthestimation_tpu_torch.ops.conv import conv2d, max_pool
from efficientdepthestimation_tpu_torch.ops.resize import device_constant
from efficientdepthestimation_tpu_torch.training.metrics import AverageMeter

__all__ = ["gaussian_kernel_1d", "ssim", "psnr", "mifd", "lpips_alex",
           "load_lpips_weights", "VisualMetricsTracker"]


def gaussian_kernel_1d(window_size: int, sigma: float) -> np.ndarray:
    radius = window_size // 2
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / sigma ** 2 * x ** 2)
    return (phi / phi.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_oihw(kernel_size: int, channels: int) -> np.ndarray:
    k1 = gaussian_kernel_1d(kernel_size, 1.5)[:, None]
    k2 = k1 @ k1.T
    # depthwise OIHW: (C, 1, k, k)
    return np.repeat(k2[None, None], channels, axis=0).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor, kernel_size: int = 11,
         return_batch_average: bool = True) -> torch.Tensor:
    """SSIM over NHWC images (C1=0.01², C2=0.03², zero-padded window)."""
    c = img1.shape[-1]
    kernel = device_constant(_gaussian_kernel_oihw, kernel_size, c,
                             dtype=img1.dtype, device=img1.device)
    pad = kernel_size // 2

    def blur(x):
        return conv2d(x, kernel, stride=1, padding=pad, groups=c)

    mu_x, mu_y = blur(img1), blur(img2)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    var_x = blur(img1 * img1) - mu_x2
    var_y = blur(img2 * img2) - mu_y2
    covar = blur(img1 * img2) - mu_xy
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu_xy + c1) * (2 * covar + c2)) / (
        (mu_x2 + mu_y2 + c1) * (var_x + var_y + c2))
    if return_batch_average:
        return torch.mean(ssim_map)
    return torch.mean(ssim_map, dim=(1, 2, 3))


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         return_batch_average: bool = True) -> torch.Tensor:
    """PSNR with the reference's strict shape/range contract (NHWC here)."""
    assert img1.dim() == 4 and img1.shape == img2.shape, (img1.shape, img2.shape)
    assert img1.dtype == img2.dtype and img1.dtype != torch.uint8
    mse = torch.mean(torch.square(img1 - img2), dim=(1, 2, 3))
    x = 10.0 * torch.log10(1.0 / mse)
    return torch.mean(x) if return_batch_average else x


def mifd(label_rgb: np.ndarray, output_rgb: np.ndarray,
         ratio_threshold: float = 0.7, k: int = 2, min_matches: int = 1) -> float:
    """Mean Image Feature Distance: SIFT keypoints + FLANN kNN + Lowe ratio
    → mean L2 reprojection residual (benchmark.py:1407-1450). Host-side cv2."""
    import cv2

    def to_u8_gray(img):
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        return cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)

    img1, img2 = to_u8_gray(label_rgb), to_u8_gray(output_rgb)
    detector = cv2.SIFT_create()
    kp1, des1 = detector.detectAndCompute(img1, None)
    kp2, des2 = detector.detectAndCompute(img2, None)
    if des1 is None or des2 is None:
        warnings.warn("Could not extract any features for at least one image in the pair.")
        return float("nan")
    if len(des1) < k or len(des2) < k:
        warnings.warn(f"Not enough descriptors for k={k:d}.")
        return float("nan")
    matcher = cv2.DescriptorMatcher_create(cv2.DescriptorMatcher_FLANNBASED)
    knn = matcher.knnMatch(des1, des2, k)
    pts1, pts2 = [], []
    for pair in knn:
        if len(pair) < 2:
            continue
        m, n = pair[0], pair[1]
        if m.distance < ratio_threshold * n.distance:
            pts1.append(kp1[m.queryIdx].pt)
            pts2.append(kp2[m.trainIdx].pt)
    if len(pts1) < min_matches:
        warnings.warn(f"Not enough matches for min_matches={min_matches}.")
        return float("nan")
    residuals = np.asarray(pts1) - np.asarray(pts2)
    return float(np.mean(np.sqrt(np.sum(np.square(residuals), axis=1))))


# ---------------------------------------------------------------------------
# LPIPS (AlexNet)
# ---------------------------------------------------------------------------

_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)

# AlexNet feature config: (out_ch, kernel, stride, pad, maxpool_before)
_ALEX_LAYERS = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]


def lpips_alex(img1: torch.Tensor, img2: torch.Tensor,
               weights: dict) -> torch.Tensor:
    """LPIPS(net='alex') forward for NHWC images in [-1, 1].

    ``weights``: {'conv{i}': {'kernel' (OIHW), 'bias'}, 'lin{i}': (1, C,
    1, 1)} on the images' device (``load_lpips_weights``). Returns the
    distance of each image pair.
    """
    kw = dict(dtype=img1.dtype, device=img1.device)
    shift = device_constant(np.float32, _LPIPS_SHIFT, **kw)
    scale = device_constant(np.float32, _LPIPS_SCALE, **kw)

    def features(x):
        x = (x - shift) / scale
        feats = []
        for i, (_, _, s, p, pool) in enumerate(_ALEX_LAYERS):
            if pool:
                x = max_pool(x, 3, 2, padding=0)
            w = weights[f"conv{i}"]
            x = torch.relu(conv2d(x, w["kernel"], stride=s, padding=p,
                                  bias=w["bias"]))
            feats.append(x)
        return feats

    def unit_normalize(x):
        norm = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True)) + 1e-10
        return x / norm

    total = 0.0
    for i, (a, b) in enumerate(zip(features(img1), features(img2))):
        diff = torch.square(unit_normalize(a) - unit_normalize(b))
        total = total + torch.mean(conv2d(diff, weights[f"lin{i}"]),
                                   dim=(1, 2, 3))
    return total


def load_lpips_weights(path: str | None = None, device=None):
    """Converted LPIPS-AlexNet weights (the ``.npz`` of
    ``checkpoints.lpips_convert``, HWIO, the file both packages read) on
    ``device`` (default: the CPU) as OIHW tensors, if the file exists; else
    None."""
    path = path or os.environ.get("LPIPS_ALEX_WEIGHTS", "weights/lpips_alex.npz")
    if not os.path.exists(path):
        return None
    data = np.load(path)

    def oihw(hwio):
        return torch.from_numpy(np.ascontiguousarray(
            hwio.transpose(3, 2, 0, 1))).to(device)

    weights: dict = {}
    for i in range(5):
        weights[f"conv{i}"] = {
            "kernel": oihw(data[f"conv{i}_kernel"]),
            "bias": torch.from_numpy(data[f"conv{i}_bias"]).to(device),
        }
        weights[f"lin{i}"] = oihw(data[f"lin{i}"])
    return weights


class VisualMetricsTracker:
    """Running SSIM/PSNR/LPIPS/MIFD with the reference's per-batch min-max
    normalization and NHWC/NCHW auto-fix (benchmark.py:1452-1503). SSIM,
    PSNR and LPIPS are computed on ``device`` (default: the CUDA card, which
    must then be present); ``lpips_weights`` are moved there."""

    def __init__(self, lpips_weights=None, device=None):
        self.ssim = AverageMeter()
        self.psnr = AverageMeter()
        self.lpips = AverageMeter()
        self.mifd = AverageMeter()
        self.device = resolve_device(device)
        if lpips_weights is None:
            lpips_weights = load_lpips_weights()
        self._lpips_weights = None if lpips_weights is None else \
            _weights_to(lpips_weights, self.device)
        self._warned_lpips = False

    def to_dict(self):
        return {key: meter.value for key, meter in self.__dict__.items()
                if isinstance(meter, AverageMeter)}

    def update(self, outputs, labels):
        outputs = np.asarray(outputs)
        labels = np.asarray(labels)
        assert outputs.shape[0] == labels.shape[0], (
            f"Batch sizes for labels and predictions do not match, got "
            f"{labels.shape[0]} and {outputs.shape[0]}.")

        # NCHW → NHWC auto-fix
        if labels.shape[-1] not in (3, 4) and labels.shape[1] in (3, 4):
            labels = labels.transpose(0, 2, 3, 1)
            outputs = outputs.transpose(0, 2, 3, 1)
        if labels.shape[-1] == 4:
            labels = labels[..., :3]
        if outputs.shape[-1] == 4:
            outputs = outputs[..., :3]

        for label, output in zip(labels, outputs):
            self.mifd.update(mifd(label, output))

        def normalise(x, low=0.0, high=1.0):
            x = x.astype(np.float32)
            x = (x - x.min()) / max(x.max() - x.min(), np.finfo(np.float32).tiny)
            x = (high - low) * x + low
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        norm_labels = normalise(labels)
        norm_outputs = normalise(outputs)
        self.ssim.update(float(ssim(norm_labels, norm_outputs)))
        self.psnr.update(float(psnr(norm_labels, norm_outputs)))

        if self._lpips_weights is not None:
            d = lpips_alex(normalise(labels, -1.0, 1.0),
                           normalise(outputs, -1.0, 1.0), self._lpips_weights)
            self.lpips.update(float(torch.mean(d)))
        else:
            if not self._warned_lpips:
                warnings.warn("LPIPS weights unavailable — recording NaN "
                              "(set LPIPS_ALEX_WEIGHTS to enable).")
                self._warned_lpips = True
            self.lpips.update(float("nan"))

    def __str__(self):
        return (f"SSIM: {self.ssim:.3f} - PSNR: {self.psnr:.3f} - "
                f"LPIPS: {self.lpips:.3f} - Reproj.: {self.mifd:.3f}      ")


def _weights_to(weights: dict, device: torch.device) -> dict:
    return {k: (_weights_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in weights.items()}
