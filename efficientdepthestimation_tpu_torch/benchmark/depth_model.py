"""DepthModel contract + model wrappers for the benchmark harness.

Counterpart of ``efficientdepthestimation_tpu/benchmark/depth_model.py``
(Benchmark/depth_model.py:9-39, reside_model.py and midas_custom_model.py):
NHWC float images in [0, 1] go in (the torch original used NCHW — the layout
is an implementation detail, the value contract is identical); ImageNet
normalization happens *inside* the wrapper (reside_model.py:64-65);
``...HWC`` leading dims are flattened and restored; optional
``metadata['scales']`` post-scales the depth. The wrapped models serve in
f32, in eval mode, under ``torch.inference_mode``, on their device (the
CUDA card unless the caller asks for the CPU), so the eval forward runs
the depthwise and upsample-conv kernels there.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import torch
from torch import nn

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
    resolve_device,
)
from efficientdepthestimation_tpu_torch.data.transforms import (
    normalize_imagenet,
)
from efficientdepthestimation_tpu_torch.models.common import randomize_
from efficientdepthestimation_tpu_torch.models.registry import build_model

__all__ = ["DepthModel", "FlatDepthEstimator", "ReSIDEModel", "MidasModel"]


class DepthModel(ABC):
    """Images (..., H, W, C) in [0, 1] → depth (..., H', W')."""

    def __call__(self, images, metadata=None):
        depth = self.estimate_depth(images)
        if metadata is not None and "scales" in metadata:
            factor = torch.as_tensor(metadata["scales"], dtype=depth.dtype,
                                     device=depth.device)[..., None]
            depth = depth * factor
        return depth

    @abstractmethod
    def estimate_depth(self, images):
        ...

    @abstractmethod
    def save(self, file_name):
        ...


class FlatDepthEstimator(DepthModel):
    """Dummy baseline predicting constant 0 depth (benchmark.py:490-497),
    on the device of the images."""

    def estimate_depth(self, images):
        images = torch.as_tensor(images)
        return torch.zeros(images.shape[:-1], dtype=torch.float32,
                           device=images.device)

    def save(self, file_name):
        raise NotImplementedError("FlatDepthEstimator has no weights to save")


class _WrappedModel(DepthModel):
    """Common wrapper: flatten leading dims, normalize, f32 eval forward on
    the model's device."""

    # Flattened batches are served in fixed-size tiles: one bounded tile
    # caps device memory whatever the frame count.
    _tile = 128

    def __init__(self, model: nn.Module, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).float().eval()

    @torch.inference_mode()
    def _forward(self, images: torch.Tensor) -> torch.Tensor:
        out = self.model(normalize_imagenet(images))
        return out[..., 0]  # (N, H', W')

    def estimate_depth(self, images):
        images = torch.as_tensor(images).to(self.device, torch.float32)
        lead = images.shape[:-3]
        flat = images.reshape(-1, *images.shape[-3:])
        n, t = flat.shape[0], self._tile
        if n <= t:
            out = self._forward(flat)
        else:
            outs = [self._forward(flat[i:i + t])
                    for i in range(0, n - t + 1, t)]
            if n % t:
                outs.append(self._forward(flat[n - n % t:]))
            out = torch.cat(outs)
        return out.reshape(*lead, *out.shape[-2:])

    def save(self, file_name):
        """The reference's ``.pth``: a ``state_dict`` under its keys."""
        from efficientdepthestimation_tpu_torch.checkpoints.pth_import import (
            reference_state_dict,
        )

        torch.save({k: v.cpu() for k, v in
                    reference_state_dict(self.model).items()}, file_name)


class ReSIDEModel(_WrappedModel):
    """Hu2018-decoder wrapper (Benchmark/reside_model.py). Without a
    checkpoint (``pretrained=False``), the model is built with random
    weights of seed 0 (``models.common.randomize_``)."""

    align = 1
    learning_rate = 0.0001
    lambda_view_baseline = 0.0001

    def __init__(self, model_path: str | None = None, encoder: str = "resnet50",
                 pretrained: bool = True, model: nn.Module | None = None,
                 device=None):
        if model is None:
            if pretrained and model_path:
                model = load_any_checkpoint(
                    model_path, model=build_model(encoder, "hu2018"),
                    device=device)
            else:
                resolve_device(device)
                model = randomize_(build_model(encoder, "hu2018"), 0)
        super().__init__(model, device)


class MidasModel(_WrappedModel):
    """MiDaS-decoder wrapper (Benchmark/midas_custom_model.py)."""

    align = 32
    learning_rate = 0.0001
    lambda_view_baseline = 0.0001

    def __init__(self, model_path: str | None = None,
                 model: nn.Module | None = None, device=None):
        if model is None:
            model = load_any_checkpoint(model_path, device=device)
        super().__init__(model, device)
