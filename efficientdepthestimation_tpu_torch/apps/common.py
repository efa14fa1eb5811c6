"""Checkpoint loading and the serving forward of the port.

Counterpart of ``efficientdepthestimation_tpu/apps/common.py``: checkpoints
of both kinds, ``.ede`` and the reference's ``.pth``, and the monolithic
serving path: uint8 frames → PIL-parity preprocess → model in
the serving dtype → f32 depth, optionally upsampled (align corners) to the
frame size. Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import copy
import os

import torch
from torch import nn

from efficientdepthestimation_tpu_torch.checkpoints.pth_import import (
    import_pth,
)
from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
    MAGIC,
    load_checkpoint,
)
from efficientdepthestimation_tpu_torch.data.transforms import (
    eval_preprocess_image_only,
)
from efficientdepthestimation_tpu_torch.models.registry import (
    parse_checkpoint_name,
)
from efficientdepthestimation_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
)

__all__ = ["resolve_device", "infer_arch_from_path", "load_any_checkpoint",
           "make_infer_fn", "make_serving_fn"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, which must then be present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    return device


def infer_arch_from_path(model_path: str) -> tuple[str, str]:
    """(encoder, decoder) of a checkpoint path: the released-checkpoint
    name ``{ENC}-{DEC}.pth`` (inference_benchmark.py:117-125), else the
    substring sniffing of demo.py:25-31 (hu2018 unless 'lasinger' appears
    or the name ends in '-lr')."""
    try:
        return parse_checkpoint_name(os.path.basename(model_path))
    except ValueError:
        pass
    lower = os.path.splitext(os.path.basename(model_path))[0].lower()
    decoder = ("lasinger2019" if ("lasinger" in lower or lower.endswith("-lr"))
               else "hu2018")
    for token, enc in (
        ("efficientnet-b4", "efficientnet-b4"),
        ("efficientnet-b0", "efficientnet-b0"),
        ("efficientnet", "efficientnet-b4"),  # demo.py's default variant
        ("resnet", "resnet50"), ("densenet", "densenet161"),
        ("senet", "senet154"),
    ):
        if token in lower:
            return enc, decoder
    raise ValueError(f"Cannot infer architecture from '{model_path}'")


def load_any_checkpoint(path: str, model: nn.Module | None = None, *,
                        device=None) -> nn.Module:
    """The model of a checkpoint on ``device``, eval: a native ``.ede``
    (its ``EDE1`` magic) or a reference ``.pth``, a Hu2018 ``state_dict``
    or a self-describing MidasNet (``checkpoints.pth_import.import_pth``).
    ``model``, when given, receives the weights in place of the model the
    file or its name describes."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic != MAGIC:
        return import_pth(path, model=model).to(device)
    loaded, _ = load_checkpoint(path)
    if model is not None:
        model.load_state_dict(loaded.state_dict(), strict=True)
        loaded = model
    return loaded.to(device).eval()


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


def make_serving_fn(model: nn.Module, *, upsample_to=None, dtype=None,
                    preprocess: bool = False, device=None):
    """The serving pipeline every app routes through, with the JAX
    package's defaults: normalized f32 NHWC images in, f32 depth at the
    model's output size out, the model in its own dtype. A deployment that
    serves raw frames passes ``preprocess=True`` (uint8 in),
    ``upsample_to=(480, 640)`` (depth at frame size) and
    ``dtype=torch.bfloat16``. The JAX package chooses among staged, tiled
    and int8 forms here; the port has the monolithic form only (ROADMAP
    A13)."""
    return make_infer_fn(model, upsample_to=upsample_to, dtype=dtype,
                         preprocess=preprocess, device=device)
