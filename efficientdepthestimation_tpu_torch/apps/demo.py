"""Single-image depth demo, the counterpart of ``python -m demo``
(ReSIDE/demo.py) and of ``efficientdepthestimation_tpu/apps/demo.py``.

Same CLI contract (-i image or directory, -m model, -o output): a
checkpoint whose file does not say its architecture is built from the
path's substrings (demo.py:25-31); each depth map is saved as a grey PNG at
the model's output size by matplotlib (demo.py:65). On the CUDA card unless
``--device cpu``:

    python -m efficientdepthestimation_tpu_torch.apps.demo \\
        -i photo.jpg -m checkpoints/ENB0-HU.pth -o depth_out
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.apps.common import (
    infer_arch_from_path,
    load_any_checkpoint,
    make_infer_fn,
    resolve_device,
)
from efficientdepthestimation_tpu_torch.data.transforms import (
    demo_preprocess,
)
from efficientdepthestimation_tpu_torch.models.registry import build_model

__all__ = ["load_demo_model", "depth_of", "run_one", "main"]


def load_demo_model(model_path: str, device=None) -> torch.nn.Module:
    """The checkpoint's model; where neither the file nor its name says
    the architecture (``ValueError``), the one the path's substrings
    name."""
    try:
        return load_any_checkpoint(model_path, device=device)
    except ValueError:
        encoder, decoder = infer_arch_from_path(model_path)
        return load_any_checkpoint(model_path, build_model(encoder, decoder),
                                   device=device)


def depth_of(infer, rgb_u8: np.ndarray, device) -> np.ndarray:
    """(h, w) f32 depth at the model's output size of one uint8 RGB image
    (H, W, 3): ``demo_preprocess`` (Scale 320×240, CenterCrop 304×228,
    normalize) on ``device``, ``infer`` (``make_infer_fn``), then a copy
    back to the host."""
    images = demo_preprocess(torch.tensor(rgb_u8[None], device=device))
    return infer(images)[0, :, :, 0].cpu().numpy()


def run_one(infer, rgb_path: str, output_path: str | None, device):
    import matplotlib.image
    from PIL import Image

    directory, file = os.path.split(rgb_path)
    file = f"{file.split('.')[0]}.png"
    depth_path = (os.path.join(output_path, file) if output_path
                  else os.path.join(directory, f"out_{file}"))
    print(f"{rgb_path} -> {depth_path}")

    with Image.open(rgb_path) as img:
        rgb = np.asarray(img.convert("RGB"))
    matplotlib.image.imsave(depth_path, depth_of(infer, rgb, device),
                            cmap="gray")


def main(args: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="Single-image depth demo")
    parser.add_argument("-i", "--image-path", required=True, type=str,
                        help="An RGB image or a directory of RGB images.")
    parser.add_argument("-m", "--model-path",
                        default="pretrained_model/model_resnet", type=str)
    parser.add_argument("-o", "--output-path", default=None, type=str)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the kernels' plain versions)")
    args = parser.parse_args(args)
    device = resolve_device(args.device)

    print("Loading model...")
    infer = make_infer_fn(load_demo_model(args.model_path, device),
                          device=device)
    if args.output_path:
        os.makedirs(args.output_path, exist_ok=True)

    print("Creating depth maps...")
    rgb_path = os.path.abspath(args.image_path)
    files = ([os.path.join(rgb_path, f) for f in os.listdir(rgb_path)]
             if os.path.isdir(rgb_path) else [rgb_path])
    for path in files:
        run_one(infer, path, args.output_path, device)
    print("Done.")


if __name__ == "__main__":
    main()
