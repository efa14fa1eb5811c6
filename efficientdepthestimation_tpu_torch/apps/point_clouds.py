"""Frames → per-frame point clouds (``.ply``), the counterpart of
ReSIDE/point_clouds.py and of
``efficientdepthestimation_tpu/apps/point_clouds.py``.

Per frame: demo preprocess (Scale 320×240 → CenterCrop 304×228 →
normalize) → model → align-corners upsample to the input size → unproject
with the halved NYU Kinect intrinsics (point_clouds.py:105-108) → optional
Z-mirror → ``{i:04d}.ply``, at most 61 frames (point_clouds.py:146-147).
On the CUDA card unless ``--device cpu``:

    python -m efficientdepthestimation_tpu_torch.apps.point_clouds \\
        -i frames/ -m checkpoints/ENB0-HU.pth -o clouds/
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
    make_infer_fn,
    resolve_device,
)
from efficientdepthestimation_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    demo_preprocess,
)
from efficientdepthestimation_tpu_torch.utils.pointcloud import (
    NYU_V2_INTRINSICS_HALF,
    unproject_depth,
    write_ply,
)

__all__ = ["INPUT_HW", "cloud_of", "main"]

INPUT_HW = (228, 304)  # the depth is upsampled to the model's input


def cloud_of(infer, rgb_u8: np.ndarray, device, mirror_z: bool = False
             ) -> tuple[np.ndarray, np.ndarray]:
    """(N, 3) f32 points and (N, 3) f64 colours in 0..1 of one uint8 RGB
    image (H, W, 3), on the host: ``demo_preprocess`` on ``device``,
    ``infer`` (``make_infer_fn(..., upsample_to=INPUT_HW)``), the
    denormalised colours (point_clouds.py:97-102; in f64, as the JAX
    package computes them with numpy) and ``unproject_depth`` there, then
    one copy back."""
    images = demo_preprocess(torch.tensor(rgb_u8[None], device=device))
    depth = infer(images)[0, :, :, 0]
    kw = dict(dtype=torch.float64, device=images.device)
    color = (images[0] * torch.tensor(IMAGENET_STD, **kw)
             + torch.tensor(IMAGENET_MEAN, **kw)).clamp(0.0, 1.0)
    points, colors = unproject_depth(
        depth, color, mirror_z=mirror_z,
        **{k: NYU_V2_INTRINSICS_HALF[k] for k in ("fx", "fy", "cx", "cy")})
    return points.cpu().numpy(), colors.cpu().numpy()


def main(args: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="Depth → point clouds")
    parser.add_argument("-i", "--images-path", required=True, type=str)
    parser.add_argument("-m", "--model-path", required=True, type=str)
    parser.add_argument("-o", "--output-path", required=True, type=str)
    parser.add_argument("--mirror-z-axis", action="store_true")
    parser.add_argument("--max-frames", default=61, type=int)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the kernels' plain versions)")
    args = parser.parse_args(args)
    device = resolve_device(args.device)

    from PIL import Image

    model = load_any_checkpoint(args.model_path, device=device)
    os.makedirs(args.output_path, exist_ok=True)
    infer = make_infer_fn(model, upsample_to=INPUT_HW, device=device)

    for i, name in enumerate(sorted(os.listdir(args.images_path))):
        with Image.open(os.path.join(args.images_path, name)) as img:
            rgb = np.asarray(img.convert("RGB"))
        points, colors = cloud_of(infer, rgb, device, args.mirror_z_axis)
        out = os.path.join(args.output_path, f"{i:04d}.ply")
        write_ply(out, points, colors)
        print(f"Wrote frame {i + 1:d} to {out}")
        if i >= args.max_frames - 1:
            break


if __name__ == "__main__":
    main()
