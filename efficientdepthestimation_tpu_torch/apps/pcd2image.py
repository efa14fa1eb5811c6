"""Point-cloud collage, the counterpart of ReSIDE/pcd2image.py and of
``efficientdepthestimation_tpu/apps/pcd2image.py``, on the host only.

Renders 6 ``.ply`` clouds per decoder/encoder directory with per-sample
scripted camera rotations into one comparison PNG, with the z-buffer point
splatter of ``utils.pointcloud`` (no OpenGL or Open3D):

    python -m efficientdepthestimation_tpu_torch.apps.pcd2image \
        -i clouds_root/ --output point_cloud_comparison.png
"""

from __future__ import annotations

import argparse
import math
import os
from typing import List, Optional

import numpy as np

from efficientdepthestimation_tpu_torch.utils.pointcloud import (
    read_ply,
    render_point_cloud,
)


def _rotation(rx_deg: float, ry_deg: float) -> np.ndarray:
    rx, ry = math.radians(rx_deg), math.radians(ry_deg)
    mx = np.array([[1, 0, 0],
                   [0, math.cos(rx), -math.sin(rx)],
                   [0, math.sin(rx), math.cos(rx)]])
    my = np.array([[math.cos(ry), 0, math.sin(ry)],
                   [0, 1, 0],
                   [-math.sin(ry), 0, math.cos(ry)]])
    return mx @ my


# per-sample camera moves echoing pcd2image.py:41-53
_VIEWS = {
    0: dict(rotation=_rotation(-25, 45), zoom=0.9),
    1: dict(rotation=_rotation(-25, 45), zoom=0.9),
    2: dict(rotation=_rotation(-45, 45), zoom=0.8),
    3: dict(rotation=_rotation(-25, 45), zoom=0.9),
    4: dict(rotation=_rotation(-45, 45), zoom=0.8),
    5: dict(rotation=_rotation(-45, 45), zoom=0.8),
}


def main(args: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description="Render point-cloud comparison grid")
    parser.add_argument("-i", "--point-cloud-dir", required=True, type=str)
    parser.add_argument("-o", "--orientation", default="column",
                        choices=["row", "column"], type=str)
    parser.add_argument("--size", default=256, type=int)
    parser.add_argument("--output", default="point_cloud_comparison.png",
                        type=str)
    parser.add_argument("--num-samples", default=6, type=int)
    args = parser.parse_args(args)

    from PIL import Image

    root = args.point_cloud_dir
    decoders = sorted(d for d in os.listdir(root)
                      if os.path.isdir(os.path.join(root, d)))
    collage = None
    for decoder in decoders:
        encoders = sorted(os.listdir(os.path.join(root, decoder)))
        for encoder in encoders:
            row = None
            for i in range(args.num_samples):
                path = os.path.join(root, decoder, encoder, f"{i:04d}.ply")
                points, colors = read_ply(path)
                view = _VIEWS.get(i, _VIEWS[0])
                img = render_point_cloud(points, colors,
                                         (args.size, args.size), **view)
                row = img if row is None else np.concatenate(
                    (row, img), axis=1 if args.orientation == "column" else 0)
            collage = row if collage is None else np.concatenate(
                (collage, row), axis=0 if args.orientation == "column" else 1)

    image = Image.fromarray((255 * collage).astype(np.uint8))
    image.save(args.output)
    print(f"Wrote {args.output} ({image.size[0]}×{image.size[1]})")
    return args.output


if __name__ == "__main__":
    main()
