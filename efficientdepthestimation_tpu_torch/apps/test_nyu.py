"""Test-set depth export, the counterpart of ReSIDE/test_nyu.py and of
``efficientdepthestimation_tpu/apps/test_nyu.py``.

For each checkpoint of a directory: serve the test split in f32 with the
depth upsampled to 640×480, clamp above 10 m to 0, and write ×1000 uint16
PNGs and ÷10000 JPG previews through an asynchronous writer
(test_nyu.py:19-22,82-94), on the CUDA card unless ``--device cpu``:

    python -m efficientdepthestimation_tpu_torch.apps.test_nyu \\
        -c checkpoints/ --test-csv data/test.csv -o nyu_depth_out
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
    make_serving_fn,
)
from efficientdepthestimation_tpu_torch.data.datasets import (
    DepthPairDataset,
    batch_iterator,
)
from efficientdepthestimation_tpu_torch.utils.async_writer import (
    AsyncImageWriter,
)

__all__ = ["FRAME_HW", "MAX_DEPTH_M", "depth_maps_mm", "write_depth",
           "write_preview", "main"]

FRAME_HW = (480, 640)
MAX_DEPTH_M = 10.0  # deeper predictions are written as 0 (test_nyu.py:88)


def depth_maps_mm(serve, frames: torch.Tensor) -> np.ndarray:
    """f32 (N, 480, 640) depth in mm of uint8 frames through ``serve``
    (``make_serving_fn(..., upsample_to=FRAME_HW, preprocess=True)``),
    predictions above ``MAX_DEPTH_M`` set to 0, on the host."""
    out = serve(frames)[..., 0]
    out = torch.where(out > MAX_DEPTH_M, 0.0, out) * 1000.0
    return out.cpu().numpy()


def write_depth(depth_mm: np.ndarray, path: str):
    """A 16-bit PNG of the depth in mm, truncated to integers."""
    from PIL import Image

    Image.fromarray(depth_mm.astype(np.uint16)).save(path)


def write_preview(image: np.ndarray, path: str):
    """An 8-bit grey preview of ``image`` in [0, 1]."""
    from PIL import Image

    Image.fromarray((image * 255).astype(np.uint8)).save(path)


def main(args: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="Export test-set depth maps")
    parser.add_argument("-c", "--checkpoint-dir", required=True, type=str)
    parser.add_argument("--test-csv", default="./data/nyu2_test.csv",
                        type=str)
    parser.add_argument("-b", "--batch-size", default=8, type=int)
    parser.add_argument("-o", "--output-dir", default="nyu_depth_out",
                        type=str)
    parser.add_argument("--policy", default=None, type=str,
                        help="serving-policy JSON (not ported: ROADMAP A13)")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the kernels' plain versions)")
    args = parser.parse_args(args)
    if args.policy is not None:
        raise NotImplementedError("serving policies are not ported yet: "
                                  "ROADMAP item A13")

    dataset = DepthPairDataset(args.test_csv, is_test=True)
    for filename in sorted(os.listdir(args.checkpoint_dir)):
        if not filename.endswith((".pth", ".ede")):
            continue
        name = os.path.splitext(filename)[0]
        out_dir = os.path.join(args.output_dir, name)
        os.makedirs(out_dir, exist_ok=True)
        model = load_any_checkpoint(
            os.path.join(args.checkpoint_dir, filename), device=args.device)
        serve = make_serving_fn(model, upsample_to=FRAME_HW, preprocess=True,
                                device=args.device)
        index = 0
        with AsyncImageWriter() as writer:
            for batch in batch_iterator(dataset, args.batch_size,
                                        pad_last=True):
                depth_mm = depth_maps_mm(serve,
                                         torch.from_numpy(batch["image"]))
                for k in range(int(batch["num_valid"])):
                    writer.submit(depth_mm[k],
                                  os.path.join(out_dir, f"{index:04d}.png"),
                                  writer=write_depth)
                    writer.submit(depth_mm[k] / 10000.0,
                                  os.path.join(out_dir, f"{index:04d}.jpg"),
                                  writer=write_preview)
                    index += 1
        print(f"{name}: wrote {index} depth maps to {out_dir}")


if __name__ == "__main__":
    main()
