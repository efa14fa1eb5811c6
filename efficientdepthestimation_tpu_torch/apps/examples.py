"""Comparison grid over all checkpoints, the counterpart of
ReSIDE/examples.py and of ``efficientdepthestimation_tpu/apps/examples.py``.

Runs each checkpoint (``.pth`` or ``.ede``) of a directory on the first test
batch and writes depth PNGs normalized by the *global* max depth over all
models and the ground truth, so that the panels compare
(examples.py:96-116). On the CUDA card unless ``--device cpu``:

    python -m efficientdepthestimation_tpu_torch.apps.examples \\
        -c checkpoints/ --test-csv data/nyu2_test.csv -o examples_out
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
from efficientdepthestimation_tpu_torch.data.datasets import (
    DepthPairDataset,
    batch_iterator,
)
from efficientdepthestimation_tpu_torch.data.transforms import eval_preprocess

__all__ = ["main"]


def main(args: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description="Example depth maps per checkpoint")
    parser.add_argument("-c", "--checkpoint-dir", required=True, type=str)
    parser.add_argument("--test-csv", default="./data/nyu2_test.csv",
                        type=str)
    parser.add_argument("-b", "--batch-size", default=4, type=int)
    parser.add_argument("-o", "--output-dir", default="examples_out",
                        type=str)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the kernels' plain versions)")
    args = parser.parse_args(args)
    device = resolve_device(args.device)

    dataset = DepthPairDataset(args.test_csv, is_test=True)
    batch = next(batch_iterator(dataset, args.batch_size, pad_last=True))
    images, depths = eval_preprocess(
        torch.from_numpy(batch["image"]).to(device),
        torch.from_numpy(batch["depth"]).to(device))

    outputs = {}
    for filename in sorted(os.listdir(args.checkpoint_dir)):
        if not filename.endswith((".pth", ".ede")):
            continue
        model = load_any_checkpoint(
            os.path.join(args.checkpoint_dir, filename), device=device)
        infer = make_infer_fn(model, upsample_to=tuple(depths.shape[1:3]),
                              device=device)
        outputs[os.path.splitext(filename)[0]] = \
            infer(images)[..., 0].cpu().numpy()
    depths = depths[..., 0].cpu().numpy()

    # Normalized by the max depth over ALL models + GT (examples.py:96-116)
    global_max = max([float(depths.max())]
                     + [float(o.max()) for o in outputs.values()])
    os.makedirs(args.output_dir, exist_ok=True)

    from PIL import Image

    for i in range(images.shape[0]):
        Image.fromarray((depths[i] / global_max * 255).astype(np.uint8)).save(
            os.path.join(args.output_dir, f"sample{i:02d}_gt.png"))
        for name, out in outputs.items():
            arr = np.clip(out[i] / global_max, 0, 1)
            Image.fromarray((arr * 255).astype(np.uint8)).save(
                os.path.join(args.output_dir, f"sample{i:02d}_{name}.png"))
    print(f"Wrote {images.shape[0]} samples × {len(outputs)} models "
          f"to {args.output_dir} (global max {global_max:.2f} m)")
    return outputs


if __name__ == "__main__":
    main()
