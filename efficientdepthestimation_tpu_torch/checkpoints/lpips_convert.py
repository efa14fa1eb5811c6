"""Convert official LPIPS-AlexNet weights to the framework's .npz format.

A copy of ``efficientdepthestimation_tpu/checkpoints/lpips_convert.py``:
the same ``.npz`` layout (HWIO), so both packages read one file. The visual
benchmark's LPIPS metric (benchmark.py:1389) needs (a) the torchvision
AlexNet backbone features and (b) the lpips 0.1.4 linear heads. Neither can
be downloaded in this environment, so this converter takes the two files
from a user-supplied location:

    python -m efficientdepthestimation_tpu_torch.checkpoints.lpips_convert \
        --alexnet alexnet-owt-7be5be79.pth --lpips lpips_alex.pth \
        --output weights/lpips_alex.npz

and produces the npz consumed by benchmark.metrics.load_lpips_weights.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

__all__ = ["convert", "main"]

# torchvision AlexNet 'features' conv indices → our conv0..4
_ALEX_FEATURE_IDX = [0, 3, 6, 8, 10]


def convert(alexnet_path: str, lpips_path: str, output_path: str) -> None:
    alex = torch.load(alexnet_path, map_location="cpu", weights_only=False)
    if hasattr(alex, "state_dict"):
        alex = alex.state_dict()
    heads = torch.load(lpips_path, map_location="cpu", weights_only=False)
    if hasattr(heads, "state_dict"):
        heads = heads.state_dict()

    out = {}
    for i, idx in enumerate(_ALEX_FEATURE_IDX):
        w = alex[f"features.{idx}.weight"].numpy()  # OIHW
        b = alex[f"features.{idx}.bias"].numpy()
        out[f"conv{i}_kernel"] = w.transpose(2, 3, 1, 0)  # HWIO
        out[f"conv{i}_bias"] = b

    for i in range(5):
        # lpips stores heads as lin{i}.model.1.weight, shape (1, C, 1, 1)
        key = f"lin{i}.model.1.weight"
        if key not in heads:
            key = f"lins.{i}.model.1.weight"
        w = heads[key].numpy()  # (1, C, 1, 1) OIHW
        out[f"lin{i}"] = w.transpose(2, 3, 1, 0)  # (1, 1, C, 1) HWIO

    np.savez(output_path, **out)
    print(f"Wrote {output_path} ({len(out)} arrays)")


def main(args=None):
    parser = argparse.ArgumentParser(description="Convert LPIPS-Alex weights")
    parser.add_argument("--alexnet", required=True,
                        help="torchvision alexnet .pth (state dict or module)")
    parser.add_argument("--lpips", required=True,
                        help="lpips 0.1.4 alex linear heads .pth")
    parser.add_argument("--output", default="weights/lpips_alex.npz")
    args = parser.parse_args(args)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    convert(args.alexnet, args.lpips, args.output)


if __name__ == "__main__":
    main()
