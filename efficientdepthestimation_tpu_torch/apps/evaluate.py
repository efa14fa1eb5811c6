"""NYU evaluation with edge metrics, the counterpart of
``python -m ReSIDE.test`` and of
``efficientdepthestimation_tpu/apps/evaluate.py``.

Each test batch goes through ``eval_preprocess``, the model, the
align-corners upsample to the label size, the depth metrics and the
Sobel-edge accuracy, precision, recall and F1 at a threshold of 0.25
(ReSIDE/test.py:30-102), on the CUDA card unless ``--device cpu``:

    python -m efficientdepthestimation_tpu_torch.apps.evaluate \\
        --model e2e/ENB0-HU-synthetic.ede --test-csv data/test.csv
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
    resolve_device,
)
from efficientdepthestimation_tpu_torch.data.datasets import (
    DepthPairDataset,
    batch_iterator,
)
from efficientdepthestimation_tpu_torch.data.transforms import eval_preprocess
from efficientdepthestimation_tpu_torch.training.metrics import (
    MetricsTracker,
    edge_metrics_batch,
    sums_to_host,
)
from efficientdepthestimation_tpu_torch.training.train_step import eval_sums

__all__ = ["EDGE_KEYS", "evaluate_dataset", "main"]

EDGE_KEYS = ("edge_accuracy", "edge_precision", "edge_recall", "edge_f1")


def evaluate_dataset(model, dataset, batch_size: int = 1,
                     threshold: float = 0.25, device=None
                     ) -> tuple[MetricsTracker, dict[str, float]]:
    """Evaluate ``model`` (on ``device``: the CUDA card unless ``"cpu"``)
    over ``dataset``, pairs of uint8 480×640 frames and 16-bit mm depths.

    Batches are padded at the end (``pad_last``) and the duplicates masked
    through ``num_valid``; each batch goes through the eval step's
    ``eval_sums``, and its depth and edge sums come back in one
    device-to-host copy. Prints a progress line; returns the depth
    tracker and the edge averages over the samples.
    """
    device = resolve_device(device)
    model = model.to(device).eval()
    tracker = MetricsTracker()
    edge_sums = dict.fromkeys(EDGE_KEYS, 0.0)
    total = 0
    for batch in batch_iterator(dataset, batch_size, pad_last=True):
        num_valid = int(batch["num_valid"])
        with torch.inference_mode():
            images, depths = eval_preprocess(
                torch.from_numpy(batch["image"]).to(device),
                torch.from_numpy(batch["depth"]).to(device))
            sums, out = eval_sums(model, images, depths, num_valid)
            sums = sums_to_host(
                sums | edge_metrics_batch(out, depths, threshold, num_valid))
        tracker.update_from_sums(sums)
        for key in edge_sums:
            edge_sums[key] += sums[key]
        total += num_valid
        print(f"\rProgress: [{total:02d}/{len(dataset):02d}] {tracker}",
              end="", flush=True)
    print()
    return tracker, {k: v / total for k, v in edge_sums.items()}


def main(args: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description="NYU evaluation + edge metrics")
    parser.add_argument("--model", default="pretrained_model/model_resnet",
                        type=str)
    parser.add_argument("--test-csv", default="./data/nyu2_test.csv",
                        type=str)
    parser.add_argument("--batch-size", default=1, type=int)
    parser.add_argument("--threshold", default=0.25, type=float)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the kernels' plain versions)")
    args = parser.parse_args(args)

    model = load_any_checkpoint(args.model, device=args.device)
    dataset = DepthPairDataset(args.test_csv, is_test=True)
    tracker, edges = evaluate_dataset(model, dataset, args.batch_size,
                                      args.threshold, args.device)
    print("AV", edges["edge_accuracy"])
    print("PV", edges["edge_precision"])
    print("RV", edges["edge_recall"])
    print("FV", edges["edge_f1"])
    return tracker, edges


if __name__ == "__main__":
    main()
