"""Peak-memory probe, the counterpart of ``python -m ReSIDE.inference`` and
of ``efficientdepthestimation_tpu/apps/inference.py``.

Runs batched test-set inference, then reports the device's peak memory in
one call of the forward through ``utils.profiling.peak_memory``: the
caching allocator's peak on the card (``live``; the reference reads
``torch.cuda.max_memory_cached()``, ReSIDE/inference.py:17-32), the bytes
the call's operators create on the CPU (``static``). On the CUDA card
unless ``--device cpu``:

    python -m efficientdepthestimation_tpu_torch.apps.inference \\
        --model checkpoints/ENB0-HU.pth --test-csv data/nyu2_test.csv
"""

from __future__ import annotations

import argparse
from typing import List, Optional

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
from efficientdepthestimation_tpu_torch.utils.profiling import peak_memory

__all__ = ["main"]


def main(args: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="Peak device memory probe")
    parser.add_argument("--model", required=True, type=str)
    parser.add_argument("--test-csv", default="./data/nyu2_test.csv",
                        type=str)
    parser.add_argument("--batch-size", default=8, type=int)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the kernels' plain versions)")
    args = parser.parse_args(args)
    device = resolve_device(args.device)

    infer = make_infer_fn(load_any_checkpoint(args.model, device=device),
                          device=device)
    dataset = DepthPairDataset(args.test_csv, is_test=True)
    images = None
    for batch in batch_iterator(dataset, args.batch_size, pad_last=True):
        images, _ = eval_preprocess(
            torch.from_numpy(batch["image"]).to(device),
            torch.from_numpy(batch["depth"]).to(device))
        infer(images)

    peak, source = peak_memory(infer, (images,) if images is not None else (),
                               device=device)
    print(f"Peak device memory: {peak / 1e9:.3f} GB ({peak} bytes, {source})")
    return peak


if __name__ == "__main__":
    main()
