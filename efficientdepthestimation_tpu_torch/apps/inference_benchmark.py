"""Inference fps and memory harness, the counterpart of
ReSIDE/inference_benchmark.py and of
``efficientdepthestimation_tpu/apps/inference_benchmark.py``.

For every checkpoint of a directory × ``--num-trials``: the timed model
load, the first call, the timed batched inference over a directory of
frames with the align-corners upsample back to the frame size, and the peak
device memory with its source; aggregated per model to mean and std (ddof
1, as pandas computes it) and written as ``inference_benchmark.csv`` and
``inference_benchmark.tex`` (inference_benchmark.py:72-88). On the CUDA
card unless ``--device cpu``:

    python -m efficientdepthestimation_tpu_torch.apps.inference_benchmark \\
        -c checkpoints/ -f frames/ -n 5 -b 8 --bf16
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List, Optional

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
    make_serving_fn,
    resolve_device,
)
from efficientdepthestimation_tpu_torch.data.datasets import (
    VideoFrameDataset,
    batch_iterator,
)
from efficientdepthestimation_tpu_torch.utils.profiling import peak_memory
from efficientdepthestimation_tpu_torch.utils.timer import Timer

__all__ = ["TIMES", "SUMMARY_COLUMNS", "benchmark_checkpoint",
           "benchmark_row", "summarize", "write_summary", "main"]

TIMES = ("load_time", "first_call_time", "inference_time", "frame_time",
         "memory_usage")
# The summary's columns, (field, statistic), in the JAX package's order.
SUMMARY_COLUMNS = tuple((f, s) for f in TIMES for s in ("mean", "std")) + (
    ("memory_source", "first"),)


def benchmark_checkpoint(dataset, model_path: str, batch_size: int = 8,
                         bf16: bool = False, device=None):
    """One trial: ``(load, first call, inference)`` as ``timedelta``s, and
    ``(peak bytes, source)`` of ``utils.profiling.peak_memory``, for the
    frames of ``dataset`` (uint8 images) served by the checkpoint on
    ``device`` (the CUDA card unless ``"cpu"``)."""
    device = resolve_device(device)
    loading_timer = Timer()
    with loading_timer:
        model = load_any_checkpoint(model_path, device=device)

    # The first call, timed on its own, keeps any one-time cost (kernel
    # builds, cuDNN's algorithm search) out of the steady inference time.
    first_batch = next(iter(batch_iterator(dataset, batch_size,
                                           pad_last=True)))
    frames = torch.from_numpy(first_batch["image"])
    infer = make_serving_fn(model, upsample_to=tuple(frames.shape[1:3]),
                            dtype=torch.bfloat16 if bf16 else None,
                            preprocess=True, device=device)
    first_call_timer = Timer()
    with first_call_timer:
        float(infer(frames).sum())  # a host read waits for the device

    inference_timer = Timer()
    last = None
    with inference_timer:
        for batch in batch_iterator(dataset, batch_size, pad_last=True):
            last = infer(torch.from_numpy(batch["image"]))
        if last is not None:
            float(last.sum())

    peak, mem_source = peak_memory(infer, (frames,), device=device)
    return (loading_timer.elapsed, first_call_timer.elapsed,
            inference_timer.elapsed, peak, mem_source)


def benchmark_row(dataset, model_path: str, trial: int, batch_size: int = 8,
                  bf16: bool = False, device=None) -> dict:
    """One trial of ``benchmark_checkpoint`` as a row of the summary's
    input: seconds, the frame time over the dataset, memory and its
    source."""
    load_t, first_t, infer_t, peak, mem_source = benchmark_checkpoint(
        dataset, model_path, batch_size, bf16=bf16, device=device)
    return {
        "model": os.path.splitext(os.path.basename(model_path))[0],
        "trial": trial,
        "load_time": load_t.total_seconds(),
        "first_call_time": first_t.total_seconds(),
        "inference_time": infer_t.total_seconds(),
        "frame_time": infer_t.total_seconds() / max(1, len(dataset)),
        "memory_usage": peak,
        "memory_source": mem_source,
    }


def summarize(rows: list[dict]) -> dict[str, dict]:
    """Per model, in order of first appearance: each of ``TIMES`` to its
    mean and sample std (ddof 1; NaN for one trial, as pandas), and the
    first trial's memory source, keyed by ``SUMMARY_COLUMNS``."""
    summary = {}
    for model in dict.fromkeys(r["model"] for r in rows):
        trials = [r for r in rows if r["model"] == model]
        entry = {}
        for field in TIMES:
            values = np.array([r[field] for r in trials], np.float64)
            entry[(field, "mean")] = float(values.mean())
            entry[(field, "std")] = (float(values.std(ddof=1))
                                     if len(values) > 1 else float("nan"))
        entry[("memory_source", "first")] = trials[0]["memory_source"]
        summary[model] = entry
    return summary


def write_summary(summary: dict[str, dict], output_dir: str) -> None:
    """``inference_benchmark.csv`` (a header row, then a row per model) and
    ``inference_benchmark.tex`` (a LaTeX tabular of the same)."""
    os.makedirs(output_dir, exist_ok=True)
    header = ["model"] + [f"{f}_{s}" for f, s in SUMMARY_COLUMNS]
    with open(os.path.join(output_dir, "inference_benchmark.csv"), "w",
              newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        for model, entry in summary.items():
            writer.writerow([model] + [entry[c] for c in SUMMARY_COLUMNS])

    def cell(v):
        return f"{v:.6f}" if isinstance(v, float) else str(v)

    lines = ["\\begin{tabular}{l" + "r" * len(SUMMARY_COLUMNS) + "}",
             "\\toprule",
             " & ".join(h.replace("_", "\\_") for h in header) + " \\\\",
             "\\midrule"]
    lines += [" & ".join([model.replace("_", "\\_")]
                         + [cell(entry[c]) for c in SUMMARY_COLUMNS])
              + " \\\\" for model, entry in summary.items()]
    lines += ["\\bottomrule", "\\end{tabular}", ""]
    with open(os.path.join(output_dir, "inference_benchmark.tex"), "w") as f:
        f.write("\n".join(lines))


def main(args: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description="Per-checkpoint fps/memory benchmark. The port has one "
                    "depthwise lowering, its CUDA kernel, so the JAX "
                    "package's --dw-impl is not a flag here.")
    parser.add_argument("-c", "--checkpoint-dir", required=True, type=str)
    parser.add_argument("-f", "--frames-dir", required=True, type=str)
    parser.add_argument("-n", "--num-trials", default=5, type=int)
    parser.add_argument("-b", "--batch-size", default=8, type=int)
    parser.add_argument("-o", "--output-dir", default=".", type=str)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 weights and activations "
                             "(dtype=torch.bfloat16).")
    parser.add_argument("--data-parallel", action="store_true",
                        help="not ported: ROADMAP A11")
    parser.add_argument("--spatial", action="store_true",
                        help="not ported: ROADMAP A11")
    parser.add_argument("--policy", default=None, type=str,
                        help="not ported: ROADMAP A13")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the kernels' plain versions)")
    args = parser.parse_args(args)
    if args.data_parallel or args.spatial:
        raise NotImplementedError("data-parallel and spatial serving are "
                                  "not ported yet: ROADMAP item A11")
    if args.policy is not None:
        raise NotImplementedError("serving policies are not ported yet: "
                                  "ROADMAP item A13")

    dataset = VideoFrameDataset(args.frames_dir)
    rows = []
    checkpoints = sorted(f for f in os.listdir(args.checkpoint_dir)
                         if f.endswith((".pth", ".ede")))
    for filename in checkpoints:
        path = os.path.join(args.checkpoint_dir, filename)
        print(path)
        for trial in range(args.num_trials):
            row = benchmark_row(dataset, path, trial, args.batch_size,
                                bf16=args.bf16, device=args.device)
            rows.append(row)
            print(f"  trial {trial + 1}/{args.num_trials}: "
                  f"load {row['load_time']:.2f}s "
                  f"first-call {row['first_call_time']:.2f}s "
                  f"infer {row['inference_time']:.2f}s "
                  f"peak {row['memory_usage'] / 1e6:.0f}MB "
                  f"({row['memory_source']})")

    summary = summarize(rows)
    write_summary(summary, args.output_dir)
    for model, entry in summary.items():
        print(model, " ".join(f"{f}_{s}={entry[(f, s)]}"
                              for f, s in SUMMARY_COLUMNS))
    return summary


if __name__ == "__main__":
    main()
