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

``--data-parallel`` serves over a data-parallel mesh, one process a card,
under a launcher (``torchrun --nproc-per-node N -m ... --data-parallel``):
each rank decodes and forwards only its rows of every batch (``-b`` is the
global batch, which the ranks must divide), and rank 0 reports the slowest
rank's times and writes the summary. ``--spatial``, under the same
launcher, is spatial serving instead: every rank decodes every frame of a
batch of any size, holds a block of the image's rows through the forward,
exchanging halos with its neighbours (``parallel.spatial``), and keeps its
rows of the depth; rank 0 reports the slowest rank. ``--policy`` serves
each checkpoint in the form the autotuner measured fastest for ``-b``
frames a call (``apps.autotune``), else in the form ``make_serving_fn``'s
rule picks; ``--dw-impl`` selects the depthwise mode of EfficientNet
encoders.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
    make_serving_fn,
    resolve_device,
)
from efficientdepthestimation_tpu_torch.data.datasets import (
    VideoFrameDataset,
    batch_iterator,
)
from efficientdepthestimation_tpu_torch.parallel import (
    create_mesh,
    distributed_batch_iterator,
    maybe_initialize_distributed,
)
from efficientdepthestimation_tpu_torch.parallel.mesh import all_reduce_
from efficientdepthestimation_tpu_torch.utils.profiling import peak_memory
from efficientdepthestimation_tpu_torch.utils.timer import Timer

__all__ = ["TIMES", "SUMMARY_COLUMNS", "benchmark_checkpoint",
           "benchmark_row", "summarize", "write_summary", "main"]

TIMES = ("load_time", "first_call_time", "inference_time", "frame_time",
         "memory_usage")
# The summary's columns, (field, statistic), in the JAX package's order.
SUMMARY_COLUMNS = tuple((f, s) for f in TIMES for s in ("mean", "std")) + (
    ("memory_source", "first"),)


def _batches(dataset, batch_size: int, mesh, spatial: bool = False):
    """The frames in batches of ``batch_size``, the last one padded: under a
    data-parallel mesh of several ranks this rank's rows of each, decoding
    only those (``distributed_batch_iterator``); under spatial serving every
    frame of each."""
    if mesh is not None and mesh.distributed and not spatial:
        return distributed_batch_iterator(dataset, batch_size, mesh,
                                          pad_last=True)
    return batch_iterator(dataset, batch_size, pad_last=True)


def benchmark_checkpoint(dataset, model_path: str, batch_size: int = 8,
                         bf16: bool = False, device=None, mesh=None,
                         dw_impl: str = "pallas", policy: str | None = None,
                         spatial: bool = False):
    """One trial: ``(load, first call, inference)`` as ``timedelta``s, and
    ``(peak bytes, source)`` of ``utils.profiling.peak_memory``, for the
    frames of ``dataset`` (uint8 images) served by the checkpoint on
    ``device`` (the CUDA card unless ``"cpu"``; the mesh's device under
    ``mesh``, where each rank decodes and serves its rows of each batch, or
    with ``spatial`` every frame, row-sharded), through
    ``make_serving_fn`` with ``batch_hint=batch_size``, ``dw_impl`` and the
    serving policy ``policy``."""
    if device is None and mesh is not None:
        device = mesh.device
    device = resolve_device(device)
    loading_timer = Timer()
    with loading_timer:
        model = load_any_checkpoint(model_path, device=device)

    # The first call, timed on its own, keeps any one-time cost (kernel
    # builds, cuDNN's algorithm search) out of the steady inference time.
    first_batch = next(iter(_batches(dataset, batch_size, mesh, spatial)))
    frames = torch.from_numpy(first_batch["image"])
    infer = make_serving_fn(model, upsample_to=tuple(frames.shape[1:3]),
                            dtype=torch.bfloat16 if bf16 else None,
                            preprocess=True, device=device, mesh=mesh,
                            spatial=spatial, local_rows=not spatial,
                            batch_hint=batch_size, dw_impl=dw_impl,
                            policy_path=policy)
    first_call_timer = Timer()
    with first_call_timer:
        float(infer(frames).sum())  # a host read waits for the device

    inference_timer = Timer()
    last = None
    with inference_timer:
        for batch in _batches(dataset, batch_size, mesh, spatial):
            last = infer(torch.from_numpy(batch["image"]))
        if last is not None:
            float(last.sum())

    peak, mem_source = peak_memory(infer, (frames,), device=device)
    return (loading_timer.elapsed, first_call_timer.elapsed,
            inference_timer.elapsed, peak, mem_source)


def benchmark_row(dataset, model_path: str, trial: int, batch_size: int = 8,
                  bf16: bool = False, device=None, mesh=None,
                  dw_impl: str = "pallas", policy: str | None = None,
                  spatial: bool = False) -> dict:
    """One trial of ``benchmark_checkpoint`` as a row of the summary's
    input: seconds, the frame time over the dataset, memory and its
    source. Under a mesh of several ranks each figure is the slowest (the
    largest) rank's, on every rank."""
    load_t, first_t, infer_t, peak, mem_source = benchmark_checkpoint(
        dataset, model_path, batch_size, bf16=bf16, device=device, mesh=mesh,
        dw_impl=dw_impl, policy=policy, spatial=spatial)
    times = [load_t.total_seconds(), first_t.total_seconds(),
             infer_t.total_seconds(), float(peak)]
    if mesh is not None and mesh.distributed:
        times = all_reduce_(torch.tensor(times, dtype=torch.float64,
                                         device=mesh.device), mesh,
                            dist.ReduceOp.MAX).tolist()
    load_s, first_s, infer_s, peak = times
    return {
        "model": os.path.splitext(os.path.basename(model_path))[0],
        "trial": trial,
        "load_time": load_s,
        "first_call_time": first_s,
        "inference_time": infer_s,
        "frame_time": infer_s / max(1, len(dataset)),
        "memory_usage": int(peak),
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
        description="Per-checkpoint fps/memory benchmark")
    parser.add_argument("-c", "--checkpoint-dir", required=True, type=str)
    parser.add_argument("-f", "--frames-dir", required=True, type=str)
    parser.add_argument("-n", "--num-trials", default=5, type=int)
    parser.add_argument("-b", "--batch-size", default=8, type=int)
    parser.add_argument("-o", "--output-dir", default=".", type=str)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 weights and activations "
                             "(dtype=torch.bfloat16).")
    parser.add_argument("--data-parallel", action="store_true",
                        help="serve over a data-parallel mesh, one process "
                             "a device (torchrun); -b is the global batch, "
                             "which the ranks must divide")
    parser.add_argument("--spatial", action="store_true",
                        help="spatial serving over a mesh, one process a "
                             "device (torchrun): image rows across the "
                             "ranks, halos exchanged between them; any "
                             "batch size")
    parser.add_argument("--dw-impl", default="pallas",
                        choices=("pallas", "xla", "shift"),
                        help="depthwise mode of EfficientNet encoders: the "
                             "hand-written kernel (depthwise conv, BN, swish "
                             "and the SE sums in one launch; the default), "
                             "cuDNN's grouped conv, or the per-tap sum; the "
                             "same function")
    parser.add_argument("--policy", default=None, type=str,
                        help="serving-policy JSON of `ede-torch-autotune`")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the kernels' plain versions)")
    args = parser.parse_args(args)

    mesh = None
    if args.data_parallel or args.spatial:
        maybe_initialize_distributed(device=args.device)
        mesh = create_mesh(device=args.device)
    is_main = mesh is None or mesh.rank == 0
    dataset = VideoFrameDataset(args.frames_dir)
    rows = []
    checkpoints = sorted(f for f in os.listdir(args.checkpoint_dir)
                         if f.endswith((".pth", ".ede")))
    for filename in checkpoints:
        path = os.path.join(args.checkpoint_dir, filename)
        print(path)
        for trial in range(args.num_trials):
            row = benchmark_row(dataset, path, trial, args.batch_size,
                                bf16=args.bf16, device=args.device, mesh=mesh,
                                dw_impl=args.dw_impl, policy=args.policy,
                                spatial=args.spatial)
            rows.append(row)
            print(f"  trial {trial + 1}/{args.num_trials}: "
                  f"load {row['load_time']:.2f}s "
                  f"first-call {row['first_call_time']:.2f}s "
                  f"infer {row['inference_time']:.2f}s "
                  f"peak {row['memory_usage'] / 1e6:.0f}MB "
                  f"({row['memory_source']})")

    summary = summarize(rows)
    if is_main:
        write_summary(summary, args.output_dir)
        for model, entry in summary.items():
            print(model, " ".join(f"{f}_{s}={entry[(f, s)]}"
                                  for f, s in SUMMARY_COLUMNS))
    return summary


if __name__ == "__main__":
    main()
