"""Benchmark orchestration (Benchmark/benchmark.py:500-796, 1042-1378).

Counterpart of ``efficientdepthestimation_tpu/benchmark/harness.py``.
Phases per model: cached depth-map generation (.raw metric + min-max .png,
timed with IO separated, metadata.json cache) → novel-view rendering →
standard depth benchmark (cached JSON) → visual benchmark
(SSIM/PSNR/LPIPS/MIFD, cached JSON) → CSV/LaTeX absolute & relative-to-
baseline reports, barh plot suite and comparison grids. Everything runs on
``--device`` (default: the CUDA card, which must then be present):

    python -m efficientdepthestimation_tpu_torch.benchmark.harness \\
        --csv-path data/nyu2_test.csv --models reside_enb0=ENB0-HU.pth

The reports are written with the ``csv`` module in the layout of the JAX
package's ``pandas`` tables; matplotlib, PIL and cv2 are imported where a
plot, image or video is written.
"""

from __future__ import annotations

import csv
import datetime
import json
import math
import os
from collections import defaultdict

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.apps.common import resolve_device
from efficientdepthestimation_tpu_torch.benchmark.metrics import (
    VisualMetricsTracker,
)
from efficientdepthestimation_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
)
from efficientdepthestimation_tpu_torch.training.metrics import MetricsTracker
from efficientdepthestimation_tpu_torch.utils import image_io
from efficientdepthestimation_tpu_torch.utils.profiling import peak_memory
from efficientdepthestimation_tpu_torch.utils.timer import Timer

__all__ = ["create_depth_maps", "test", "test_visual", "save_benchmark_results",
           "visualise_results", "images_to_grid", "get_sample_output",
           "save_sample_output", "run_benchmark", "preset_model_loaders",
           "main"]


def _batched(dataset, batch_size):
    batch = []
    for i in range(len(dataset)):
        batch.append(dataset[i])
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


def create_depth_maps(output_dir: str, model_loader, dataset,
                      batch_size: int = 4, device=None):
    """Timed, cached inference over ``dataset`` on ``device`` → per-frame
    .raw (metric) + min-max .png; returns (peak_memory_GB, inference_time,
    io_time) (benchmark.py:703-796). The copy of each batch's depth to the
    host is the timing's sync point; the file writes are timed apart."""
    device = resolve_device(device)
    num_samples = len(dataset)
    metadata_path = os.path.join(output_dir, "metadata.json")
    raw_dir = os.path.join(output_dir, "raw")
    png_dir = os.path.join(output_dir, "png")
    os.makedirs(raw_dir, exist_ok=True)
    os.makedirs(png_dir, exist_ok=True)

    if (len(os.listdir(raw_dir)) == num_samples
            and len(os.listdir(png_dir)) == num_samples
            and os.path.isfile(metadata_path)):
        print("Found cached results.")
        with open(metadata_path) as f:
            metadata = json.load(f)
        return (metadata["peak_memory_usage"],
                datetime.timedelta(seconds=metadata["inference_time"]),
                datetime.timedelta(seconds=metadata["io_time"]))

    inference_timer = Timer()
    io_time = datetime.timedelta()
    model = model_loader() if callable(model_loader) else model_loader

    with inference_timer:
        progress = 0
        for batch in _batched(dataset, batch_size):
            images = torch.from_numpy(
                np.stack([s["image"] for s in batch])).to(device)
            outputs = model(images)
            if outputs.dim() == 3:
                outputs = outputs[..., None]
            outputs = resize_bilinear_align_corners(outputs, images.shape[1:3])
            tiny = np.finfo(np.float32).tiny
            outputs = outputs.cpu().numpy()[..., 0]
            normalised = (outputs - outputs.min()) / (outputs.max() - outputs.min() + tiny)

            io_timer = Timer()
            with io_timer:
                for depth_map, norm_map in zip(outputs, normalised):
                    image_io.save_image(
                        os.path.join(raw_dir, f"{progress:06d}.raw"), depth_map)
                    image_io.save_image(
                        os.path.join(png_dir, f"{progress:06d}.png"), norm_map)
                    progress += 1
            io_time += io_timer.elapsed
            print(f"\rProgress: [{progress:02d}/{num_samples:02d}] "
                  f"{inference_timer.elapsed}", end="")
        print()

    # one call of the model at the last batch: the caching allocator's peak
    # on a card ("live"), the bytes its operators create on the CPU
    # ("static"), as utils.profiling.peak_memory labels them
    peak_bytes, mem_source = peak_memory(model, (images,), device=device)
    peak_memory_gb = peak_bytes / 1e9
    metadata = {
        "peak_memory_usage": peak_memory_gb,
        "peak_memory_source": mem_source,
        "inference_time": inference_timer.elapsed.total_seconds(),
        "io_time": io_time.total_seconds(),
    }
    with open(metadata_path, "w") as f:
        json.dump(metadata, f)
    return peak_memory_gb, inference_timer.elapsed, io_time


def test(labels_dataset, outputs_dataset, cache_dir: str, batch_size: int = 4,
         device=None):
    """Cached standard depth benchmark on ``device``
    (benchmark.py:1147-1189)."""
    device = resolve_device(device)
    metrics_path = os.path.join(cache_dir, "standard_benchmark_metadata.json")
    os.makedirs(cache_dir, exist_ok=True)
    if os.path.isfile(metrics_path):
        print("Found cached results, skipping...")
        with open(metrics_path) as f:
            return json.load(f)

    # length/shape agreement up front: a silent zip-truncation or an
    # unrelated reshape error would misreport the benchmark
    # (reference asserts the per-batch shapes, benchmark.py:143-148)
    if len(labels_dataset) != len(outputs_dataset):
        raise ValueError(
            f"label/output dataset length mismatch: {len(labels_dataset)} vs "
            f"{len(outputs_dataset)}")

    metrics = MetricsTracker()
    processed = 0
    for lab_batch, out_batch in zip(_batched(labels_dataset, batch_size),
                                    _batched(outputs_dataset, batch_size)):
        labels = np.stack([np.squeeze(np.asarray(s["depth"] if isinstance(s, dict)
                                                 else s)) for s in lab_batch])
        outputs = np.stack([np.squeeze(np.asarray(o)) for o in out_batch])
        if outputs.size != labels.size:
            raise ValueError(
                f"label/output shape mismatch: {outputs.shape} vs {labels.shape}")
        outputs = outputs.reshape(labels.shape)
        metrics.update(torch.from_numpy(outputs).to(device),
                       torch.from_numpy(labels).to(device))
        processed += len(lab_batch)
        print(f"\rProgress: [{processed:02d}/{len(labels_dataset):02d}] "
              f"{metrics}", end="")
    print()

    metrics_dict = metrics.to_dict()
    with open(metrics_path, "w") as f:
        json.dump(metrics_dict, f)
    return metrics_dict


def test_visual(labels_dataset, outputs_dataset, cache_dir: str,
                batch_size: int = 4, lpips_weights=None, device=None):
    """Cached visual benchmark over rendered novel views on ``device``
    (benchmark.py:1192-1236)."""
    metrics_path = os.path.join(cache_dir, "visual_benchmark_metadata.json")
    os.makedirs(cache_dir, exist_ok=True)
    if os.path.isfile(metrics_path):
        print("Found cached results, skipping...")
        with open(metrics_path) as f:
            return json.load(f)

    if len(labels_dataset) != len(outputs_dataset):
        raise ValueError(
            f"label/output dataset length mismatch: {len(labels_dataset)} vs "
            f"{len(outputs_dataset)}")

    tracker = VisualMetricsTracker(lpips_weights=lpips_weights, device=device)
    processed = 0
    for lab_batch, out_batch in zip(_batched(labels_dataset, batch_size),
                                    _batched(outputs_dataset, batch_size)):
        labels = np.stack([np.asarray(s) for s in lab_batch])
        outputs = np.stack([np.asarray(o) for o in out_batch])
        tracker.update(outputs, labels)
        processed += len(lab_batch)
        print(f"\rProgress: [{processed:02d}/{len(labels_dataset):02d}] "
              f"{tracker}", end="")
    print()

    metrics_dict = tracker.to_dict()
    with open(metrics_path, "w") as f:
        json.dump(metrics_dict, f)
    return metrics_dict


def _table(rows: dict) -> tuple[list[str], list[str], np.ndarray]:
    """(index, columns, values) of ``pandas.DataFrame.from_dict(rows,
    orient="index")``: one row a model, the columns in order of first
    appearance, NaN where a row lacks one."""
    index = list(rows)
    columns = list(dict.fromkeys(k for row in rows.values() for k in row))
    values = np.array([[float(rows[i].get(c, math.nan)) for c in columns]
                       for i in index], np.float64).reshape(len(index),
                                                            len(columns))
    return index, columns, values


def _write_csv_and_tex(path: str, index, columns, values) -> None:
    """``DataFrame.to_csv`` (NaN empty) and ``to_latex(float_format=
    "%.2f")`` (booktabs rules, NaN as ``NaN``) of the table."""
    with open(f"{path}.csv", "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([""] + columns)
        for name, row in zip(index, values):
            writer.writerow([name] + ["" if math.isnan(v) else repr(float(v))
                                      for v in row])
    lines = ["\\begin{tabular}{l" + "r" * len(columns) + "}", "\\toprule",
             " & " + " & ".join(columns) + " \\\\", "\\midrule"]
    for name, row in zip(index, values):
        cells = ["NaN" if math.isnan(v) else "%.2f" % v for v in row]
        lines.append(" & ".join([name] + cells) + " \\\\")
    lines += ["\\bottomrule", "\\end{tabular}", ""]
    with open(f"{path}.tex", "w") as f:
        f.write("\n".join(lines))


def save_benchmark_results(output_path: str, benchmark_results,
                           relative_to: str | None = None):
    """CSV + LaTeX, absolute and relative-to-baseline (benchmark.py:1239-1253),
    the tables the JAX package writes with pandas."""
    for dataset in benchmark_results:
        index, columns, values = _table(benchmark_results[dataset])
        if "log10" in columns:
            keep = [i for i, c in enumerate(columns) if c != "log10"]
            columns = [columns[i] for i in keep]
            values = values[:, keep]
        _write_csv_and_tex(os.path.join(output_path, dataset), index, columns,
                           values)
        if relative_to is not None and relative_to in index:
            base = values[index.index(relative_to)]
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = (values - base) / base
            _write_csv_and_tex(os.path.join(output_path, f"{dataset}-relative"),
                               index, columns, rel)


def _read_table(path: str) -> dict[str, dict[str, float]]:
    """A table ``save_benchmark_results`` wrote: {column: {model: value}}."""
    with open(path, newline="") as f:
        header, *rows = list(csv.reader(f))
    columns = header[1:]
    return {c: {row[0]: float(row[j + 1]) if row[j + 1] else math.nan
                for row in rows} for j, c in enumerate(columns)}


def visualise_results(output_path: str, absolute_csv: str, relative_csv: str,
                      relative_to: str):
    """The 7 barh plots (benchmark.py:1042-1110)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    df_abs = _read_table(absolute_csv)
    df_rel = _read_table(relative_csv)

    def ordered(series: dict, ascending: bool, shift: float = 0.0):
        """``pandas.Series.sort_values``: NaN last."""
        items = sorted(series.items(), key=lambda kv: (
            math.isnan(kv[1]), kv[1] if ascending else -kv[1]))
        return [k for k, _ in items], [v + shift for _, v in items]

    def barh(labels_values, title, fname, baselines=()):
        labels, values = labels_values
        fig, ax = plt.subplots()
        ax.barh(range(len(values)), values, tick_label=labels)
        ax.set_title(title)
        for x, label, color in baselines:
            ax.axvline(x=x, label=label, color=color, linestyle="--")
        if baselines:
            ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(output_path, fname))
        plt.close(fig)

    if "frame_time" in df_abs:
        ft = {k: 1000 * v for k, v in df_abs["frame_time"].items()}
        base = ft.get(relative_to, math.nan)
        barh(ordered(ft, ascending=False),
             "Frame Time During Inference (Lower is Better)", "frame_time.png",
             [(base, "Baseline", "black"), (1000 / 30, "30 fps", "orange"),
              (1000 / 60, "60 fps", "green")])
    if "peak_memory_usage" in df_abs:
        mem = df_abs["peak_memory_usage"]
        barh(ordered(mem, ascending=False),
             "Peak Memory Usage (Lower is Better)", "memory_usage.png",
             [(mem.get(relative_to, math.nan), "Baseline", "black")])
    if "abs_rel" in df_rel:
        barh(ordered(df_rel["abs_rel"], ascending=False, shift=1.0),
             "Relative ABS_REL (Lower is Better)", "abs_rel.png",
             [(1.0, "Baseline", "black")])
    if "delta1" in df_rel:
        barh(ordered(df_rel["delta1"], ascending=True, shift=1.0),
             "Relative DELTA1 (Higher is Better)", "delta1.png",
             [(1.0, "Baseline", "black")])
    for key, title in (("ssim", "SSIM (Higher is Better)"),
                       ("psnr", "PSNR (Higher is Better)"),
                       ("lpips", "LPIPS")):
        if key in df_abs and any(not math.isnan(v)
                                 for v in df_abs[key].values()):
            barh(ordered(df_abs[key], ascending=True), title, f"{key}.png",
                 [(df_abs[key].get(relative_to, math.nan), "Baseline",
                   "black")])


def images_to_grid(base_dir: str, output_type: str = "depth",
                   num_samples: int = 4) -> np.ndarray:
    """Model-comparison grid: rows = models, cols = samples
    (benchmark.py:1267-1378 equivalent)."""
    from PIL import Image

    rows = []
    for model_name in sorted(os.listdir(base_dir)):
        model_dir = os.path.join(base_dir, model_name)
        if output_type == "depth":
            png_dir = os.path.join(model_dir, "depth", "png")
        else:
            png_dir = os.path.join(model_dir, "rendered_images", "image")
        if not os.path.isdir(png_dir):
            continue
        paths = []
        if output_type == "depth":
            paths = [os.path.join(png_dir, f) for f in sorted(os.listdir(png_dir))]
        else:
            for sub in sorted(os.listdir(png_dir)):
                files = sorted(os.listdir(os.path.join(png_dir, sub)))
                if files:
                    paths.append(os.path.join(png_dir, sub, files[0]))
        paths = paths[:num_samples]
        if not paths:
            continue
        imgs = [np.asarray(Image.open(p).convert("RGB")) for p in paths]
        rows.append(np.concatenate(imgs, axis=1))
    if not rows:
        raise FileNotFoundError(f"No model outputs under {base_dir}")
    width = min(r.shape[1] for r in rows)
    return np.concatenate([r[:, :width] for r in rows], axis=0)


def get_sample_output(model, dataset, num_samples: int = 8,
                      batch_size: int = 4, device=None) -> np.ndarray:
    """First ``num_samples`` predictions on ``device``, upsampled to label
    size and jointly min-max normalized (benchmark.py:1114-1144)."""
    device = resolve_device(device)
    samples = []
    for batch in _batched(dataset, batch_size):
        images = torch.from_numpy(
            np.stack([s["image"] for s in batch])).to(device)
        depths = np.stack([s["depth"] for s in batch])
        out = model(images)
        if out.dim() == 3:
            out = out[..., None]
        out = resize_bilinear_align_corners(out, depths.shape[1:3])
        samples.append(out.cpu().numpy())
        if sum(len(s) for s in samples) >= num_samples:
            break
    stacked = np.concatenate(samples)[:num_samples]
    return (stacked - stacked.min()) / max(stacked.max() - stacked.min(),
                                           np.finfo(np.float32).tiny)


def save_sample_output(model, model_name, dataset, sample_output_base_dir,
                       num_samples: int = 8, device=None) -> None:
    """Write normalized sample depth PNGs (benchmark.py:1256-1264)."""
    from PIL import Image

    samples = get_sample_output(model, dataset, num_samples, device=device)
    out_dir = os.path.join(sample_output_base_dir, model_name, "depth")
    os.makedirs(out_dir, exist_ok=True)
    for i, sample in enumerate(samples):
        arr = (255 * np.squeeze(sample)).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(out_dir, f"{i:02d}.png"))


def run_benchmark(benchmark_results, dataset_name, model_name, output_path,
                  depth_labels, depth_outputs, render_labels, render_outputs,
                  baseline_model, batch_size=4, lpips_weights=None,
                  device=None):
    """Standard + visual benchmark with timing (benchmark.py:596-618)."""
    print("Standard Benchmark")
    cache_dir = os.path.join(output_path, dataset_name, model_name)
    timer = Timer()
    with timer:
        metrics = test(depth_labels, depth_outputs, cache_dir, batch_size,
                       device=device)
    benchmark_results[dataset_name][model_name].update(metrics)
    benchmark_results[dataset_name][model_name]["standard_benchmark_time"] = \
        timer.elapsed.total_seconds()
    print(f"Standard Benchmark Elapsed Time: {timer.elapsed}\n")

    print("Visual Benchmark")
    timer = Timer()
    with timer:
        metrics = test_visual(render_labels, render_outputs, cache_dir,
                              batch_size, lpips_weights, device=device)
    benchmark_results[dataset_name][model_name].update(metrics)
    benchmark_results[dataset_name][model_name]["visual_benchmark_time"] = \
        timer.elapsed.total_seconds()
    print(f"Visual Benchmark Elapsed Time: {timer.elapsed}\n")

    save_benchmark_results(output_path, benchmark_results, relative_to=baseline_model)


def preset_model_loaders(args, data):
    """The reference's experiment tables, verbatim (benchmark.py:513-557).

    chapter3: the six released checkpoints (ReSIDE enb0/enb4/rn50 + MiDaS
    enb0/enb4/rn50). chapter4: reside_enb0, reside_senet (the baseline),
    reside_enb0-random_weights (auto-generated random-init model — the
    reference's :551-553 entry, no checkpoint file needed), flat. Each
    loader builds its model on ``args.device``.
    """
    from efficientdepthestimation_tpu_torch.benchmark.depth_model import (
        FlatDepthEstimator,
        MidasModel,
        ReSIDEModel,
    )

    if args.preset is None:
        return []
    device = getattr(args, "device", None)
    if args.preset == "chapter3":
        return [
            ("reside_enb0", (lambda: ReSIDEModel(
                args.reside_enb0_path, encoder="efficientnet-b0",
                device=device)), data),
            ("reside_enb4", (lambda: ReSIDEModel(
                args.reside_enb4_path, encoder="efficientnet-b4",
                device=device)), data),
            ("reside_resnet50", (lambda: ReSIDEModel(
                args.reside_resnet50_path, encoder="resnet50",
                device=device)), data),
            ("midas_enb0", (lambda: MidasModel(args.midas_enb0_path,
                                               device=device)), data),
            ("midas_enb4", (lambda: MidasModel(args.midas_enb4_path,
                                               device=device)), data),
            ("midas_resnet50", (lambda: MidasModel(args.midas_resnet50_path,
                                                   device=device)), data),
        ]
    return [
        ("reside_enb0", (lambda: ReSIDEModel(
            args.reside_enb0_path, encoder="efficientnet-b0",
            device=device)), data),
        ("reside_senet", (lambda: ReSIDEModel(
            args.reside_senet_path, encoder="senet154", device=device)), data),
        ("reside_enb0-random_weights", (lambda: ReSIDEModel(
            encoder="efficientnet-b0", pretrained=False, device=device)),
         data),
        ("flat", FlatDepthEstimator, data),
    ]


def main(args=None):
    """Full user-centred benchmark (benchmark.py:500-679)."""
    import argparse

    from efficientdepthestimation_tpu_torch.benchmark.datasets import (
        DepthDataset,
        ImageFolderDataset,
        NestedImageFolderDataset,
        nyu_eval_sample,
    )
    from efficientdepthestimation_tpu_torch.benchmark.depth_model import (
        FlatDepthEstimator,
        MidasModel,
        ReSIDEModel,
    )
    from efficientdepthestimation_tpu_torch.benchmark.noise import (
        create_noisy_depth_maps,
    )
    from efficientdepthestimation_tpu_torch.benchmark.renderer import (
        create_rendered_images,
    )
    from efficientdepthestimation_tpu_torch.models.registry import (
        parse_checkpoint_name,
    )

    parser = argparse.ArgumentParser(description="User-centred depth benchmark")
    parser.add_argument("--csv-path", default="./data/nyu2_test.csv")
    parser.add_argument("--output-path", default="benchmark_out")
    parser.add_argument("--batch-size", default=4, type=int)
    parser.add_argument("--renderer-fps", default=60, type=int)
    parser.add_argument("--baseline-model", default="reside_senet")
    parser.add_argument("--models", nargs="*", default=None,
                        help="name=checkpoint pairs, e.g. reside_enb0=ENB0-HU.pth")
    parser.add_argument("--include-flat", action="store_true", default=True)
    # Paper-shaped experiment presets (benchmark.py:513-557): chapter3 = the
    # six released checkpoints; chapter4 = enb0 + senet baseline +
    # auto-random-weights + flat. Checkpoint paths mirror the reference's
    # hard-coded argparse.Namespace block (benchmark.py:1509-1531).
    parser.add_argument("--preset", choices=("chapter3", "chapter4"), default=None)
    parser.add_argument("--reside-enb0-path", default="checkpoints/ENB0-HU.pth")
    parser.add_argument("--reside-enb4-path", default="checkpoints/ENB4-HU.pth")
    parser.add_argument("--reside-resnet50-path", default="checkpoints/RN50-HU.pth")
    parser.add_argument("--reside-senet-path", default="checkpoints/SN154-HU.pth")
    parser.add_argument("--midas-enb0-path", default="checkpoints/ENB0-LR.pth")
    parser.add_argument("--midas-enb4-path", default="checkpoints/ENB4-LR.pth")
    parser.add_argument("--midas-resnet50-path", default="checkpoints/RN50-LR.pth")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the kernels' plain versions)")
    args = parser.parse_args(args)
    device = args.device = resolve_device(args.device)

    benchmark_results = defaultdict(lambda: defaultdict(dict))
    dataset_name = "nyu"
    out_root = args.output_path
    os.makedirs(out_root, exist_ok=True)

    labels = DepthDataset(args.csv_path, transform=nyu_eval_sample(1))
    labels_x32 = DepthDataset(args.csv_path, transform=nyu_eval_sample(32))

    print("Creating rendered images for dataset...")
    gt_render_dir = os.path.join(out_root, dataset_name, "ground_truth")
    gt_render_time = create_rendered_images(gt_render_dir, labels,
                                            fps=args.renderer_fps,
                                            device=device)
    gt_renders = NestedImageFolderDataset(os.path.join(gt_render_dir, "image"))
    print(f"Dataset Rendering Elapsed Time: {gt_render_time}\n")

    print("Creating ground truth depth maps with added noise...")
    noisy_dir = os.path.join(out_root, dataset_name, "random")
    noisy_png_dir = os.path.join(noisy_dir, "depth", "png")
    create_noisy_depth_maps(noisy_png_dir,
                            (labels[i]["depth"] for i in range(len(labels))))
    noisy_maps = ImageFolderDataset(noisy_png_dir)

    print("Creating rendered images for noisy depth maps...")
    noisy_render_dir = os.path.join(noisy_dir, "rendered_images")
    create_rendered_images(noisy_render_dir, labels, depth_loader=noisy_maps,
                           fps=args.renderer_fps, device=device)
    noisy_renders = NestedImageFolderDataset(os.path.join(noisy_render_dir, "image"))

    run_benchmark(benchmark_results, dataset_name, "random", out_root,
                  labels, noisy_maps, gt_renders, noisy_renders,
                  args.baseline_model, args.batch_size, device=device)

    model_loaders = preset_model_loaders(args, labels_x32)
    for spec in args.models or []:
        name, _, path = spec.partition("=")
        if name.startswith("midas") or "-LR" in path or "lasinger" in path:
            model_loaders.append(
                (name, (lambda p=path: MidasModel(p, device=device)),
                 labels_x32))
        else:
            enc, _ = parse_checkpoint_name(path)
            model_loaders.append(
                (name, (lambda p=path, e=enc: ReSIDEModel(
                    p, encoder=e, device=device)), labels_x32))
    if args.include_flat and args.preset is None:
        # presets define their own tables (chapter4 already contains flat;
        # chapter3's has none — benchmark.py:513-557)
        model_loaders.append(("flat", FlatDepthEstimator, labels_x32))

    for model_name, model_loader, data in model_loaders:
        print("=" * 80)
        print(dataset_name, model_name)
        print("=" * 80)

        depth_dir = os.path.join(out_root, dataset_name, model_name, "depth")
        peak_mem, infer_time, io_time = create_depth_maps(
            depth_dir, model_loader, data, args.batch_size, device=device)
        no_io = infer_time - io_time
        results = benchmark_results[dataset_name][model_name]
        results["peak_memory_usage"] = peak_mem
        results["inference_time"] = infer_time.total_seconds()
        results["inference_time_no_io"] = no_io.total_seconds()
        results["frame_time"] = no_io.total_seconds() / len(data)

        outputs = ImageFolderDataset(os.path.join(depth_dir, "raw"))

        render_dir = os.path.join(out_root, dataset_name, model_name,
                                  "rendered_images")
        render_time = create_rendered_images(render_dir, labels,
                                             depth_loader=outputs,
                                             fps=args.renderer_fps,
                                             device=device)
        results["render_time"] = render_time.total_seconds()
        model_renders = NestedImageFolderDataset(os.path.join(render_dir, "image"))

        run_benchmark(benchmark_results, dataset_name, model_name, out_root,
                      data, outputs, gt_renders, model_renders,
                      args.baseline_model, args.batch_size, device=device)

    from PIL import Image

    base = os.path.join(out_root, dataset_name)
    for output_type in ("depth", "rendered_images"):
        try:
            grid = images_to_grid(base, output_type)
            Image.fromarray(grid).save(
                os.path.join(base, f"nyu-{output_type}.png"))
        except FileNotFoundError:
            pass

    plots = os.path.join(out_root, "plots")
    os.makedirs(plots, exist_ok=True)
    abs_csv = os.path.join(out_root, f"{dataset_name}.csv")
    rel_csv = os.path.join(out_root, f"{dataset_name}-relative.csv")
    if os.path.isfile(abs_csv) and os.path.isfile(rel_csv):
        visualise_results(plots, abs_csv, rel_csv, args.baseline_model)
    return benchmark_results


if __name__ == "__main__":
    main()
