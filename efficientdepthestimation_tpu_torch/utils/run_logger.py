"""Experiment tracking: wandb if importable, local JSONL otherwise.

A copy of ``efficientdepthestimation_tpu/utils/run_logger.py`` for the port.
It mirrors the surface the reference uses (ReSIDE/train.py:111-194):
init/config, run naming '{enc}-{dec}-{id}', per-epoch ``log``, monotone
``summary``, parameter and gradient histograms, and example depth images.
Without wandb, or with ``WANDB_MODE=disabled``, a run is logged under
``runs/<name>/``: ``config.json``, ``log.jsonl``, ``histograms.jsonl``,
``summary.json`` and ``media/``.
"""

from __future__ import annotations

import json
import os
import secrets
import time

import numpy as np
import torch

__all__ = ["RunLogger"]


def _leaves(tree, prefix: str):
    """(name, leaf) of a nested dict of tensors or arrays, names joined
    with '/'."""
    for key, value in tree.items():
        name = f"{prefix}/{key}"
        if isinstance(value, dict):
            yield from _leaves(value, name)
        else:
            yield name, value


class RunLogger:
    def __init__(self, project: str, config: dict, run_dir: str = "runs",
                 name_prefix: str = "run"):
        self.run_id = secrets.token_hex(4)
        self.name = f"{name_prefix}-{self.run_id}"
        self.summary: dict = {}
        self._wandb = None
        if os.environ.get("WANDB_MODE", "") != "disabled":
            try:
                import wandb

                wandb.init(project=project, config=config)
                wandb.run.name = self.name
                self._wandb = wandb
                self.dir = wandb.run.dir
            except Exception:  # no wandb, or it cannot start: log locally
                self._wandb = None
        if self._wandb is None:
            self.dir = os.path.join(run_dir, self.name)
            os.makedirs(self.dir, exist_ok=True)
            with open(os.path.join(self.dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)
            self._log_file = open(os.path.join(self.dir, "log.jsonl"), "a")

    def set_summary(self, key: str, value):
        self.summary[key] = value
        if self._wandb is not None:
            self._wandb.summary[key] = value

    def log(self, metrics: dict, step: int | None = None):
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
            return
        record = {"_time": time.time(), "_step": step}
        for key, value in metrics.items():
            if isinstance(value, np.ndarray):
                continue  # images go through log_images
            record[key] = float(value) if hasattr(value, "__float__") else value
        self._log_file.write(json.dumps(record, default=str) + "\n")
        self._log_file.flush()

    def log_histograms(self, tree: dict, step: int | None = None,
                       prefix: str = "parameters", bins: int = 64):
        """Per-leaf histograms of a nested dict of tensors or arrays (the
        parameters, or a gradient snapshot): ``wandb.watch(model)``'s
        histograms (ReSIDE/train.py:134). wandb runs get
        ``wandb.Histogram``s; local runs get (counts, range) records in
        ``histograms.jsonl``."""
        histograms = {}
        for name, leaf in _leaves(tree, prefix):
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach().cpu().double().numpy()
            arr = np.asarray(leaf).ravel()
            if arr.size == 0 or not np.issubdtype(arr.dtype, np.number):
                continue
            arr = arr.astype(np.float64)
            arr = arr[np.isfinite(arr)]
            if arr.size == 0:
                continue
            histograms[name] = np.histogram(arr, bins=bins)
        if self._wandb is not None:
            self._wandb.log(
                {name: self._wandb.Histogram(np_histogram=h)
                 for name, h in histograms.items()}, step=step)
            return
        record = {"_time": time.time(), "_step": step}
        for name, (counts, edges) in histograms.items():
            record[name] = {"counts": counts.tolist(),
                            "min": float(edges[0]), "max": float(edges[-1])}
        with open(os.path.join(self.dir, "histograms.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_images(self, name: str, images, step: int | None = None):
        """Save example images (scaled [0,1]) as PNGs under the run dir."""
        from PIL import Image

        out_dir = os.path.join(self.dir, "media", name)
        os.makedirs(out_dir, exist_ok=True)
        for i, img in enumerate(np.asarray(images)):
            arr = np.clip(np.squeeze(img) * 255.0, 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(
                os.path.join(out_dir, f"step{step or 0:04d}_{i:02d}.png"))

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
        else:
            with open(os.path.join(self.dir, "summary.json"), "w") as f:
                json.dump(self.summary, f, indent=2, default=str)
            self._log_file.close()
