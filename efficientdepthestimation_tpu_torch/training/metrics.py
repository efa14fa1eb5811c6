"""Depth metrics with the reference's exact masking and weighting.

Counterpart of ``efficientdepthestimation_tpu/training/metrics.py:38-95``
and its host trackers. ``depth_metrics_batch`` is one reduction on the
device returning per-batch sums, so the training loop reads them back once
a step. Reference quirks reproduced intentionally (ReSIDE/util.py):

* ``num_valid`` counts non-NaN labels (not positive ones), util.py:50;
* mae/mse/abs_rel/δ sums are scaled by batch_size before the running
  average; log10 is not (util.py:57-68);
* δ thresholds count *all* pixels whose max-ratio passes (invalid pixels
  included; NaN comparisons are False), divided by num_valid (util.py:70-73);
* the running ``AverageMeter`` ignores NaN/inf updates (util.py:125-134).

The Sobel edge metrics belong to evaluation (ROADMAP A9).
"""

from __future__ import annotations

import math

import torch

from efficientdepthestimation_tpu_torch.training.loss import (
    sample_mask as sample_mask_of,
)

__all__ = ["depth_metrics_batch", "AverageMeter", "MetricsTracker"]


def depth_metrics_batch(outputs: torch.Tensor, labels: torch.Tensor,
                        num_valid=None) -> dict[str, torch.Tensor]:
    """Per-batch metric sums; outputs/labels (N, H, W, 1) or (N, H, W).

    ``num_valid`` (None, an int or a 0-d tensor) marks only the first
    ``num_valid`` samples as real: the ``pad_last`` duplicates are left out
    of every sum and of the reported ``batch_size``.
    """
    outputs = outputs.float()
    labels = labels.float()
    n = labels.shape[0]
    sample_mask = sample_mask_of(n, num_valid, labels.device).bool()
    pix_mask = sample_mask.reshape((n,) + (1,) * (labels.dim() - 1))

    nan_mask = torch.isnan(labels)
    invalid_mask = ~(labels > 0)
    num_valid_px = ((~nan_mask) & pix_mask).sum().float()
    batch_size = sample_mask.sum().float()

    residuals = outputs - labels
    zero = torch.zeros((), device=labels.device)
    abs_res = torch.where(pix_mask, residuals.abs(), zero)
    mae = batch_size * abs_res.sum() / num_valid_px
    mse = batch_size * torch.where(pix_mask, residuals.square(),
                                   zero).sum() / num_valid_px

    excluded = nan_mask | invalid_mask | ~pix_mask
    abs_rel = torch.where(excluded, zero, residuals.abs() / labels)
    abs_rel = batch_size * abs_rel.sum() / num_valid_px

    log10 = torch.abs(torch.log10(outputs) - torch.log10(labels))
    log10 = torch.where(excluded, zero, log10).sum() / num_valid_px

    max_ratio = torch.maximum(outputs / labels, labels / outputs)

    def thr(t):
        hits = (max_ratio <= t) & pix_mask
        return batch_size * hits.float().sum() / num_valid_px

    return {"mae": mae, "mse": mse, "abs_rel": abs_rel, "log10": log10,
            "delta1": thr(1.25), "delta2": thr(1.25 ** 2),
            "delta3": thr(1.25 ** 3), "batch_size": batch_size}


class AverageMeter:
    """Running average; NaN/inf updates are ignored (util.py:110-134)."""

    def __init__(self):
        self._sum = 0.0
        self._count = 0

    @property
    def value(self) -> float:
        try:
            return self._sum / self._count
        except ZeroDivisionError:
            return float("nan")

    def update(self, value, num_elements: int = 1) -> None:
        value = float(value)
        if not math.isnan(value) and not math.isinf(value):
            self._sum += value
            self._count += num_elements

    def __format__(self, format_spec):
        return f"{self.value:{format_spec}}"


class MetricsTracker:
    """Running averages over batches, fed with ``depth_metrics_batch``
    sums that are already on the host."""

    METRIC_KEYS = ("mae", "mse", "abs_rel", "log10", "delta1", "delta2",
                   "delta3")

    def __init__(self):
        for key in self.METRIC_KEYS:
            setattr(self, key, AverageMeter())
        self.rmse = 0.0

    def __getitem__(self, item):
        return getattr(self, item.lower())

    def update_from_sums(self, sums: dict) -> None:
        bs = int(sums["batch_size"])
        for key in self.METRIC_KEYS:
            getattr(self, key).update(float(sums[key]), bs)
        mse = self.mse.value
        self.rmse = math.sqrt(mse) if mse == mse else 0.0

    def to_dict(self) -> dict[str, float]:
        out = {key: getattr(self, key).value for key in self.METRIC_KEYS}
        out["rmse"] = self.rmse
        return out

    def __str__(self):
        return (
            f"ABS_REL: {self.abs_rel:.3f} - MAE: {self.mae:.3f} - "
            f"MSE: {self.mse:.3f} - RMSE: {self.rmse:.3f} - "
            f"LOG10: {self.log10:.3f} - DELTA1: {self.delta1:.3f} - "
            f"DELTA2: {self.delta2:.3f} - DELTA3: {self.delta3:.3f}        "
        )
