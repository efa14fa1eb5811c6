"""Depth metrics with the reference's exact masking and weighting.

Counterpart of ``efficientdepthestimation_tpu/training/metrics.py``.
``depth_metrics_batch`` and ``edge_metrics_batch`` are reductions on the
device returning per-batch sums, and ``sums_to_host`` reads a batch's sums
back in one device-to-host copy, in place of the reference's ``.item()``
sync per metric (``MetricsTracker.update``, ReSIDE/util.py:39-92). Reference
quirks reproduced intentionally (ReSIDE/util.py):

* ``num_valid`` counts non-NaN labels (not positive ones), util.py:50;
* mae/mse/abs_rel/δ sums are scaled by batch_size before the running
  average; log10 is not (util.py:57-68);
* δ thresholds count *all* pixels whose max-ratio passes (invalid pixels
  included; NaN comparisons are False), divided by num_valid (util.py:70-73);
* the running ``AverageMeter`` ignores NaN/inf updates (util.py:125-134);
* an edge-metric ratio of 0/0 (a prediction with no Sobel magnitude above
  the threshold has no precision) is NaN, and the sums carry it
  (test.py:61-76).
"""

from __future__ import annotations

import math
import warnings
from typing import Callable

import torch

from efficientdepthestimation_tpu_torch.ops.sobel import sobel_gradients
from efficientdepthestimation_tpu_torch.training.loss import (
    sample_mask as sample_mask_of,
)

__all__ = ["depth_metrics_batch", "edge_metrics_batch", "sums_to_host",
           "MetricsMeter", "AverageMeter", "LambdaMeter", "MetricsTracker",
           "BestMetricsTracker"]


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


def edge_metrics_batch(outputs: torch.Tensor, labels: torch.Tensor,
                       threshold: float = 0.25,
                       num_valid=None) -> dict[str, torch.Tensor]:
    """Sobel-magnitude edge accuracy, precision, recall and F1
    (test.py:56-102); outputs/labels (N, H, W, 1) or (N, H, W).

    Computed per sample, then summed over the first ``num_valid`` samples
    (all when None): the reference's batch-1 accumulation loop
    (test.py:61-76). Divide the sums by the number of samples on the host
    to get its averages. The mask multiplies, as in the JAX package, so a
    NaN of a padded duplicate also reaches the sums.
    """
    if labels.dim() == 3:
        outputs, labels = outputs[..., None], labels[..., None]
    outputs, labels = outputs.float(), labels.float()

    def edges(x):
        gx, gy = sobel_gradients(x)
        return torch.sqrt(gx.square() + gy.square()) > threshold

    e1, e2 = edges(labels), edges(outputs)
    n = labels.shape[0]
    axes = tuple(range(1, labels.dim()))
    n_pixels = labels.shape[1] * labels.shape[2]
    accuracy = (e1 == e2).float().sum(dim=axes) / n_pixels
    both = (e1 & e2).float().sum(dim=axes)
    precision = both / e2.float().sum(dim=axes)
    recall = both / e1.float().sum(dim=axes)
    f1 = 2 * precision * recall / (precision + recall)
    mask = sample_mask_of(n, num_valid, labels.device).float()
    return {"edge_accuracy": (accuracy * mask).sum(),
            "edge_precision": (precision * mask).sum(),
            "edge_recall": (recall * mask).sum(),
            "edge_f1": (f1 * mask).sum()}


def sums_to_host(sums: dict[str, torch.Tensor]) -> dict[str, float]:
    """0-d metric sums on the device as host floats, in one copy."""
    keys = list(sums)
    values = torch.stack([sums[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, values))


class MetricsMeter:
    """A tracked value that formats like a float."""

    @property
    def value(self) -> float:
        raise NotImplementedError

    def __str__(self):
        return str(self.value)

    def __format__(self, format_spec):
        return f"{self.value:{format_spec}}"


class AverageMeter(MetricsMeter):
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


class LambdaMeter(MetricsMeter):
    """A metric tracked through a reducer such as ``min`` or ``max``
    (util.py:137-165); NaN/inf updates are ignored with a warning."""

    def __init__(self, lambda_fn: Callable[[float, float], float]):
        self._value = float("nan")
        self.lambda_fn = lambda_fn

    @property
    def value(self) -> float:
        return self._value

    def update(self, value) -> None:
        value = float(value)
        if math.isnan(value) or math.isinf(value):
            warnings.warn("Invalid value encountered (NaN or +/- infinity), "
                          "ignoring value.")
            return
        self._value = (value if math.isnan(self._value)
                       else self.lambda_fn(self._value, value))


class MetricsTracker:
    """Running averages over batches, fed with ``depth_metrics_batch``
    sums on the host (``update_from_sums``) or with a batch's outputs and
    labels (``update``)."""

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

    def update(self, outputs: torch.Tensor, labels: torch.Tensor) -> None:
        self.update_from_sums(sums_to_host(depth_metrics_batch(outputs,
                                                               labels)))

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


class BestMetricsTracker:
    """Best-so-far values across epochs (util.py:168-195): the least of
    each error, the most of each δ."""

    def __init__(self):
        for key in ("mae", "mse", "rmse", "abs_rel", "log10"):
            setattr(self, key, LambdaMeter(min))
        for key in ("delta1", "delta2", "delta3"):
            setattr(self, key, LambdaMeter(max))

    def __getitem__(self, item):
        return getattr(self, item)

    def update(self, metrics: MetricsTracker) -> None:
        for key in MetricsTracker.METRIC_KEYS:
            getattr(self, key).update(getattr(metrics, key).value)
        self.rmse.update(metrics.rmse)

    def to_dict(self) -> dict[str, float]:
        return {key: meter.value for key, meter in self.__dict__.items()}
