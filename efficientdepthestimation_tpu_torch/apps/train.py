"""One training epoch with metrics drained one step behind, and one eval
epoch.

Counterpart of ``run_train_epoch`` and ``run_eval_epoch`` in
``efficientdepthestimation_tpu/apps/train.py:487-578``. The training CLI
(``main``: run logging, train-state checkpoints, ``--resume`` and SIGTERM)
is ROADMAP A10's next part; the mesh and sharding arguments are A11's.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.apps.common import resolve_device
from efficientdepthestimation_tpu_torch.data.datasets import batch_iterator
from efficientdepthestimation_tpu_torch.data.transforms import eval_preprocess
from efficientdepthestimation_tpu_torch.training.metrics import (
    MetricsTracker,
)

__all__ = ["epoch_seed", "run_train_epoch", "run_eval_epoch"]


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed the steps of ``epoch`` derive their generators from."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])


def run_train_epoch(state, train_step, dataset, batch_size: int, seed: int,
                    epoch: int, *, skip_batches: int = 0, save_every: int = 0,
                    checkpoint_cb=None, stop_after_steps=None, device=None):
    """One training epoch with metrics read back one step behind.

    The host reads step k's metrics only after step k+1 is queued, so
    reporting never stalls the card between steps; the progress line shows
    the previous step's numbers. Batches are shuffled by ``epoch``, the last
    one padded (``pad_last``) and its duplicates masked in the step through
    ``num_valid``. ``checkpoint_cb(state, epoch, step_in_epoch)`` runs every
    ``save_every`` steps and when ``stop_after_steps`` global steps are
    reached, which ends the epoch early. A mid-epoch stop is exact to resume
    with ``skip_batches``: the shuffle is seeded by ``epoch`` and each step's
    generators by (``epoch_seed(seed, epoch)``, ``state.step``). Batches go
    to ``device`` (the CUDA card unless ``device="cpu"``). Returns
    ``(state, {"loss": mean loss}, stopped)``.
    """
    device = resolve_device(device)
    tracker = MetricsTracker()
    loss_sum, loss_n = 0.0, 0
    epoch_start = datetime.datetime.now()
    seen = min(skip_batches * batch_size, len(dataset))
    start_step = state.step
    step_seed = epoch_seed(seed, epoch)
    pending = None  # metrics of the step before the one just queued

    def drain(pending):
        nonlocal loss_sum, loss_n
        host = {k: float(v) for k, v in pending.items()}
        tracker.update_from_sums(host)
        loss_sum += host["loss"]
        loss_n += 1
        dt = (datetime.datetime.now() - epoch_start).total_seconds()
        print(f"\rTrain [{seen:05d}/{len(dataset):05d}] - "
              f"({dt / max(seen, 1):.4f}s/image) - "
              f"Loss: {host['loss']:.3f} (Avg.: {loss_sum / loss_n:.3f}) - "
              f"{tracker}", end="", flush=True)

    steps_done = skip_batches
    for batch in batch_iterator(dataset, batch_size, shuffle=True, seed=epoch,
                                pad_last=True, skip_batches=skip_batches):
        fed = {"image": torch.from_numpy(batch["image"]).to(device),
               "depth": torch.from_numpy(batch["depth"]).to(device),
               "num_valid": int(batch["num_valid"])}
        state, metrics = train_step(state, fed, step_seed)
        seen += fed["num_valid"]
        steps_done += 1
        if pending is not None:
            drain(pending)
        pending = metrics

        stop = (stop_after_steps is not None
                and start_step + (steps_done - skip_batches)
                >= stop_after_steps)
        if checkpoint_cb is not None and (
                stop or (save_every and steps_done % save_every == 0)):
            checkpoint_cb(state, epoch, steps_done)
        if stop:
            drain(pending)
            print()
            return state, {"loss": loss_sum / max(loss_n, 1)}, True
    if pending is not None:
        drain(pending)
    print()
    return state, {"loss": loss_sum / max(loss_n, 1)}, False


def run_eval_epoch(state, eval_step, dataset, batch_size: int,
                   crop_hw: tuple[int, int] = (228, 304), *, device=None
                   ) -> MetricsTracker:
    """One pass of ``eval_step`` (``make_eval_step``) over a test split of
    uint8 frames and 16-bit mm depths: ``eval_preprocess`` on ``device``
    (the CUDA card unless ``device="cpu"``), the step, and the tracker fed
    with each batch's sums. The last batch is padded (``pad_last``) and its
    duplicates masked through ``num_valid``. Returns the tracker."""
    device = resolve_device(device)
    tracker = MetricsTracker()
    seen = 0
    epoch_start = datetime.datetime.now()
    for batch in batch_iterator(dataset, batch_size, pad_last=True):
        images, depths = eval_preprocess(
            torch.from_numpy(batch["image"]).to(device),
            torch.from_numpy(batch["depth"]).to(device), crop_hw=crop_hw)
        sums, _ = eval_step(state, images, depths, int(batch["num_valid"]))
        tracker.update_from_sums(sums)
        seen += int(batch["num_valid"])
        dt = (datetime.datetime.now() - epoch_start).total_seconds()
        print(f"\rVal [{seen:05d}/{len(dataset):05d}] - "
              f"({dt / max(seen, 1):.4f}s/image) - {tracker}", end="",
              flush=True)
    print()
    return tracker
