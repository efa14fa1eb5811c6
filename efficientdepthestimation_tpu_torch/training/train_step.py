"""The training step: preprocess, forward, fused loss, backward, Adam, metrics.

Counterpart of ``efficientdepthestimation_tpu/training/train_step.py``
(``:33-96, 191-232``) for ``accum_steps == 1``, and its eval step
(``:352-368``). JAX compiles the step into
one program; here it runs eagerly on the card, and it updates the model, its
BatchNorm statistics and the optimizer in place rather than returning new
arrays. The loss is always ``ops.kernels.fused_loss.fused_depth_loss``: its
kernel pair on the card, its plain versions on the CPU. The JAX flag
``--use-pallas-loss`` (a TPU v5e choice) has no counterpart.

Randomness comes from ``torch.Generator``s seeded from (seed, step), so a
step's augmentation and drop-connect masks do not depend on what ran before
it, as ``fold_in(rng, step)`` makes them in JAX; the bits differ from
``jax.random``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from efficientdepthestimation_tpu_torch.apps.common import resolve_device
from efficientdepthestimation_tpu_torch.data.transforms import (
    draw_augmentation,
    train_preprocess,
)
from efficientdepthestimation_tpu_torch.ops.kernels.fused_loss import (
    fused_depth_loss,
)
from efficientdepthestimation_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
)
from efficientdepthestimation_tpu_torch.training.metrics import (
    depth_metrics_batch,
    sums_to_host,
)

__all__ = ["TrainState", "step_lr", "create_train_state", "step_seeds",
           "make_train_step", "make_eval_step", "eval_sums"]


def step_lr(base_lr: float, steps_per_epoch: int, step_size: int = 5,
            gamma: float = 0.1) -> Callable[[int], float]:
    """torch StepLR(step_size=5, γ=0.1) stepped per epoch (reference
    train.py:105), as a function of the optimizer's update count."""

    def schedule(count: int) -> float:
        epoch = count // steps_per_epoch
        return base_lr * gamma ** (epoch // step_size)

    return schedule


@dataclasses.dataclass
class TrainState:
    """The model (f32 master weights, BN statistics), its optimizer and LR
    schedule, and the number of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def create_train_state(model: nn.Module,
                       learning_rate: float | Callable[[int], float],
                       weight_decay: float = 1e-4,
                       frozen_prefixes: tuple[str, ...] = ()) -> TrainState:
    """Adam with L2 weight decay, the reference's ``Adam(lr,
    weight_decay)`` (train.py:104): the decay is added to the gradient
    before the moments, as ``optax.add_decayed_weights`` then
    ``optax.adam`` compute it. ``learning_rate`` is a constant or a
    function of the update count (``step_lr``). Parameters under
    ``frozen_prefixes`` (top-level module names, e.g. ``("E",)``) get no
    gradient and no update."""
    schedule = (learning_rate if callable(learning_rate)
                else (lambda count: learning_rate))
    trained = []
    for name, p in model.named_parameters():
        frozen = name.split(".", 1)[0] in frozen_prefixes
        p.requires_grad_(not frozen)
        if not frozen:
            trained.append(p)
    # lr 1 scaled by the schedule: LambdaLR sets lr = 1 · schedule(count)
    optimizer = torch.optim.Adam(trained, lr=1.0, weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)
    return TrainState(model, optimizer, scheduler)


def step_seeds(seed: int, step: int) -> tuple[int, int]:
    """(augmentation, drop-connect) generator seeds of one step."""
    aug, drop = np.random.SeedSequence([seed, step]).generate_state(2)
    return int(aug), int(drop)


def make_train_step(*, preprocess: bool = True, mixed_precision: bool = False,
                    crop_hw: tuple[int, int] = (228, 304), device=None):
    """Build the training step for ``device`` (the CUDA card unless
    ``device="cpu"``).

    ``preprocess=True`` takes raw uint8 batches (image (N, 480, 640, 3),
    depth (N, 480, 640) stored ×25.5 per metre) and runs
    ``train_preprocess`` on the device; otherwise ``image``/``depth`` are
    already preprocessed. ``mixed_precision=True`` casts every f32
    parameter, BatchNorm scale and bias included, to bf16 once per step and
    runs the activations in bf16; gradients flow back through the cast to
    the f32 masters, and the BN statistics, the loss and Adam stay f32
    (``train_step.py:201-217``).

    The returned ``train_step(state, batch, seed, draws=None)`` takes a
    batch dict with an optional ``num_valid`` (the images after it carry
    no weight) and returns ``(state, metrics)``: the same state, updated in
    place, and the ``depth_metrics_batch`` sums plus ``loss`` as 0-d
    tensors on the device, unsynchronised. ``draws`` replaces the
    augmentation draws of the step (``draw_augmentation``), for tests.
    """
    device = resolve_device(device)

    def train_step(state: TrainState, batch: dict, seed: int, draws=None):
        model = state.model.train()
        aug_seed, drop_seed = step_seeds(seed, state.step)
        num_valid = batch.get("num_valid")
        images = torch.as_tensor(batch["image"]).to(device)
        depths = torch.as_tensor(batch["depth"]).to(device)
        if preprocess:
            if draws is None:
                gen = torch.Generator().manual_seed(aug_seed)
                draws = draw_augmentation(gen, images.shape[0])
            images, depths = train_preprocess(images, depths, draws,
                                              crop_hw=crop_hw)
        params = dict(model.named_parameters())
        if mixed_precision:
            images = images.to(torch.bfloat16)
            params = {k: v.to(torch.bfloat16) if v.dtype == torch.float32
                      else v for k, v in params.items()}
        drop_gen = torch.Generator(device=device).manual_seed(drop_seed)
        out = torch.func.functional_call(model, params, (images,),
                                         {"generator": drop_gen})
        loss = fused_depth_loss(out, depths, num_valid)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        with torch.no_grad():
            metrics = depth_metrics_batch(out.detach(), depths, num_valid)
        metrics["loss"] = loss.detach()
        return state, metrics

    return train_step


def make_eval_step(*, upsample_to_label: bool = True, device=None):
    """Build the eval step for ``device`` (the CUDA card unless
    ``device="cpu"``): the forward in eval mode, the align-corners upsample
    to the label size, the metric sums (reference train.py:259-292).

    The returned ``eval_step(state, images, depths, num_valid=None)`` takes
    a ``TrainState`` or a bare model, preprocessed images and depths (as
    ``eval_preprocess`` returns them); ``num_valid`` masks ``pad_last``
    duplicates out of the sums, so batched eval equals per-sample eval. It
    returns ``(sums, out)``: the ``depth_metrics_batch`` sums as host
    floats, read back in one copy, and the upsampled depth on the
    device.
    """
    device = resolve_device(device)

    @torch.inference_mode()
    def eval_step(state, images, depths, num_valid=None):
        model = state.model if isinstance(state, TrainState) else state
        images = torch.as_tensor(images).to(device)
        depths = torch.as_tensor(depths).to(device)
        sums, out = eval_sums(model.eval(), images, depths, num_valid,
                              upsample_to_label=upsample_to_label)
        return sums_to_host(sums), out

    return eval_step


def eval_sums(model, images, depths, num_valid=None, *,
              upsample_to_label: bool = True):
    """The eval step's work on the tensors' device, for a model in eval
    mode: the forward, the align-corners upsample to the label size, the
    ``depth_metrics_batch`` sums. Returns ``(sums, out)`` with the sums
    still on the device, so that a caller can add sums of its own before
    the one copy back (``sums_to_host``)."""
    out = model(images)
    if upsample_to_label:
        out = resize_bilinear_align_corners(out, depths.shape[1:3])
    return depth_metrics_batch(out, depths, num_valid), out
