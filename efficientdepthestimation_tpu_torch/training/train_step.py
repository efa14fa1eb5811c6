"""The training step: preprocess, forward, fused loss, backward, Adam, metrics.

Counterpart of ``efficientdepthestimation_tpu/training/train_step.py``:
``make_train_step`` (``:104-298``) with microbatch accumulation, the
``remat`` policies and ``split_preprocess``, ``make_grad_snapshot``
(``:308-349``) and the eval step (``:352-368``). JAX compiles the step into
one program; here it runs eagerly on the card, and it updates the model, its
BatchNorm statistics and the optimizer in place rather than returning new
arrays. The loss is always ``ops.kernels.fused_loss.fused_depth_loss``: its
kernel pair on the card, its plain versions on the CPU (the JAX flag
``--use-pallas-loss``, a TPU v5e choice, selects nothing here).

Randomness comes from ``torch.Generator``s seeded from (seed, step), so a
step's augmentation and drop-connect masks do not depend on what ran before
it, as ``fold_in(rng, step)`` makes them in JAX; the bits differ from
``jax.random``'s.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from efficientdepthestimation_tpu_torch.apps.common import resolve_device
from efficientdepthestimation_tpu_torch.data.transforms import (
    draw_augmentation,
    train_preprocess,
)
from efficientdepthestimation_tpu_torch.models.common import (
    frozen_statistics,
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
           "make_train_step", "make_grad_snapshot", "make_eval_step",
           "eval_sums", "REMAT_POLICIES"]

#: Recompute policies of the training forward: "full" recomputes all of it
#: in the backward pass (least activation memory), "dots" keeps the outputs
#: of convolutions and matrix products and recomputes the element-wise
#: work between them (JAX ``train_step.py:99-104``).
REMAT_POLICIES = ("full", "dots")

_aten = torch.ops.aten
_DOTS = {_aten.convolution.default, _aten.mm.default, _aten.addmm.default,
         _aten.bmm.default}


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
    schedule, and the number of steps taken. ``frozen_prefixes`` are the
    top-level modules that get no update; ``scheduled`` says whether the
    learning rate is a function of the update count (``step_lr``), which
    optax keeps a count for."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0
    frozen_prefixes: tuple[str, ...] = ()
    scheduled: bool = False

    def set_count(self, count: int) -> None:
        """Put the LR schedule at update ``count`` (a resume; Adam's
        per-parameter counts are restored with its moments)."""
        sched = self.scheduler
        sched.last_epoch = count
        lrs = [base * fn(count)
               for base, fn in zip(sched.base_lrs, sched.lr_lambdas)]
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        sched._last_lr = lrs


def create_train_state(model: nn.Module,
                       learning_rate: float | Callable[[int], float],
                       weight_decay: float = 1e-4,
                       frozen_prefixes: tuple[str, ...] = ()) -> TrainState:
    """Adam with L2 weight decay, the reference's ``Adam(lr,
    weight_decay)`` (train.py:104): the decay is added to the gradient
    before the moments, as ``optax.add_decayed_weights`` then
    ``optax.adam`` compute it. ``learning_rate`` is a constant or a
    function of the update count (``step_lr``). Parameters under
    ``frozen_prefixes`` (top-level module names, e.g. ``("E",)``; names
    the model lacks are dropped) get no gradient and no update."""
    schedule = (learning_rate if callable(learning_rate)
                else (lambda count: learning_rate))
    tops = {name.split(".", 1)[0] for name, _ in model.named_parameters()}
    frozen_prefixes = tuple(k for k in frozen_prefixes if k in tops)
    trained = []
    for name, p in model.named_parameters():
        frozen = name.split(".", 1)[0] in frozen_prefixes
        p.requires_grad_(not frozen)
        if not frozen:
            trained.append(p)
    # lr 1 scaled by the schedule: LambdaLR sets lr = 1 · schedule(count)
    optimizer = torch.optim.Adam(trained, lr=1.0, weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)
    return TrainState(model, optimizer, scheduler,
                      frozen_prefixes=frozen_prefixes,
                      scheduled=callable(learning_rate))


def step_seeds(seed: int, step: int) -> tuple[int, int]:
    """(augmentation, drop-connect) generator seeds of one step."""
    aug, drop = np.random.SeedSequence([seed, step]).generate_state(2)
    return int(aug), int(drop)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def model_forward(model: nn.Module, params: dict, images: torch.Tensor,
                  drop_seed: int, remat: str | None = None) -> torch.Tensor:
    """The training forward of ``model`` with ``params``
    (``torch.func.functional_call``), its drop-connect masks drawn from a
    generator seeded with ``drop_seed`` on the images' device.

    Under ``remat`` it runs in ``torch.utils.checkpoint``: the backward
    pass runs it again, with a generator seeded the same way, so that the
    recompute draws the same masks, and inside ``frozen_statistics``, so
    that the BN statistics move once. ``params`` are made outside, so a
    mixed-precision cast is not repeated by the recompute."""

    def run(x: torch.Tensor) -> torch.Tensor:
        gen = torch.Generator(device=x.device).manual_seed(drop_seed)
        return torch.func.functional_call(model, params, (x,),
                                          {"generator": gen})

    if remat is None:
        return run(images)
    runs = 0

    def once_then_frozen(x: torch.Tensor) -> torch.Tensor:
        nonlocal runs
        runs += 1
        if runs == 1:
            return run(x)
        with frozen_statistics(model):
            return run(x)

    kwargs = {}
    if remat == "dots":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(once_then_frozen, images, use_reentrant=False,
                      **kwargs)


def _inputs(batch: dict, aug_seed: int, draws, preprocess: bool,
            crop_hw: tuple[int, int], device) -> tuple:
    """(images, depths) of a batch on ``device``, through
    ``train_preprocess`` with the step's draws when ``preprocess``."""
    images = torch.as_tensor(batch["image"]).to(device)
    depths = torch.as_tensor(batch["depth"]).to(device)
    if preprocess:
        if draws is None:
            gen = torch.Generator().manual_seed(aug_seed)
            draws = draw_augmentation(gen, images.shape[0])
        images, depths = train_preprocess(images, depths, draws,
                                          crop_hw=crop_hw)
    return images, depths


def _cast(params: dict, mixed_precision: bool) -> dict:
    """Every f32 parameter in bf16 under mixed precision, once a step;
    gradients flow back through the cast to the f32 masters."""
    if not mixed_precision:
        return params
    return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
            for k, v in params.items()}


def _fill_missing_grads(optimizer: torch.optim.Optimizer) -> None:
    """A zero gradient for each trained parameter the loss does not reach
    (MidasNet's deepest ``res_block2``): optax decays and moves it, where
    torch's Adam would skip a parameter without a gradient."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def make_train_step(*, preprocess: bool = True, mixed_precision: bool = False,
                    crop_hw: tuple[int, int] = (228, 304), device=None,
                    split_preprocess: bool = False, remat: str | None = None,
                    accum_steps: int = 1):
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

    ``remat`` ("full", "dots" or None) recomputes the forward in the
    backward pass (``model_forward``). ``accum_steps`` > 1 runs the batch as
    that many microbatches, in order, through forward and backward,
    accumulating the gradient (JAX ``:234-298``): BN statistics stream
    through the microbatches; each microbatch's loss is weighted by its
    valid images over the batch's, so the gradient is the masked batch's
    by linearity, with ``max(valid, 1)`` in its loss and metric
    denominators, and the metric sums of an all-padding microbatch are 0;
    each microbatch draws its own drop-connect masks. ``split_preprocess``
    is accepted so that the JAX package's command lines run unchanged: JAX
    compiles the augmentation as a program of its own there, and an eager
    step already runs it before the forward, with the same result.

    The returned ``train_step(state, batch, seed, draws=None)`` takes a
    batch dict with an optional ``num_valid`` (the images after it carry
    no weight) and returns ``(state, metrics)``: the same state, updated in
    place, and the ``depth_metrics_batch`` sums plus ``loss`` as 0-d
    tensors on the device, unsynchronised. ``draws`` replaces the
    augmentation draws of the step (``draw_augmentation``), for tests.
    """
    if remat is not None and remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got "
                         f"{remat!r}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    device = resolve_device(device)

    def train_step(state: TrainState, batch: dict, seed: int, draws=None):
        model = state.model.train()
        aug_seed, drop_seed = step_seeds(seed, state.step)
        num_valid = batch.get("num_valid")
        images, depths = _inputs(batch, aug_seed, draws, preprocess, crop_hw,
                                 device)
        if mixed_precision:
            images = images.to(torch.bfloat16)
        params = _cast(dict(model.named_parameters()), mixed_precision)
        state.optimizer.zero_grad(set_to_none=True)
        if accum_steps == 1:
            out = model_forward(model, params, images, drop_seed, remat)
            loss = fused_depth_loss(out, depths, num_valid)
            loss.backward()
            with torch.no_grad():
                metrics = depth_metrics_batch(out.detach(), depths, num_valid)
            metrics["loss"] = loss.detach()
        else:
            metrics = _accumulate(model, params, images, depths, num_valid,
                                  drop_seed, remat, accum_steps)
        _fill_missing_grads(state.optimizer)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state, metrics

    return train_step


def _accumulate(model, params, images, depths, num_valid, drop_seed, remat,
                accum_steps) -> dict:
    """Forward and backward over ``accum_steps`` microbatches in order,
    gradients summed into ``.grad``; the summed metric sums and loss."""
    n = images.shape[0]
    if n % accum_steps:
        raise ValueError(f"batch {n} not divisible by accum_steps "
                         f"{accum_steps}")
    micro = n // accum_steps
    valid = n if num_valid is None else int(num_valid)
    total = float(n if num_valid is None else max(valid, 1))
    seeds = np.random.SeedSequence([drop_seed]).generate_state(accum_steps)
    metrics = None
    for i, seed in enumerate(seeds):
        part = slice(i * micro, (i + 1) * micro)
        vcount = min(max(valid - i * micro, 0), micro)
        out = model_forward(model, params, images[part], int(seed), remat)
        loss = fused_depth_loss(out, depths[part], max(vcount, 1))
        scaled = loss * (vcount / total)
        scaled.backward()
        with torch.no_grad():
            sums = depth_metrics_batch(out.detach(), depths[part],
                                       max(vcount, 1))
            if vcount == 0:
                sums = {k: torch.zeros_like(v) for k, v in sums.items()}
            sums["loss"] = scaled.detach()
            metrics = sums if metrics is None else {
                k: metrics[k] + v for k, v in sums.items()}
    return metrics


def make_grad_snapshot(*, preprocess: bool = True,
                       mixed_precision: bool = False,
                       crop_hw: tuple[int, int] = (228, 304), device=None):
    """Build the gradient probe for the per-epoch histograms (wandb.watch
    parity, ReSIDE/train.py:134; JAX ``train_step.py:308-349``): the
    training step's loss and gradient, applied to nothing.

    The returned ``grad_snapshot(state, batch, seed)`` draws the step's
    augmentation and masks as ``make_train_step`` does for ``state.step``
    and returns ``{parameter name: gradient}`` for every parameter, frozen
    ones included; the weights, their ``.grad``, the BN statistics and the
    optimizer are left as they were."""
    device = resolve_device(device)

    def grad_snapshot(state: TrainState, batch: dict, seed: int) -> dict:
        model = state.model.train()
        aug_seed, drop_seed = step_seeds(seed, state.step)
        images, depths = _inputs(batch, aug_seed, None, preprocess, crop_hw,
                                 device)
        if mixed_precision:
            images = images.to(torch.bfloat16)
        leaves = {k: p.detach().requires_grad_()
                  for k, p in model.named_parameters()}
        with frozen_statistics(model):
            out = model_forward(model, _cast(leaves, mixed_precision),
                                images, drop_seed)
        loss = fused_depth_loss(out, depths, batch.get("num_valid"))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return {k: torch.zeros_like(v) if g is None else g
                for (k, v), g in zip(leaves.items(), grads)}

    return grad_snapshot


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
