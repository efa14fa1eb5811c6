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

Under a data-parallel ``parallel.Mesh`` of more than one rank (one process
a device) each rank holds its rows of the global batch, and the step is
the one-process step on the whole batch: the augmentation and the
drop-connect masks are drawn for the global batch and taken at the rank's
rows, the BatchNorm statistics are the global batch's
(``models.common.batch_share``), each rank's loss is its rows' share of the
global mean (the fused loss's ``denominator``), and after the backward pass
the gradients are summed over the ranks. ``DistributedDataParallel`` does
not fit: ``model_forward`` runs the model through
``torch.func.functional_call`` on cast copies of the parameters, so DDP's
forward hook never runs, and its reducer would not see the microbatches of
``accum_steps`` as one step. So the step all-reduces the ``.grad`` buffers
itself, in a few flat buckets (``parallel.mesh.all_reduce_flat``), once
after the last microbatch (DDP's ``no_sync`` for the others). Only
``all_reduce`` and ``broadcast`` are used, which gloo also takes on CUDA
tensors. A mesh of one rank issues no collective and changes nothing.

ZeRO-1 (``create_train_state(..., mesh=..., zero1=True)``) shards Adam's
moments by whole parameters (``parallel.zero1_shardings``): each rank's
``torch.optim.Adam`` holds and updates only the parameters it owns, from
the all-reduced gradient, and then broadcasts them to the other ranks, one
flat bucket an owner. The update is element-wise, so the weights are those
of the unsharded optimizer bit for bit; ``checkpoints.serialization``
gathers the moments before a write.
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
    BatchShare,
    batch_share,
    frozen_statistics,
)
from efficientdepthestimation_tpu_torch.ops.kernels.fused_loss import (
    fused_depth_loss,
)
from efficientdepthestimation_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
)
from efficientdepthestimation_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    all_reduce_flat,
    broadcast_flat,
    zero1_shardings,
)
from efficientdepthestimation_tpu_torch.parallel.multihost import (
    process_local_rows,
)
from efficientdepthestimation_tpu_torch.training.metrics import (
    depth_metric_parts,
    depth_metrics_batch,
    finish_depth_metrics,
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
    optax keeps a count for. ``mesh`` is the data-parallel mesh the state
    is replicated over (None: one process); ``owners`` maps each trained
    parameter to the rank whose optimizer holds its moments under ZeRO-1
    (None without it)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0
    frozen_prefixes: tuple[str, ...] = ()
    scheduled: bool = False
    mesh: Mesh | None = None
    owners: dict[str, int] | None = None

    def trained(self) -> list[tuple[str, nn.Parameter]]:
        """(name, parameter) of every parameter that gets updates."""
        return [(k, p) for k, p in self.model.named_parameters()
                if p.requires_grad]

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
                       frozen_prefixes: tuple[str, ...] = (), *,
                       mesh: Mesh | None = None,
                       zero1: bool = False) -> TrainState:
    """Adam with L2 weight decay, the reference's ``Adam(lr,
    weight_decay)`` (train.py:104): the decay is added to the gradient
    before the moments, as ``optax.add_decayed_weights`` then
    ``optax.adam`` compute it. ``learning_rate`` is a constant or a
    function of the update count (``step_lr``). Parameters under
    ``frozen_prefixes`` (top-level module names, e.g. ``("E",)``; names
    the model lacks are dropped) get no gradient and no update.

    Under a ``mesh`` of more than one rank, rank 0's weights and statistics
    are broadcast to the others, so that every replica starts equal.
    ``zero1`` gives each rank an optimizer over the parameters it owns
    (``parallel.zero1_shardings``; all of them in a world of one)."""
    schedule = (learning_rate if callable(learning_rate)
                else (lambda count: learning_rate))
    tops = {name.split(".", 1)[0] for name, _ in model.named_parameters()}
    frozen_prefixes = tuple(k for k in frozen_prefixes if k in tops)
    trained = []
    for name, p in model.named_parameters():
        frozen = name.split(".", 1)[0] in frozen_prefixes
        p.requires_grad_(not frozen)
        if not frozen:
            trained.append((name, p))
    with torch.no_grad():
        broadcast_flat(list(model.parameters()) + list(model.buffers()), 0,
                       mesh)
    owners = None
    if zero1:
        if mesh is None:
            raise ValueError("zero1 needs the mesh its moments are sharded "
                             "over")
        if mesh.shape["model"] != 1:
            raise ValueError("ZeRO-1 shards over a data axis of every rank "
                             "(model axis 1)")
        owners = zero1_shardings(trained, mesh)
        trained = [(k, p) for k, p in trained if owners[k] == mesh.rank]
        if not trained:
            raise ValueError(f"ZeRO-1: rank {mesh.rank} owns no parameter "
                             f"of {len(owners)}")
    # lr 1 scaled by the schedule: LambdaLR sets lr = 1 · schedule(count)
    optimizer = torch.optim.Adam([p for _, p in trained], lr=1.0,
                                 weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)
    return TrainState(model, optimizer, scheduler,
                      frozen_prefixes=frozen_prefixes,
                      scheduled=callable(learning_rate), mesh=mesh,
                      owners=owners)


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
            crop_hw: tuple[int, int], device, rows=None) -> tuple:
    """(images, depths) of a batch on ``device``, through
    ``train_preprocess`` with the step's draws when ``preprocess``. With
    ``rows`` (the global rows the batch holds, ``process_local_rows``) the
    draws are those of the global batch, taken at these rows."""
    images = torch.as_tensor(batch["image"]).to(device)
    depths = torch.as_tensor(batch["depth"]).to(device)
    if preprocess:
        if draws is None:
            gen = torch.Generator().manual_seed(aug_seed)
            n = images.shape[0] if rows is None else rows.global_size
            draws = draw_augmentation(gen, n)
        if rows is not None and not rows.whole:
            at = torch.from_numpy(rows.indices)
            draws = {k: v if k == "order" else v[at.to(v.device)]
                     for k, v in draws.items()}
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


def _fill_missing_grads(params: list[nn.Parameter]) -> None:
    """A zero gradient for each trained parameter the loss does not reach
    (MidasNet's deepest ``res_block2``): optax decays and moves it, where
    torch's Adam would skip a parameter without a gradient. Every rank
    fills all of them, so that the gradient buckets line up under ZeRO-1,
    where a rank's optimizer holds only its own."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


@dataclasses.dataclass(frozen=True)
class _Rows:
    """A rank's rows of a step's global batch of ``global_size`` with
    ``valid`` valid rows: ``indices`` (global, in the local batch's order),
    split into microbatches of ``micro`` global rows, of which the rank
    holds ``local_micro`` from offset ``start`` of each. Without a mesh of
    several ranks the rows are the whole batch."""

    indices: np.ndarray
    global_size: int
    valid: int
    micro: int
    local_micro: int
    start: int

    @classmethod
    def of(cls, mesh: Mesh | None, local_size: int, num_valid,
           accum_steps: int) -> "_Rows":
        distributed = mesh is not None and mesh.distributed
        total = local_size * (mesh.shape["data"] if distributed else 1)
        if local_size % accum_steps:
            raise ValueError(f"batch {local_size} not divisible by "
                             f"accum_steps {accum_steps}")
        micro = total // accum_steps
        local_micro = local_size // accum_steps
        indices = (process_local_rows(mesh, total, accum_steps)
                   if distributed else np.arange(total))
        return cls(indices, total,
                   total if num_valid is None else int(num_valid), micro,
                   local_micro,
                   mesh.data_index * local_micro if distributed else 0)

    @property
    def whole(self) -> bool:
        """Whether the rank holds the whole batch (a world of one)."""
        return len(self.indices) == self.global_size

    def micro_valid(self, i: int) -> int:
        """Valid rows of global microbatch ``i``."""
        return min(max(self.valid - i * self.micro, 0), self.micro)

    def local_valid(self, i: int) -> int:
        """Valid rows of this rank's block of microbatch ``i`` (a prefix of
        the block, as ``num_valid`` masks)."""
        return min(max(self.valid - i * self.micro - self.start, 0),
                   self.local_micro)


def make_train_step(*, preprocess: bool = True, mixed_precision: bool = False,
                    crop_hw: tuple[int, int] = (228, 304), device=None,
                    split_preprocess: bool = False, remat: str | None = None,
                    accum_steps: int = 1, mesh: Mesh | None = None):
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
    batch dict with an optional ``num_valid`` (an int: the images after it
    carry no weight) and returns ``(state, metrics)``: the same state,
    updated in place, and the ``depth_metrics_batch`` sums plus ``loss`` as
    0-d tensors on the device, unsynchronised. ``draws`` replaces the
    augmentation draws of the step (``draw_augmentation``), for tests; under
    a mesh they are the global batch's.

    ``mesh`` (a ``parallel.Mesh``; its device is the step's unless
    ``device`` is given) makes the step data-parallel: ``batch`` holds the
    rank's rows of the global batch (``parallel.process_local_rows`` with
    ``accum_steps``, as ``distributed_batch_iterator`` yields them) and
    ``num_valid`` the global batch's valid rows; the returned metrics are
    the global batch's, on every rank. ZeRO-1 is the state's
    (``create_train_state(..., zero1=True)``).
    """
    if remat is not None and remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got "
                         f"{remat!r}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if mesh is not None and mesh.shape["model"] != 1:
        raise ValueError("the training step shards over a data axis of "
                         "every rank (model axis 1)")
    device = resolve_device(mesh.device if device is None and mesh
                            is not None else device)
    distributed = mesh is not None and mesh.distributed

    def train_step(state: TrainState, batch: dict, seed: int, draws=None):
        if (distributed or state.mesh is not None
                and state.mesh.distributed) and state.mesh is not mesh:
            raise ValueError("the train state was not built for this step's "
                             "mesh (create_train_state)")
        model = state.model.train()
        aug_seed, drop_seed = step_seeds(seed, state.step)
        rows = _Rows.of(mesh, len(batch["image"]), batch.get("num_valid"),
                        accum_steps)
        images, depths = _inputs(batch, aug_seed, draws, preprocess, crop_hw,
                                 device, rows)
        if mixed_precision:
            images = images.to(torch.bfloat16)
        params = _cast(dict(model.named_parameters()), mixed_precision)
        trained = [p for _, p in state.trained()]
        for p in trained:
            p.grad = None
        metrics = _forward_backward(model, params, images, depths, rows,
                                    drop_seed, remat, mesh)
        _fill_missing_grads(trained)
        with torch.no_grad():
            all_reduce_flat([p.grad for p in trained], mesh)
            state.optimizer.step()
            if state.owners is not None:
                _broadcast_owned(state)
        state.scheduler.step()
        state.step += 1
        return state, metrics

    return train_step


def _broadcast_owned(state: TrainState) -> None:
    """Every rank's updated parameters to the others, in flat buckets from
    each owner in turn (ZeRO-1; nothing in a world of one)."""
    named = state.trained()
    for owner in range(state.mesh.shape["data"]):
        broadcast_flat([p for k, p in named if state.owners[k] == owner],
                       owner, state.mesh)


def _forward_backward(model, params, images, depths, rows: _Rows, drop_seed,
                      remat, mesh: Mesh | None) -> dict:
    """Forward and backward of a rank's rows, microbatch by microbatch (one
    without accumulation), gradients summed into ``.grad``, as one process
    runs the global batch: each global microbatch's drop-connect masks and
    BatchNorm statistics, and each rank's loss its rows' share of the
    global microbatch's mean (the valid count of a microbatch of padding
    alone is taken as 1), weighted under accumulation by the microbatch's
    valid rows over the batch's. The metric parts and losses of every
    microbatch are summed over the ranks in one collective (none in a world
    of one); returns the global batch's metrics."""
    accum_steps = rows.global_size // rows.micro
    total = float(max(rows.valid, 1))
    seeds = ([drop_seed] if accum_steps == 1 else
             np.random.SeedSequence([drop_seed]).generate_state(accum_steps))
    share = (None if rows.whole
             else BatchShare(mesh.group, rows.start, rows.micro))
    parts = []
    with batch_share(share):
        for i, seed in enumerate(seeds):
            part = slice(i * rows.local_micro, (i + 1) * rows.local_micro)
            vcount = rows.micro_valid(i)
            out = model_forward(model, params, images[part], int(seed), remat)
            loss = fused_depth_loss(out, depths[part], rows.local_valid(i),
                                    denominator=max(vcount, 1))
            if accum_steps > 1:
                loss = loss * (vcount / total)
            loss.backward()
            with torch.no_grad():
                parts.append(torch.cat([
                    depth_metric_parts(out.detach(), depths[part],
                                       rows.local_valid(i)),
                    loss.detach().float().reshape(1)]))
    sums = all_reduce_(torch.stack(parts), mesh)
    metrics = None
    for i, row in enumerate(sums):
        m = finish_depth_metrics(row[:-1])
        if rows.micro_valid(i) == 0:
            m = {k: torch.zeros_like(v) for k, v in m.items()}
        m["loss"] = row[-1]
        metrics = m if metrics is None else {k: metrics[k] + v
                                             for k, v in m.items()}
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


def make_eval_step(*, upsample_to_label: bool = True, device=None,
                   mesh: Mesh | None = None):
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

    Under a ``mesh`` of more than one rank (its device unless ``device`` is
    given) the images are the rank's rows of a global batch
    (``distributed_batch_iterator``) and ``num_valid`` the global batch's
    valid rows: the metric parts are summed over the ranks, so the sums are
    the global batch's on every rank, and ``out`` holds the rank's rows.
    """
    device = resolve_device(mesh.device if device is None and mesh
                            is not None else device)
    ranks = mesh.shape["data"] if mesh is not None else 1
    index = mesh.data_index if mesh is not None else 0

    @torch.inference_mode()
    def eval_step(state, images, depths, num_valid=None):
        model = state.model if isinstance(state, TrainState) else state
        images = torch.as_tensor(images).to(device)
        depths = torch.as_tensor(depths).to(device)
        local = images.shape[0]
        valid = local * ranks if num_valid is None else int(num_valid)
        local_valid = min(max(valid - index * local, 0), local)
        out = _forward_to_label(model.eval(), images, depths,
                                upsample_to_label)
        parts = all_reduce_(depth_metric_parts(out, depths, local_valid),
                            mesh)
        return sums_to_host(finish_depth_metrics(parts)), out

    return eval_step


def _forward_to_label(model, images, depths, upsample_to_label: bool):
    out = model(images)
    if upsample_to_label:
        out = resize_bilinear_align_corners(out, depths.shape[1:3])
    return out


def eval_sums(model, images, depths, num_valid=None, *,
              upsample_to_label: bool = True):
    """The eval step's work on the tensors' device, for a model in eval
    mode: the forward, the align-corners upsample to the label size, the
    ``depth_metrics_batch`` sums. Returns ``(sums, out)`` with the sums
    still on the device, so that a caller can add sums of its own before
    the one copy back (``sums_to_host``)."""
    out = _forward_to_label(model, images, depths, upsample_to_label)
    return depth_metrics_batch(out, depths, num_valid), out
