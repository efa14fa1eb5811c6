"""Training CLI, the counterpart of ``python -m ReSIDE.train`` and of
``efficientdepthestimation_tpu/apps/train.py``.

The same flags (ReSIDE/train.py:52-67, and the JAX package's), on one CUDA
card unless ``--device cpu``. Per epoch: train → test → save the best
checkpoint by abs_rel → save the whole train state → log the metrics,
example depth images (÷10 m), parameter and gradient histograms, device
memory and per-frame times (train.py:140-191). A SIGTERM, or
``--stop-after-steps``, saves the train state at the next step boundary and
returns; ``--resume`` continues from it exactly, also from a file the JAX
package wrote. A tiny run on the CPU:

    python -m efficientdepthestimation_tpu_torch.apps.train \\
        --encoder resnet18 --epochs 1 --per-device-batch 2 \\
        --crop-hw 64 96 --train-csv data/train.csv --test-csv data/test.csv \\
        --device cpu

Under a launcher (``torchrun --nproc-per-node N -m
efficientdepthestimation_tpu_torch.apps.train ...``, or the JAX package's
``EDE_COORDINATOR_ADDRESS``/``EDE_NUM_PROCESSES``/``EDE_PROCESS_ID``) each
process drives one device of a data-parallel mesh (``parallel``): the batch
is ``--per-device-batch`` × the data axis, each rank decodes only its rows,
the BatchNorm statistics, loss, gradients and metrics are the global
batch's, and ``--zero1`` shards Adam's moments over the ranks. Rank 0
alone logs and writes. ``--accum-steps`` and ``--remat`` come from the
flags, else from the autotuner's measured policy (``--train-policy``, or
``runs/train_policy.json`` when it exists; ``apps.autotune``), else accum 1
and no remat.
"""

from __future__ import annotations

import argparse
import datetime
import os
import signal
import threading
from typing import List, Optional

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.apps.autotune import (
    TRAIN_POLICY_PATH,
    apply_train_policy,
)
from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
    resolve_device,
)
from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    to_jax_variables,
)
from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
    load_train_state,
    save_checkpoint,
    save_midas,
    save_train_state,
)
from efficientdepthestimation_tpu_torch.data.datasets import (
    DepthPairDataset,
    batch_iterator,
)
from efficientdepthestimation_tpu_torch.data.prefetch import device_prefetch
from efficientdepthestimation_tpu_torch.data.transforms import eval_preprocess
from efficientdepthestimation_tpu_torch.models.registry import build_model
from efficientdepthestimation_tpu_torch.parallel import (
    create_mesh,
    distributed_batch_iterator,
    maybe_initialize_distributed,
    scale_batch_size,
)
from efficientdepthestimation_tpu_torch.parallel.mesh import any_rank
from efficientdepthestimation_tpu_torch.training.metrics import (
    BestMetricsTracker,
    MetricsTracker,
)
from efficientdepthestimation_tpu_torch.training.train_step import (
    create_train_state,
    make_eval_step,
    make_grad_snapshot,
    make_train_step,
    step_lr,
)
from efficientdepthestimation_tpu_torch.utils.profiling import peak_memory
from efficientdepthestimation_tpu_torch.utils.run_logger import RunLogger
from efficientdepthestimation_tpu_torch.utils.timer import Timer

__all__ = ["parse_args", "main", "train_policy", "epoch_seed",
           "run_train_epoch", "run_eval_epoch"]

EFFICIENTNET_NAMES = [f"efficientnet-b{i}" for i in range(9)]
RESNET_NAMES = [f"resnet{i}" for i in (18, 50, 101, 152)]


def parse_args(args: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="Depth-estimation training")
    parser.add_argument("--encoder", default="resnet50", type=str,
                        choices=["densenet", "senet"] + EFFICIENTNET_NAMES
                        + RESNET_NAMES)
    parser.add_argument("--decoder", default="hu2018", type=str,
                        choices=("hu2018", "lasinger2019"))
    parser.add_argument("--epochs", default=20, type=int)
    parser.add_argument("--start-epoch", default=0, type=int)
    parser.add_argument("--lr", "--learning-rate", default=0.0001, type=float)
    parser.add_argument("--momentum", default=0.9, type=float)
    parser.add_argument("--weight-decay", "--wd", default=1e-4, type=float)
    parser.add_argument("--train-csv", default="./data/nyu2_train.csv",
                        type=str)
    parser.add_argument("--test-csv", default="./data/nyu2_test.csv",
                        type=str)
    parser.add_argument("--per-device-batch", default=8, type=int)
    parser.add_argument("--use-pallas-loss", action="store_true",
                        help="Accepted for the JAX package's command lines; "
                             "the loss is always the fused kernel pair here "
                             "(its plain versions on the CPU).")
    parser.add_argument("--split-preprocess", action="store_true",
                        help="Accepted for the JAX package's command lines; "
                             "an eager step runs the augmentation before "
                             "the forward anyway.")
    parser.add_argument("--zero1", action="store_true",
                        help="Shard the Adam moments across the data-parallel "
                             "ranks (ZeRO-1); the train state is written "
                             "whole, in the unsharded layout.")
    parser.add_argument("--bf16", action="store_true",
                        help="Mixed precision: bfloat16 activations, f32 "
                             "params/BN/loss/optimizer.")
    parser.add_argument("--freeze-encoder", action="store_true",
                        help="Train the decoder only (lasinger2019.py:36-38).")
    parser.add_argument("--resume", default=None, type=str,
                        help="Path to a train-state checkpoint (either "
                             "package's) for an exact resume.")
    parser.add_argument("--init-from", default=None, type=str,
                        help="Initialize the weights and BN statistics from "
                             "a model checkpoint (.ede or .pth) with a fresh "
                             "optimizer and schedule: a fine-tune, e.g. "
                             "decoder-only with --freeze-encoder. Not with "
                             "--resume.")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--crop-hw", nargs=2, type=int, default=[228, 304],
                        metavar=("H", "W"),
                        help="Network input crop (the reference hardcodes "
                             "304x228, nyu_transform.py:121-151); tests use "
                             "small crops.")
    parser.add_argument("--watch-every", default=1, type=int,
                        help="Log parameter/gradient histograms every N "
                             "epochs (wandb.watch parity, train.py:134); "
                             "0 disables.")
    parser.add_argument("--save-every", default=0, type=int,
                        help="Also save the whole train state every N steps "
                             "within an epoch (0 = per epoch only).")
    parser.add_argument("--accum-steps", default=None, type=int,
                        help="Microbatch gradient accumulation inside the "
                             "step; the per-device batch must divide by it "
                             "(default 1).")
    parser.add_argument("--remat", default="auto",
                        choices=("auto", "none", "dots", "full"),
                        help="Recompute the forward in the backward pass "
                             "(torch.utils.checkpoint): 'full', or 'dots', "
                             "which keeps conv and matmul outputs. 'auto': "
                             "a measured --train-policy applies, else none.")
    parser.add_argument("--train-policy", default=None, type=str,
                        help="Train-policy JSON of `ede-torch-autotune "
                             "--train` (default: runs/train_policy.json "
                             "when it exists).")
    parser.add_argument("--cache-ram", action="store_true",
                        help="Keep decoded images in RAM after the first "
                             "epoch (~1.2 GB per 1000 NYU-sized pairs).")
    parser.add_argument("--stop-after-steps", default=None, type=int,
                        help="Take the preemption path (save the train "
                             "state, return) after N global steps, as a "
                             "SIGTERM does at the next step boundary.")
    parser.add_argument("--device", default=None, type=str,
                        help="Device to run on (default: the CUDA card; "
                             "'cpu' runs the kernels' plain versions).")
    return parser.parse_args(args=args)


# Preemption: a scheduler that reclaims the machine sends SIGTERM with a
# grace window. The handler only sets the flag; the training loop saves the
# whole train state at the next step boundary and returns, so at most one
# step's work is lost.
_PREEMPTED = threading.Event()


def _install_preemption_handler():
    _PREEMPTED.clear()

    def handler(signum, frame):
        _PREEMPTED.set()
        print("\nSIGTERM: checkpointing train state at the next step "
              "boundary", flush=True)

    try:
        signal.signal(signal.SIGTERM, handler)
    except ValueError:  # not the main thread (e.g. driven from a test runner)
        pass


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed the steps of ``epoch`` derive their generators from."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])


def _epoch_batches(dataset, batch_size: int, device, *, shuffle=False,
                   seed=0, skip_batches=0, mesh=None, accum_steps=1):
    """The split's batches, the last one padded (``pad_last``), copied to
    ``device`` ahead of use (``device_prefetch``). Under a mesh of more than
    one rank, this rank's rows of each global batch of ``batch_size``
    (``distributed_batch_iterator``, decoding only those rows; JAX
    ``apps/train.py:179-191``)."""
    if mesh is not None and mesh.distributed:
        batches = distributed_batch_iterator(
            dataset, batch_size, mesh, shuffle=shuffle, seed=seed,
            skip_batches=skip_batches, accum_steps=accum_steps)
    else:
        batches = batch_iterator(dataset, batch_size, shuffle=shuffle,
                                 seed=seed, pad_last=True,
                                 skip_batches=skip_batches)
    return device_prefetch(batches, device=device)


class _NullLogger:
    """``RunLogger``'s surface for the ranks other than 0: no run I/O (JAX
    ``apps/train.py:453-476``). Every rank still computes all that rank 0
    logs, so that the collectives stay in step."""

    def __init__(self):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="ede-nonmain-")
        self.name = "nonmain"

    def set_summary(self, *args, **kwargs):
        pass

    def log(self, *args, **kwargs):
        pass

    def log_images(self, *args, **kwargs):
        pass

    def log_histograms(self, *args, **kwargs):
        pass

    def finish(self):
        pass


def _model(args, crop: tuple[int, int]) -> torch.nn.Module:
    """The model of the flags, its initial weights drawn from ``--seed``
    (PyTorch's initialisers, on a generator of their own)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        if args.decoder == "hu2018":
            return build_model(args.encoder, "hu2018")
        return build_model(args.encoder, "lasinger2019",
                           output_size=(crop[0] // 2, crop[1] // 2),
                           input_size=crop)


def train_policy(args, device) -> tuple[int, str | None, str]:
    """(accum_steps, remat, source) of the flags ``args``: the explicit
    flags, else the entry of ``--train-policy`` (``runs/train_policy.json``
    when that exists) for this device, family, per-device batch and dtype,
    else accum 1 and no remat (``apps.autotune.apply_train_policy``). A
    policy's source names its file."""
    path = args.train_policy or (
        TRAIN_POLICY_PATH if os.path.isfile(TRAIN_POLICY_PATH) else None)
    accum, remat, source = apply_train_policy(
        path, args.encoder, args.decoder, args.per_device_batch,
        torch.bfloat16 if args.bf16 else None, args.accum_steps, args.remat,
        device=device)
    return accum, remat, (f"policy {path}" if source == "policy" else source)


def main(args: Optional[List[str]] = None):
    args = parse_args(args)
    if args.init_from and args.resume:
        raise SystemExit("--init-from and --resume are mutually exclusive: "
                         "--resume restores the optimizer exactly, "
                         "--init-from starts a fresh fine-tune")
    training_start_time = datetime.datetime.now()
    # A launcher's environment joins the process group; a plain run is a
    # world of one (JAX apps/train.py:203-210).
    maybe_initialize_distributed(device=args.device)
    mesh = create_mesh(device=args.device)
    device = resolve_device(mesh.device)
    is_main = mesh.rank == 0
    batch_size = scale_batch_size(args.per_device_batch, mesh)
    crop = tuple(args.crop_hw)
    if is_main:
        print(f"mesh={dict(mesh.shape)} batch_size={batch_size} "
              f"processes={mesh.world_size} device={device}")

    model = _model(args, crop)
    if args.init_from:
        model = load_any_checkpoint(args.init_from, model=model,
                                    device=device)
        print(f"Initialized weights from {args.init_from} (fresh optimizer)")
    model = model.to(device)

    train_ds = DepthPairDataset(args.train_csv, is_test=False,
                                cache_in_ram=args.cache_ram)
    test_ds = DepthPairDataset(args.test_csv, is_test=True,
                               cache_in_ram=args.cache_ram)
    steps_per_epoch = max(1, len(train_ds) // batch_size)

    frozen = ("E", "encoder") if args.freeze_encoder else ()
    state = create_train_state(model, step_lr(args.lr, steps_per_epoch),
                               args.weight_decay, frozen_prefixes=frozen,
                               mesh=mesh, zero1=args.zero1)
    resume_epoch, resume_skip = -1, 0
    if args.resume:
        state, header = load_train_state(args.resume, state)
        resume_skip = int(header.get("step_in_epoch") or 0)
        if resume_skip:  # a mid-epoch save: replay the rest of that epoch
            resume_epoch = header["epoch"]
            args.start_epoch = max(args.start_epoch, resume_epoch)
            print(f"Resumed from {args.resume} at epoch {args.start_epoch} "
                  f"step {resume_skip} (mid-epoch)")
        else:
            args.start_epoch = max(args.start_epoch, header["epoch"] + 1)
            print(f"Resumed from {args.resume} at epoch {args.start_epoch}")
    if args.start_epoch and not args.resume:
        # As in the JAX package (apps/train.py:271-272): the step, which
        # seeds each step's generators, moves on; the optimizer's count,
        # and so the LR schedule, starts at 0.
        state.step = args.start_epoch * steps_per_epoch

    accum_steps, remat, policy_source = train_policy(args, device)
    if is_main:
        print(f"train policy from {policy_source}: accum_steps="
              f"{accum_steps} remat={remat}")
    train_step = make_train_step(mixed_precision=args.bf16, crop_hw=crop,
                                 split_preprocess=args.split_preprocess,
                                 remat=remat, accum_steps=accum_steps,
                                 device=device, mesh=mesh)
    eval_step = make_eval_step(device=device, mesh=mesh)
    # the examples and the gradient probe run on a whole batch on every
    # rank, without collectives: JAX's replicated batch
    # (``_replicate_global``, apps/train.py:478-484)
    example_step = make_eval_step(device=device)
    grad_snapshot = make_grad_snapshot(mixed_precision=args.bf16,
                                       crop_hw=crop, device=device)

    logger = RunLogger(
        project="deep-depth-estimation",
        config={"network": {"encoder": {"name": args.encoder},
                            "decoder_type": args.decoder}},
        name_prefix=f"{args.encoder}-{args.decoder}"
    ) if is_main else _NullLogger()
    logger.set_summary("num_parameters",
                       sum(p.numel() for p in model.parameters()))
    checkpoint_path = os.path.join(logger.dir, f"{logger.name}.ede")
    rolling_path = os.path.join(logger.dir, "train_state.ede")
    best_metrics = BestMetricsTracker()
    min_loss = float("inf")
    _install_preemption_handler()

    def save_rolling(state, epoch, step_in_epoch=None):
        """The whole train state, for an exact resume (--resume): every
        rank gathers (ZeRO-1), rank 0 writes."""
        save_train_state(rolling_path, state, encoder=args.encoder,
                         decoder=args.decoder, epoch=epoch,
                         step_in_epoch=step_in_epoch)
        return rolling_path

    training_timer, test_timer, inference_timer = Timer(), Timer(), Timer()
    static_vram = None  # measured once where no allocator keeps a peak

    for epoch in range(args.start_epoch, args.epochs):
        elapsed = datetime.datetime.now() - training_start_time
        print(f"Epoch {epoch + 1:02d}/{args.epochs:02d} - Total Elapsed "
              f"Time: {elapsed}")
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

        with training_timer:
            state, train_metrics, preempted = run_train_epoch(
                state, train_step, train_ds, batch_size, args.seed, epoch,
                skip_batches=resume_skip if epoch == resume_epoch else 0,
                save_every=args.save_every, checkpoint_cb=save_rolling,
                stop_after_steps=args.stop_after_steps, device=device,
                mesh=mesh, accum_steps=accum_steps)
        if preempted:
            print(f"Preempted at epoch {epoch}: exact train state saved to "
                  f"{rolling_path}; continue with --resume")
            logger.finish()
            return rolling_path

        with test_timer:
            metrics = run_eval_epoch(state, eval_step, test_ds, batch_size,
                                     crop_hw=crop, device=device, mesh=mesh)

        if metrics.abs_rel.value < min_loss and is_main:
            min_loss = metrics.abs_rel.value
            if args.decoder == "lasinger2019":
                save_midas(checkpoint_path, model)
            else:
                save_checkpoint(checkpoint_path, model, encoder=args.encoder,
                                decoder=args.decoder)

        save_rolling(state, epoch)

        # example depth images from the first test batch (train.py:163-177)
        example = next(batch_iterator(test_ds, min(batch_size, 8),
                                      pad_last=True))
        images, depths = eval_preprocess(
            torch.from_numpy(example["image"]).to(device),
            torch.from_numpy(example["depth"]).to(device), crop_hw=crop)
        with inference_timer:
            _, examples = example_step(state, images, depths,
                                       images.shape[0])
            examples = examples.cpu().numpy()
        logger.log_images("examples", examples / 10.0, step=epoch)

        # parameter and gradient histograms (wandb.watch, train.py:134), the
        # gradient of a small train batch (8-bit training depths)
        if args.watch_every and epoch % args.watch_every == 0:
            watch_batch = next(batch_iterator(train_ds, min(batch_size, 8),
                                              pad_last=True))
            logger.log_histograms(
                to_jax_variables(dict(model.named_parameters()))["params"],
                step=epoch, prefix="parameters")
            grads = grad_snapshot(state, watch_batch,
                                  epoch_seed(args.seed, epoch))
            logger.log_histograms(to_jax_variables(grads)["params"],
                                  step=epoch, prefix="gradients")

        best_metrics.update(metrics)
        for name, value in best_metrics.to_dict().items():
            logger.set_summary(name, value)

        # the allocator's peak of the epoch on the card; on the CPU, once,
        # the bytes a gradient probe on one training batch creates
        vram, vram_source = peak_memory(device=device)
        if vram_source == "unavailable":
            if static_vram is None:
                ex = next(batch_iterator(train_ds, batch_size, pad_last=True))
                static_vram = peak_memory(grad_snapshot, (state, ex, 0),
                                          device=device)
            vram, vram_source = static_vram
        logger.log({
            **metrics.to_dict(),
            "loss": train_metrics.get("loss", float("nan")),
            "vram_usage": vram,
            "vram_source": vram_source,
            "training_frame_time":
                training_timer.elapsed.total_seconds() / max(1, len(train_ds)),
            "test_frame_time":
                test_timer.elapsed.total_seconds() / max(1, len(test_ds)),
            "inference_time":
                inference_timer.elapsed.total_seconds() / max(1, len(examples)),
        }, step=epoch)

    if is_main:
        print(f"Total Training Time: "
              f"{datetime.datetime.now() - training_start_time}.")
    logger.finish()
    return checkpoint_path


def run_train_epoch(state, train_step, dataset, batch_size: int, seed: int,
                    epoch: int, *, skip_batches: int = 0, save_every: int = 0,
                    checkpoint_cb=None, stop_after_steps=None, device=None,
                    mesh=None, accum_steps: int = 1):
    """One training epoch with metrics read back one step behind.

    The host reads step k's metrics only after step k+1 is queued, so
    reporting never stalls the card between steps; the progress line shows
    the previous step's numbers. Batches are shuffled by ``epoch``, the last
    one padded (``pad_last``) and its duplicates masked in the step through
    ``num_valid``, and copied to ``device`` (the CUDA card unless
    ``device="cpu"``) ahead of use. ``checkpoint_cb(state, epoch,
    step_in_epoch)`` runs every ``save_every`` steps, and at the next step
    boundary after a SIGTERM (``_PREEMPTED``) or when ``stop_after_steps``
    global steps are reached, either of which ends the epoch early. A
    mid-epoch stop is exact to resume with ``skip_batches``: the shuffle is
    seeded by ``epoch`` and each step's generators by
    (``epoch_seed(seed, epoch)``, ``state.step``). Returns ``(state,
    {"loss": mean loss}, stopped)``.

    Under a ``mesh`` of more than one rank (a ``train_step`` made for it)
    ``batch_size`` is the global batch, each rank takes its rows
    (``accum_steps`` as the step's), and the stop flag is reduced across
    the ranks at every step boundary (on the host, ``parallel.any_rank``:
    the check waits for no device work), so that a SIGTERM that reaches
    one rank stops all of them after the same step.
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
    for batch in _epoch_batches(dataset, batch_size, device, shuffle=True,
                                seed=epoch, skip_batches=skip_batches,
                                mesh=mesh, accum_steps=accum_steps):
        state, metrics = train_step(state, batch, step_seed)
        seen += int(batch["num_valid"])
        steps_done += 1
        if pending is not None:
            drain(pending)
        pending = metrics

        stop = any_rank(_PREEMPTED.is_set() or (
            stop_after_steps is not None
            and start_step + (steps_done - skip_batches) >= stop_after_steps),
            mesh)
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
                   crop_hw: tuple[int, int] = (228, 304), *, device=None,
                   mesh=None) -> MetricsTracker:
    """One pass of ``eval_step`` (``make_eval_step``) over a test split of
    uint8 frames and 16-bit mm depths: ``eval_preprocess`` on ``device``
    (the CUDA card unless ``device="cpu"``), the step, and the tracker fed
    with each batch's sums. The last batch is padded (``pad_last``) and its
    duplicates masked through ``num_valid``. Returns the tracker.

    Under a ``mesh`` of more than one rank (an ``eval_step`` made for it)
    each rank evaluates its rows of each global batch of ``batch_size``,
    and the step sums the metric parts over the ranks, so that every
    rank's tracker is the one-process one."""
    device = resolve_device(device)
    tracker = MetricsTracker()
    seen = 0
    epoch_start = datetime.datetime.now()
    for batch in _epoch_batches(dataset, batch_size, device, mesh=mesh):
        images, depths = eval_preprocess(
            torch.as_tensor(batch["image"]).to(device),
            torch.as_tensor(batch["depth"]).to(device), crop_hw=crop_hw)
        sums, _ = eval_step(state, images, depths, int(batch["num_valid"]))
        tracker.update_from_sums(sums)
        seen += int(batch["num_valid"])
        dt = (datetime.datetime.now() - epoch_start).total_seconds()
        print(f"\rVal [{seen:05d}/{len(dataset):05d}] - "
              f"({dt / max(seen, 1):.4f}s/image) - {tracker}", end="",
              flush=True)
    print()
    return tracker


if __name__ == "__main__":
    main()
