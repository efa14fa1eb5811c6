"""Multi-process runtime: process-group init and per-rank data feeding.

Counterpart of ``efficientdepthestimation_tpu/parallel/multihost.py``. Every
rank runs the same program on its own device; the environment of a
launcher initializes the process group, and each rank decodes only the
rows of the global batch it holds. JAX assembles those rows into global
arrays; here they stay the rank's local tensors, and the training step,
the BatchNorm statistics and the metrics reduce across ranks themselves.

With one process the local rows are the whole batch, so
``distributed_batch_iterator`` yields what ``batch_iterator`` yields.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Iterator

import numpy as np
import torch.distributed as dist

from efficientdepthestimation_tpu_torch.parallel.mesh import (
    Mesh,
    _local_device,
    collective_timeout,
)

__all__ = ["maybe_initialize_distributed", "process_local_rows",
           "make_global_batch", "distributed_batch_iterator"]

def _launch_env() -> tuple[str, int, int] | None:
    """(init method, world size, rank) of a multi-process launch: the JAX
    package's ``EDE_COORDINATOR_ADDRESS``/``EDE_NUM_PROCESSES``/
    ``EDE_PROCESS_ID`` (a ``host:port``, or any ``torch.distributed`` init
    URL such as ``file:///path``), else torchrun's ``RANK``/
    ``WORLD_SIZE``/``MASTER_ADDR``; None when neither is set."""
    env = os.environ
    if "EDE_COORDINATOR_ADDRESS" in env:
        addr = env["EDE_COORDINATOR_ADDRESS"]
        return (addr if "://" in addr else f"tcp://{addr}",
                int(env["EDE_NUM_PROCESSES"]), int(env["EDE_PROCESS_ID"]))
    if all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    return None


def maybe_initialize_distributed(*, device=None,
                                 backend: str | None = None) -> bool:
    """Initialize the default process group when the environment says this
    is a multi-process launch (``_launch_env``); returns whether more than
    one process takes part.

    ``backend`` defaults to NCCL when ``device`` (default
    ``cuda:LOCAL_RANK``) is a CUDA device, else gloo. Every collective
    waits at most ``EDE_DIST_TIMEOUT`` seconds (default 1800), so that a
    rank that has gone away fails the others instead of hanging them. A
    launch that cannot join raises."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    launch = _launch_env()
    if launch is None:
        return False
    init_method, world, rank = launch
    if backend is None:
        backend = "nccl" if _local_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=collective_timeout())
    return world > 1


def process_local_rows(mesh: Mesh, global_batch_size: int,
                       accum_steps: int = 1) -> np.ndarray:
    """Global-batch row indices this rank holds, ascending.

    Without accumulation an equal contiguous block a data index, in rank
    order. With ``accum_steps`` > 1 microbatch i is global rows
    ``[i·micro, (i+1)·micro)`` (JAX ``train_step.py:239-247``), and each
    rank holds its block of every microbatch, so that the rank's microbatch
    i is its local rows ``[i·micro/n, (i+1)·micro/n)``. A batch the data
    axis (× ``accum_steps``) does not divide raises."""
    n = mesh.shape["data"]
    if global_batch_size % (n * accum_steps):
        raise ValueError(f"batch {global_batch_size} not divisible by the "
                         f"data axis ({n}) × accum_steps ({accum_steps})")
    micro = global_batch_size // accum_steps
    local = micro // n
    start = mesh.data_index * local
    return np.concatenate([np.arange(i * micro + start,
                                     i * micro + start + local)
                           for i in range(accum_steps)]).astype(np.int64)


def make_global_batch(local_batch: dict, mesh: Mesh, num_valid: int
                      ) -> dict:
    """A rank's share of a global batch of ``mesh``: its local arrays as
    they are, and ``num_valid``, the valid rows of the whole global batch
    (JAX assembles global arrays here; the port's step, BN statistics and
    metrics reduce across the ranks themselves)."""
    return {**local_batch, "num_valid": int(num_valid)}


def distributed_batch_iterator(
    dataset,
    global_batch_size: int,
    mesh: Mesh,
    *,
    shuffle: bool = False,
    seed: int = 0,
    num_workers: int = 4,
    pad_last: bool = True,
    skip_batches: int = 0,
    accum_steps: int = 1,
) -> Iterator[dict]:
    """Yield this rank's share of each global batch, decoding only its rows.

    Every rank derives the same seeded shuffle, so row ownership needs no
    communication (``batch_iterator``'s contract, spread over ranks).
    ``num_valid`` is the true global count; the ``pad_last`` duplicates are
    masked downstream. ``skip_batches`` fast-forwards past the first N
    global batches without decoding them (an exact mid-epoch resume).
    ``accum_steps`` gives the rows of ``process_local_rows`` under
    microbatch accumulation. Rows decode through the dataset's
    ``load_batch`` (the native decoder) where it returns a batch, else on
    a thread pool; a dataset of images alone (``VideoFrameDataset``) yields
    batches without ``depth``."""
    indices = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(indices)
    indices = indices[skip_batches * global_batch_size:]
    local_rows = process_local_rows(mesh, global_batch_size, accum_steps)
    native_loader = getattr(dataset, "load_batch", None)

    with cf.ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        for start in range(0, len(indices), global_batch_size):
            chunk = indices[start:start + global_batch_size]
            num_valid = len(chunk)
            if len(chunk) < global_batch_size:
                if not pad_last:
                    return
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:],
                                      global_batch_size - len(chunk))])
            local_chunk = chunk[local_rows]
            batch = native_loader(local_chunk) if native_loader else None
            if batch is None:
                samples = list(pool.map(lambda i: dataset[int(i)],
                                        local_chunk))
                batch = (tuple(np.stack(s) for s in zip(*samples))
                         if isinstance(samples[0], tuple)
                         else (np.stack(samples),))
            yield make_global_batch(dict(zip(("image", "depth"), batch)),
                                    mesh, num_valid)
