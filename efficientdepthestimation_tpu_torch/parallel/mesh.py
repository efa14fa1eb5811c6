"""The data-parallel mesh: one process a device, its rows and its collectives.

Counterpart of ``efficientdepthestimation_tpu/parallel/mesh.py``. JAX spans
every local device from one process and lets GSPMD insert the collectives;
PyTorch's idiom is one process a device, joined by a
``torch.distributed`` process group, with the collectives written out.
``Mesh`` is that group seen as JAX's ``("data", "model")`` mesh: the model
axis is present and of size 1 by default, as in JAX, where no
configuration here pays for tensor parallelism.

Without an initialized process group ``create_mesh()`` is a world of one:
it holds no group, and every helper here issues no collective, so the
single-card path stays exactly what it is without a mesh. The port issues
only ``all_reduce`` and ``broadcast``, which the gloo backend also takes on
CUDA tensors (two ranks sharing one card, where NCCL refuses).

The shardings are row-ownership descriptors rather than device layouts:
``data_sharding`` says which rows of a batch a rank holds,
``replicated_sharding`` that every rank holds all of them, and
``spatial_sharding`` which *image* rows a rank holds in spatial serving
(``parallel.spatial``, where the port writes out the halo exchanges that
GSPMD compiles in JAX); ``gather_rows`` puts a row-sharded output back
together.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from efficientdepthestimation_tpu_torch.parallel.spatial import owned_rows

__all__ = ["Mesh", "RowSharding", "create_mesh", "data_sharding",
           "replicated_sharding", "spatial_sharding", "gather_rows",
           "shard_batch", "scale_batch_size", "zero1_shardings",
           "zero1_state_shardings", "all_reduce_", "all_reduce_flat",
           "differentiable_all_reduce",
           "broadcast_flat", "any_rank", "collective_timeout"]

#: Seconds a collective may wait before it raises, unless the environment
#: sets ``EDE_DIST_TIMEOUT``.
DEFAULT_TIMEOUT_S = 1800.0

#: Elements of one flat bucket of ``all_reduce_flat``/``broadcast_flat``
#: (64 MiB of f32): few collectives a step, and a bounded staging copy.
BUCKET_ELEMENTS = 1 << 24


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A data × model mesh of ``world_size`` processes, one device each.

    ``group`` is the process group of the collectives, None in a world of
    one; ``host_group`` a gloo group of the same ranks for flags held on
    the host (``group`` itself when that is gloo), whose collectives never
    wait for a device stream; ``shape`` is ``{"data": world_size //
    model_parallel, "model": model_parallel}``; ``data_index`` is this
    rank's place on the data axis (ranks of one data index hold the same
    rows); ``device`` is its ``torch.device``."""

    group: object
    world_size: int
    rank: int
    shape: dict
    data_index: int
    device: torch.device
    host_group: object = None

    @property
    def distributed(self) -> bool:
        """Whether collectives run: more than one rank."""
        return self.group is not None


def collective_timeout() -> datetime.timedelta:
    """How long a collective may wait: ``EDE_DIST_TIMEOUT`` seconds, else
    ``DEFAULT_TIMEOUT_S``, so that a rank that has gone away fails the
    others instead of hanging them."""
    return datetime.timedelta(seconds=float(os.environ.get(
        "EDE_DIST_TIMEOUT", DEFAULT_TIMEOUT_S)))


def _local_device(device) -> torch.device:
    if device is not None:
        device = torch.device(device)
    else:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_mesh: no CUDA device is available; pass "
                           "device='cpu' for a mesh of CPU processes (gloo)")
    return device


def create_mesh(n_devices: int | None = None, model_parallel: int = 1, *,
                device=None, backend: str | None = None) -> Mesh:
    """The mesh of the initialized process group (one process a device,
    ``parallel.maybe_initialize_distributed``), else a world of one.

    ``device`` is ``cuda:LOCAL_RANK`` unless given (``"cpu"``, or
    ``"cuda:0"`` for ranks that share one card). ``backend``, when given,
    must be the group's: NCCL on CUDA, gloo on the CPU or for ranks sharing
    a card. ``n_devices``, when given, must be the world size: a mesh that
    was asked for and cannot be built raises, and nothing falls back to a
    world of one."""
    device = _local_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)  # the device NCCL's communicator uses
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        actual = dist.get_backend()
        if backend is not None and actual != backend:
            raise RuntimeError(f"create_mesh: the process group's backend is "
                               f"{actual}, not {backend}")
        if actual == "nccl" and device.type != "cuda":
            raise RuntimeError("create_mesh: NCCL needs a CUDA device")
        group = dist.group.WORLD if world > 1 else None
        host_group = group
        if group is not None and actual != "gloo":
            # every rank calls create_mesh, so every rank joins
            host_group = dist.new_group(backend="gloo",
                                        timeout=collective_timeout())
    else:
        if backend is not None:
            raise RuntimeError(f"create_mesh: backend {backend!r} asked for, "
                               "but no process group is initialized "
                               "(maybe_initialize_distributed)")
        world, rank, group, host_group = 1, 0, None, None
    if n_devices is not None and n_devices != world:
        raise ValueError(f"create_mesh: {n_devices} devices asked for, the "
                         f"process group has {world} (one process a device)")
    if world % model_parallel:
        raise ValueError(f"{world} devices not divisible by "
                         f"model_parallel={model_parallel}")
    return Mesh(group=group, world_size=world, rank=rank,
                shape={"data": world // model_parallel,
                       "model": model_parallel},
                data_index=rank // model_parallel, device=device,
                host_group=host_group)


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """Which rows this rank holds: ``kind`` is "data" (an equal contiguous
    block of a batch a data index, in rank order), "replicated" (all) or
    "spatial" (a block of an image's rows over every rank, GSPMD's ragged
    split: ``ceil(h / world)`` a rank, the last ranks fewer or none)."""

    mesh: Mesh
    kind: str

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a batch of ``batch_size`` (under "spatial",
        of an image of ``batch_size`` rows); a batch that the data axis
        does not divide raises, as JAX's sharding does."""
        if self.kind == "spatial":
            return slice(*owned_rows(batch_size, self.mesh.world_size,
                                     self.mesh.rank))
        if self.kind == "replicated":
            return slice(0, batch_size)
        n = self.mesh.shape["data"]
        if batch_size % n:
            raise ValueError(f"batch {batch_size} not divisible by the data "
                             f"axis ({n})")
        local = batch_size // n
        start = self.mesh.data_index * local
        return slice(start, start + local)


def data_sharding(mesh: Mesh) -> RowSharding:
    """Batch rows split along the data axis."""
    return RowSharding(mesh, "data")


def replicated_sharding(mesh: Mesh) -> RowSharding:
    return RowSharding(mesh, "replicated")


def spatial_sharding(mesh: Mesh) -> RowSharding:
    """Image *rows* across every rank, batch and width whole: JAX's latency
    mode for batches too small to data-shard, where GSPMD compiles the
    conv halo exchanges and here ``parallel.spatial`` writes them out."""
    return RowSharding(mesh, "spatial")


def gather_rows(band: torch.Tensor, height: int,
                mesh: Mesh | None) -> torch.Tensor:
    """The whole (N, height, W, C) tensor on every rank from each rank's
    ``spatial_sharding`` rows of it (``band``, as a spatial serving fn
    returns them): one ``all_reduce`` of the rows each rank places, zero
    elsewhere, which gloo also takes on CUDA tensors. A world of one
    returns ``band``."""
    if mesh is None or not mesh.distributed:
        return band
    rows = spatial_sharding(mesh).rows(height)
    if band.shape[1] != rows.stop - rows.start:
        raise ValueError(f"gather_rows: a band of {band.shape[1]} rows, "
                         f"where rank {mesh.rank} owns "
                         f"{rows.stop - rows.start} of {height}")
    whole = band.new_zeros((band.shape[0], height) + tuple(band.shape[2:]))
    whole[:, rows] = band
    dist.all_reduce(whole, group=mesh.group)
    return whole


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a whole batch (a dict of arrays, or one array),
    as tensors on the rank's device; scalars (``num_valid``) pass as they
    are."""
    sharding = data_sharding(mesh)

    def put(x):
        if not hasattr(x, "shape") or len(x.shape) == 0:
            return x
        return torch.as_tensor(x[sharding.rows(x.shape[0])]).to(mesh.device)

    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    return put(batch)


def scale_batch_size(per_device: int = 8, mesh: Mesh | None = None) -> int:
    """The reference scales batch 8→32→64 for 1→4→8 GPUs (train.py:93-101);
    the mesh generalization is per-device × data-axis size."""
    n = mesh.shape["data"] if mesh is not None else 1
    return per_device * n


def zero1_shardings(named_tensors, mesh: Mesh, axis: str = "data"
                    ) -> dict[str, int]:
    """The data rank that owns each tensor's optimizer state (ZeRO-1):
    ``{name: owner}`` for ``named_tensors`` (a dict or ``named_parameters``
    pairs), every name owned by exactly one rank.

    Ownership is by whole tensors, as ``ZeroRedundancyOptimizer``
    partitions them: largest first, each to the rank that owns the fewest
    elements so far (ties to the lower rank). JAX splits each leaf along its
    largest divisible dimension instead; the numerics are the same either
    way, since Adam's update is element-wise. Every rank computes the same
    map from the same shapes, without communication."""
    n = mesh.shape[axis]
    items = list(named_tensors.items() if isinstance(named_tensors, dict)
                 else named_tensors)
    order = sorted(range(len(items)), key=lambda i: -items[i][1].numel())
    load = [0] * n
    owners = {}
    for i in order:
        name, t = items[i]
        owner = min(range(n), key=lambda r: (load[r], r))
        owners[name] = owner
        load[owner] += t.numel()
    return {name: owners[name] for name, _ in items}


def zero1_state_shardings(state, mesh: Mesh, axis: str = "data") -> dict:
    """A ``TrainState``'s layout under ZeRO-1: the parameters, BN
    statistics and step replicated (every rank's forward needs whole
    weights), Adam's moments owned as ``zero1_shardings`` assigns them."""
    model = state.model
    rep = replicated_sharding(mesh)
    trained = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
    return {"step": rep,
            "params": {k: rep for k, _ in model.named_parameters()},
            "batch_stats": {k: rep for k, _ in model.named_buffers()},
            "opt_state": zero1_shardings(trained, mesh, axis)}


def all_reduce_(tensor: torch.Tensor, mesh: Mesh | None,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``tensor`` reduced over the mesh in place (no collective in a world
    of one); returns it."""
    if mesh is not None and mesh.distributed:
        dist.all_reduce(tensor, op=op, group=mesh.group)
    return tensor


def any_rank(flag: bool, mesh: Mesh | None) -> bool:
    """Whether ``flag`` is set on any rank of the mesh (the flag itself in a
    world of one): a MAX all-reduce of a host tensor over
    ``mesh.host_group``, so that the host never waits for the work it has
    queued on the device."""
    if mesh is None or not mesh.distributed:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())


class _AllReduceSum(torch.autograd.Function):
    """Σ over the group's ranks; the gradient of each rank's input is the
    Σ of every rank's output gradient (each rank's loss depends on the sum
    through its own rows)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def differentiable_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (a process group), out of place and
    differentiable: one ``all_reduce`` forward and one backward."""
    return _AllReduceSum.apply(x, group)


def _buckets(tensors: list[torch.Tensor]) -> list[list[torch.Tensor]]:
    """Consecutive runs of one dtype of at most ``BUCKET_ELEMENTS`` (a
    larger tensor is a bucket of its own)."""
    buckets, size = [], 0
    for t in tensors:
        if (not buckets or buckets[-1][0].dtype != t.dtype
                or size + t.numel() > BUCKET_ELEMENTS):
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += t.numel()
    return buckets


def _flat_collective(tensors, mesh: Mesh, collective) -> None:
    if mesh is None or not mesh.distributed:
        return
    for bucket in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective(flat)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


def all_reduce_flat(tensors, mesh: Mesh | None,
                    op=dist.ReduceOp.SUM) -> None:
    """Reduce each of ``tensors`` over the mesh in place, in a few flat
    buckets (one collective a bucket, not one a tensor). Every rank passes
    tensors of the same shapes in the same order."""
    _flat_collective(tensors, mesh, lambda flat: dist.all_reduce(
        flat, op=op, group=mesh.group))


def broadcast_flat(tensors, src: int, mesh: Mesh | None) -> None:
    """Overwrite each of ``tensors`` in place with rank ``src``'s, in a few
    flat buckets."""
    _flat_collective(tensors, mesh, lambda flat: dist.broadcast(
        flat, src=src, group=mesh.group))
