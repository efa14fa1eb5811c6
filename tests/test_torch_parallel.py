"""The port's ``parallel`` package in one process: row ownership against
the JAX package's shardings on its 8-device CPU mesh, the sharded loader
against ``batch_iterator``, ZeRO-1's ownership, the fused loss's global
denominator, the drop-connect draws of a batch share, the metric parts that
add across ranks, and a mesh of one process, which must change nothing.
Ranks of a mesh that needs no collective (row ownership, loading, serving)
are described by ``Mesh`` values without a process group; the collectives
themselves run across processes in ``test_torch_multiprocess.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from efficientdepthestimation_tpu.parallel import (
    create_mesh as jax_create_mesh,
    data_sharding as jax_data_sharding,
    process_local_rows as jax_process_local_rows,
    scale_batch_size as jax_scale_batch_size,
)

from efficientdepthestimation_tpu_torch.apps.common import (
    make_infer_fn,
    make_serving_fn,
)
from efficientdepthestimation_tpu_torch.checkpoints import serialization
from efficientdepthestimation_tpu_torch.data.datasets import batch_iterator
from efficientdepthestimation_tpu_torch.models.common import (
    BatchShare,
    batch_share,
    per_sample_uniform,
    randomize_,
)
from efficientdepthestimation_tpu_torch.models.registry import build_model
from efficientdepthestimation_tpu_torch.ops.kernels.fused_loss import (
    fused_depth_loss,
    fused_depth_loss_fwd,
    masked_total,
)
from efficientdepthestimation_tpu_torch.parallel import (
    create_mesh,
    data_sharding,
    distributed_batch_iterator,
    make_global_batch,
    maybe_initialize_distributed,
    process_local_rows,
    replicated_sharding,
    scale_batch_size,
    shard_batch,
    spatial_sharding,
    zero1_shardings,
    zero1_state_shardings,
)
from efficientdepthestimation_tpu_torch.parallel.mesh import Mesh
from efficientdepthestimation_tpu_torch.training.metrics import (
    depth_metric_parts,
    depth_metrics_batch,
    finish_depth_metrics,
)
from efficientdepthestimation_tpu_torch.training.train_step import (
    create_train_state,
    make_train_step,
)

from torch_parallel_cases import SynthDataset


def rank_of(world: int, rank: int) -> Mesh:
    """Rank ``rank`` of a ``world``-rank CPU mesh, as ``create_mesh`` sees
    it there, without a process group (nothing here runs a collective)."""
    return Mesh(group=None, world_size=world, rank=rank,
                shape={"data": world, "model": 1}, data_index=rank,
                device=torch.device("cpu"))


@pytest.mark.parametrize("world,batch", [(2, 4), (4, 16), (8, 8)])
def test_rows_match_jax_device_slices(world, batch):
    """Rank r decodes the rows JAX's data sharding gives device r, and the
    ranks together the rows JAX's one process decodes."""
    jmesh = jax_create_mesh(world)
    slices = jax_data_sharding(jmesh).devices_indices_map((batch,))
    for r, device in enumerate(jmesh.devices.reshape(-1)):
        sl = slices[device][0]
        ours = process_local_rows(rank_of(world, r), batch)
        np.testing.assert_array_equal(ours, np.arange(sl.start, sl.stop))
        assert data_sharding(rank_of(world, r)).rows(batch) == slice(
            sl.start, sl.stop)
    together = np.concatenate([process_local_rows(rank_of(world, r), batch)
                               for r in range(world)])
    np.testing.assert_array_equal(together,
                                  jax_process_local_rows(jmesh, batch))


@pytest.mark.parametrize("world,accum", [(2, 2), (4, 2), (2, 4)])
def test_rows_under_accumulation(world, accum):
    """Microbatch i is global rows [i·micro, (i+1)·micro); each rank's
    microbatch i is its local block i, and the blocks partition it."""
    batch = 16
    micro = batch // accum
    local = [process_local_rows(rank_of(world, r), batch, accum)
             for r in range(world)]
    for i in range(accum):
        block = np.concatenate([rows[i * micro // world:
                                     (i + 1) * micro // world]
                                for rows in local])
        np.testing.assert_array_equal(block,
                                      np.arange(i * micro, (i + 1) * micro))


def test_a_batch_the_ranks_do_not_divide_raises():
    with pytest.raises(ValueError, match="not divisible"):
        process_local_rows(rank_of(4, 0), 6)
    with pytest.raises(ValueError, match="not divisible"):
        process_local_rows(rank_of(2, 0), 4, accum_steps=4)
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch({"image": np.zeros((3, 2))}, rank_of(2, 1))
    infer = make_serving_fn(_tiny_model(), device="cpu", mesh=rank_of(2, 0))
    with pytest.raises(ValueError, match="not divisible"):
        infer(torch.zeros(3, 32, 48, 3))


@pytest.mark.parametrize("per_device,world", [(8, 1), (8, 4), (2, 8)])
def test_scale_batch_size_matches_jax(per_device, world):
    assert scale_batch_size(per_device, rank_of(world, 0)) == \
        jax_scale_batch_size(per_device, jax_create_mesh(world)) == \
        per_device * world


def test_shardings_describe_rows():
    mesh = rank_of(4, 3)
    assert data_sharding(mesh).rows(8) == slice(6, 8)
    assert replicated_sharding(mesh).rows(8) == slice(0, 8)
    batch = shard_batch({"image": np.arange(8)[:, None], "num_valid": 5},
                        mesh)
    assert batch["num_valid"] == 5
    assert torch.equal(batch["image"], torch.tensor([[6], [7]]))


def test_spatial_serving_raises_naming_a11b():
    with pytest.raises(NotImplementedError, match="A11b"):
        spatial_sharding(rank_of(2, 0)).rows(4)
    for make in (make_infer_fn, make_serving_fn):
        with pytest.raises(NotImplementedError, match="A11b"):
            make(_tiny_model(), device="cpu", mesh=rank_of(2, 0),
                 spatial=True)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_zero1_owns_every_parameter_once(world):
    """Every trained parameter's moments have exactly one owner, every rank
    owns some, and the largest share is within one tensor of the even
    split (as ``ZeroRedundancyOptimizer`` balances them)."""
    model = build_model("efficientnet-b0", "hu2018")
    named = dict(model.named_parameters())
    owners = zero1_shardings(named, rank_of(world, 0))
    assert list(owners) == list(named)
    assert set(owners.values()) == set(range(world))
    load = [sum(named[k].numel() for k, o in owners.items() if o == r)
            for r in range(world)]
    assert sum(load) == sum(p.numel() for p in named.values())
    largest = max(p.numel() for p in named.values())
    assert max(load) - min(load) <= largest
    # every rank derives the same map
    assert owners == zero1_shardings(list(named.items()), rank_of(world, 1))


def test_zero1_state_shardings_replicate_all_but_the_moments():
    model = _tiny_model()
    state = create_train_state(model, 1e-3, frozen_prefixes=("E",))
    layout = zero1_state_shardings(state, rank_of(2, 0))
    assert layout["step"].kind == "replicated"
    assert {s.kind for s in layout["params"].values()} == {"replicated"}
    assert set(layout["params"]) == set(dict(model.named_parameters()))
    assert set(layout["batch_stats"]) == set(dict(model.named_buffers()))
    assert set(layout["opt_state"]) == {
        k for k, p in model.named_parameters() if p.requires_grad}


@pytest.mark.parametrize("shuffle,skip", [(False, 0), (True, 0), (True, 1)])
def test_world_of_one_iterator_is_batch_iterator(shuffle, skip):
    dataset = SynthDataset(n=10)
    kw = dict(shuffle=shuffle, seed=3, skip_batches=skip)
    ref = list(batch_iterator(dataset, 4, pad_last=True, **kw))
    got = list(distributed_batch_iterator(dataset, 4,
                                          create_mesh(device="cpu"), **kw))
    assert len(got) == len(ref) == 3 - skip
    for a, b in zip(got, ref):
        assert a["num_valid"] == b["num_valid"]
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["depth"], b["depth"])


@pytest.mark.parametrize("accum", [1, 2])
def test_ranks_partition_each_global_batch(accum):
    """Four ranks' batches are the rows of ``batch_iterator``'s at
    ``process_local_rows``, with its global ``num_valid``, also after a
    skip (a mid-epoch resume)."""
    dataset = SynthDataset(n=13)
    ref = list(batch_iterator(dataset, 8, shuffle=True, seed=5,
                              pad_last=True, skip_batches=1))
    per_rank = [list(distributed_batch_iterator(
        dataset, 8, rank_of(4, r), shuffle=True, seed=5, skip_batches=1,
        accum_steps=accum)) for r in range(4)]
    for r, batches in enumerate(per_rank):
        rows = process_local_rows(rank_of(4, r), 8, accum)
        assert len(batches) == len(ref) == 1
        for got, want in zip(batches, ref):
            assert got["num_valid"] == want["num_valid"] == 5
            np.testing.assert_array_equal(got["image"], want["image"][rows])


def test_iterator_decodes_only_the_ranks_rows_natively():
    class Native(SynthDataset):
        calls = []

        def load_batch(self, indices):
            self.calls.append(list(indices))
            return (np.stack([self[int(i)][0] for i in indices]),
                    np.stack([self[int(i)][1] for i in indices]))

    dataset = Native(n=8)
    list(distributed_batch_iterator(dataset, 4, rank_of(2, 1)))
    assert dataset.calls == [[2, 3], [6, 7]]


def test_make_global_batch_carries_the_global_count():
    local = {"image": np.zeros((2, 3)), "depth": np.zeros((2, 1))}
    batch = make_global_batch(local, rank_of(4, 0), 5)
    assert batch["num_valid"] == 5 and batch["image"] is local["image"]


def test_create_mesh_world_of_one_and_what_raises(monkeypatch):
    for var in ("EDE_COORDINATOR_ADDRESS", "RANK", "WORLD_SIZE",
                "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize_distributed(device="cpu") is False
    mesh = create_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.shape, mesh.distributed) == (
        1, 0, {"data": 1, "model": 1}, False)
    # a mesh that was asked for and cannot be built raises
    with pytest.raises(ValueError, match="2 devices"):
        create_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        create_mesh(device="cpu", backend="gloo")
    with pytest.raises(ValueError, match="model_parallel"):
        create_mesh(device="cpu", model_parallel=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_mesh()


def test_create_mesh_picks_the_card(monkeypatch):
    """``cuda:LOCAL_RANK`` by default, made the current device (NCCL's);
    a device without an index (``"cuda"``, the CLI's ``--device cuda``)
    is kept as it is."""
    chosen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert create_mesh().device == torch.device("cuda", 3)
    assert create_mesh(device="cuda").device == torch.device("cuda")
    assert create_mesh(device="cuda:1").device == torch.device("cuda", 1)
    assert chosen == [torch.device("cuda", 3), torch.device("cuda", 1)]


def test_loss_denominator_none_changes_nothing():
    pred, target = _loss_inputs(4)
    for num_valid in (None, 3):
        a = fused_depth_loss(pred, target, num_valid)
        b = fused_depth_loss(pred, target, num_valid, denominator=None)
        mask = (torch.arange(4) < (4 if num_valid is None else num_valid))
        ref = masked_total(fused_depth_loss_fwd(pred, target), mask.float(),
                           pred.shape[1] * pred.shape[2])
        assert torch.equal(a, b) and torch.equal(a, ref)


@pytest.mark.parametrize("num_valid", [4, 3, 2])
def test_rank_losses_with_the_global_denominator_sum_to_the_global_one(
        num_valid):
    """Two ranks' losses, each over its rows' valid share with the global
    valid count as denominator, sum to the whole batch's loss, and so do
    their gradients; a rank of padding alone gives 0, not 0/0."""
    pred, target = _loss_inputs(4)
    whole = pred.clone().requires_grad_()
    loss = fused_depth_loss(whole, target, num_valid)
    loss.backward()
    parts = [pred[:2].clone().requires_grad_(),
             pred[2:].clone().requires_grad_()]
    shares = [fused_depth_loss(p, target[2 * r:2 * r + 2],
                               min(max(num_valid - 2 * r, 0), 2),
                               denominator=num_valid)
              for r, p in enumerate(parts)]
    for s in shares:
        s.backward()
    torch.testing.assert_close(shares[0] + shares[1], loss, rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(torch.cat([p.grad for p in parts]),
                               whole.grad, rtol=1e-6, atol=1e-9)
    if num_valid == 2:
        assert float(shares[1]) == 0.0
        assert not parts[1].grad.any()


def test_share_draws_are_the_global_draws_at_the_ranks_rows():
    def draw(share, n):
        gen = torch.Generator().manual_seed(9)
        with batch_share(share):
            return per_sample_uniform(n, gen, "cpu")

    whole = draw(None, 6)
    assert whole.shape == (6, 1, 1, 1)
    for r in range(3):
        assert torch.equal(draw(BatchShare(None, 2 * r, 6), 2),
                           whole[2 * r:2 * r + 2])


@pytest.mark.parametrize("num_valid", [None, 5, 3])
def test_metric_parts_add_across_ranks(num_valid):
    """The parts of two halves, summed as ``all_reduce`` sums them,
    finish to the whole batch's metrics."""
    gen = torch.Generator().manual_seed(4)
    out = torch.rand(6, 8, 10, 1, generator=gen) * 4 + 0.5
    label = torch.rand(6, 8, 10, 1, generator=gen) * 4
    label[0, 0, 0] = float("nan")
    label[4, 1, 1] = 0.0
    valid = 6 if num_valid is None else num_valid
    parts = sum(depth_metric_parts(out[3 * r:3 * r + 3],
                                   label[3 * r:3 * r + 3],
                                   min(max(valid - 3 * r, 0), 3))
                for r in range(2))
    got = finish_depth_metrics(parts)
    ref = depth_metrics_batch(out, label, num_valid)
    for key, value in ref.items():
        torch.testing.assert_close(got[key], value, rtol=1e-6, atol=0,
                                   equal_nan=True)


def test_world_of_one_mesh_step_is_the_plain_step():
    """A mesh of one process, with and without ZeRO-1, changes nothing: the
    same weights, statistics and moments bit for bit, and the same train
    state file."""
    batch = {k: np.stack([SynthDataset()[i][j] for i in range(4)])
             for j, k in enumerate(("image", "depth"))}
    batch["num_valid"] = 3
    mesh = create_mesh(device="cpu")
    results = []
    for kw, step_kw in (({}, {}), (dict(mesh=mesh), dict(mesh=mesh)),
                        (dict(mesh=mesh, zero1=True), dict(mesh=mesh))):
        model = _tiny_model()
        state = create_train_state(model, 1e-3, 1e-4, **kw)
        step = make_train_step(preprocess=False, device="cpu", **step_kw)
        for _ in range(2):
            state, metrics = step(state, batch, 7)
        opt = serialization._opt_state_dict(state)
        results.append((model.state_dict(), metrics, opt))
    ref_state, ref_metrics, ref_opt = results[0]
    for state, metrics, opt in results[1:]:
        for key, value in ref_state.items():
            assert torch.equal(state[key], value), key
        for key, value in ref_metrics.items():  # log10 NaN in both
            torch.testing.assert_close(metrics[key], value, rtol=0, atol=0,
                                       equal_nan=True, msg=key)
        for a, b in zip(_leaves(opt), _leaves(ref_opt)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_step_refuses_a_state_of_another_layout():
    """A step of a mesh of several ranks refuses a state that was not
    replicated over that mesh, before it runs anything (the group is a
    stand-in: no collective is reached)."""
    mesh = dataclasses.replace(rank_of(2, 0), group=object())
    state = create_train_state(_tiny_model(), 1e-3)
    step = make_train_step(preprocess=False, device="cpu", mesh=mesh)
    batch = {k: np.stack([SynthDataset()[i][j] for i in range(2)])
             for j, k in enumerate(("image", "depth"))}
    with pytest.raises(ValueError, match="mesh"):
        step(state, batch, 0)


def test_a_trained_parameter_without_moments_is_not_written_as_zeros(
        tmp_path):
    model = _tiny_model()
    state = create_train_state(model, 1e-3)
    # before the first update there are no moments: zeros, count 0
    assert int(serialization._opt_state_dict(state)["1"]["0"]["count"]) == 0
    step = make_train_step(preprocess=False, device="cpu")
    batch = {k: np.stack([SynthDataset()[i][j] for i in range(2)])
             for j, k in enumerate(("image", "depth"))}
    state, _ = step(state, batch, 0)
    del state.optimizer.state[next(model.parameters())]
    with pytest.raises(RuntimeError, match="no Adam moments"):
        serialization.save_train_state(str(tmp_path / "s.ede"), state,
                                       encoder="resnet18", decoder="hu2018",
                                       epoch=0)


def test_mesh_serving_serves_the_ranks_rows():
    """Serving on rank r of a mesh returns rows of the whole batch's
    output; in a world of one, the mesh-less call bit for bit."""
    model = _tiny_model()
    images = torch.from_numpy(np.stack([SynthDataset()[i][0]
                                        for i in range(4)]))
    whole = make_serving_fn(model, device="cpu")(images)
    same = make_serving_fn(model, mesh=create_mesh(device="cpu"))(images)
    assert torch.equal(same, whole)
    for r in range(2):
        rows = make_serving_fn(model, mesh=rank_of(2, r))(images)
        torch.testing.assert_close(rows, whole[2 * r:2 * r + 2], rtol=1e-5,
                                   atol=1e-6)


class _Frames:
    """Image-only uint8 frames, as ``VideoFrameDataset`` yields them,
    recording which it decodes (frame i is filled with i)."""

    def __init__(self, n: int):
        self.n, self.read = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.read.append(i)
        return np.full((32, 48, 3), i, np.uint8)


@pytest.mark.parametrize("rank", [0, 1])
def test_data_parallel_benchmark_decodes_only_the_ranks_rows(tmp_path,
                                                             rank):
    """``inference_benchmark --data-parallel``: each rank of two decodes and
    serves only its rows of every global batch, the last one padded (the
    group is a stand-in: loading and serving issue no collective)."""
    from efficientdepthestimation_tpu_torch.apps import inference_benchmark

    mesh = dataclasses.replace(rank_of(2, rank), group=object())
    frames = _Frames(5)
    batches = list(distributed_batch_iterator(frames, 4, mesh))
    rows = [[0, 1], [4, 4]] if rank == 0 else [[2, 3], [4, 4]]
    assert [sorted(b) for b in batches] == [["image", "num_valid"]] * 2
    assert [b["image"][:, 0, 0, 0].tolist() for b in batches] == rows
    assert [b["num_valid"] for b in batches] == [4, 1]
    path = str(tmp_path / "RN18-HU.ede")
    serialization.save_checkpoint(path, _tiny_model(), encoder="resnet18",
                                  decoder="hu2018")
    frames.read.clear()
    inference_benchmark.benchmark_checkpoint(frames, path, 4, device="cpu",
                                             mesh=mesh)
    assert set(frames.read) == {i for r in rows for i in r}


def _tiny_model():
    return randomize_(build_model("resnet18", "hu2018"), 3)


def _loss_inputs(n: int):
    gen = torch.Generator().manual_seed(2)
    pred = torch.rand(n, 12, 16, generator=gen) * 8 + 1
    target = torch.rand(n, 12, 16, generator=gen) * 8 + 1
    return pred, target


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]
