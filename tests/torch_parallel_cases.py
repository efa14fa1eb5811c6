"""The data-parallel cases the port's multi-process tests run: each is run
by every rank of a gloo process group (``_torch_multiprocess_runner.py``)
and, with a mesh of one process, in the test process on the whole batch.
Imports torch only, so that the runner's processes start without JAX."""

import hashlib
import os

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.apps.common import make_serving_fn
from efficientdepthestimation_tpu_torch.apps.train import run_eval_epoch
from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
    _adam_states,
    load_checkpoint,
    save_train_state,
)
from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
    eval_pair,
    synthetic_train_set,
)
from efficientdepthestimation_tpu_torch.parallel import (
    distributed_batch_iterator,
    process_local_rows,
)
from efficientdepthestimation_tpu_torch.training.train_step import (
    create_train_state,
    make_eval_step,
    make_train_step,
    step_lr,
)

#: The global batch of every case; ENB0-HU's batch holds 3 valid rows, so
#: that the last rank's share is partly padding.
GLOBAL_BATCH = 4
ENB0_VALID = 3
ENB0_CROP = (64, 96)
ENB0_CHECKPOINT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "e2e", "ENB0-HU-synthetic.ede")


class SynthDataset:
    """``tests/multihost_common.SynthDataset``: 10 deterministic (image,
    depth) pairs, no file I/O (a copy, so that the runner needs no JAX)."""

    def __init__(self, n=10, image_hw=(32, 48)):
        self.n = n
        self.image_hw = image_hw

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        h, w = self.image_hw
        rng = np.random.default_rng(1000 + idx)
        image = rng.standard_normal((h, w, 3)).astype(np.float32)
        depth = rng.uniform(1, 9, (h // 2, w // 2, 1)).astype(np.float32)
        return image, depth


def resnet18_trajectory(mesh, init_path: str) -> dict:
    """``multihost_common.run_steps(global_batch_size=4)`` in the port: the
    JAX initial weights (``init_path``), Adam with L2 under
    ``step_lr(1e-3, 10)``, three steps over ``SynthDataset`` (the last
    batch 2 valid of 4, so that a second rank holds padding alone)."""
    model = load_checkpoint(init_path)[0]
    state = create_train_state(model, step_lr(1e-3, steps_per_epoch=10),
                               1e-4, mesh=mesh)
    step = make_train_step(preprocess=False, device="cpu", mesh=mesh)
    losses = []
    for batch in distributed_batch_iterator(SynthDataset(), GLOBAL_BATCH,
                                            mesh):
        state, metrics = step(state, batch, 7)
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "final_abs_rel": float(metrics["abs_rel"]),
            "final_step": state.step,
            "param_checksum": float(sum(p.detach().abs().sum().double()
                                        for p in model.parameters())),
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def digest(state: dict) -> str:
    """A hash of every tensor of a state dict, to compare replicas."""
    h = hashlib.sha256()
    for key, value in state.items():
        h.update(key.encode())
        h.update(value.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def enb0_batch() -> dict:
    """The ENB0-HU cases' global batch: 4 ``synthetic_train_set`` scenes,
    uint8 480×640, 3 of them valid."""
    pairs = synthetic_train_set(range(GLOBAL_BATCH))
    return {"image": np.stack([p[0] for p in pairs]),
            "depth": np.stack([p[1] for p in pairs]),
            "num_valid": ENB0_VALID}


def enb0_steps(mesh, *, steps: int = 1, accum_steps: int = 1,
               remat: str | None = None, zero1: bool = False,
               save: str | None = None) -> dict:
    """ENB0-HU from its trained ``.ede`` (better conditioned in f32 than
    random weights), drop-connect on, through the train preprocess at a
    64×96 crop: ``steps`` steps of the global batch,
    each rank on its rows. Returns the last step's metrics, gradients, the
    weights and statistics, and Adam's moments of the whole model (gathered
    from their owners under ZeRO-1); ``save`` writes the train state."""
    model = load_checkpoint(ENB0_CHECKPOINT)[0]
    assert model.E.drop_connect_rate > 0
    batch = enb0_batch()
    rows = process_local_rows(mesh, GLOBAL_BATCH, accum_steps)
    local = {"image": batch["image"][rows], "depth": batch["depth"][rows],
             "num_valid": batch["num_valid"]}
    state = create_train_state(model, 1e-3, 1e-4, mesh=mesh, zero1=zero1)
    step = make_train_step(crop_hw=ENB0_CROP, device="cpu", mesh=mesh,
                           accum_steps=accum_steps, remat=remat)
    for _ in range(steps):
        state, metrics = step(state, local, 3)
    count, adams = _adam_states(state)
    if save is not None:
        save_train_state(save, state, encoder="efficientnet-b0",
                         decoder="hu2018", epoch=0)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "count": count,
            "moments": {k: (a["exp_avg"].clone(), a["exp_avg_sq"].clone())
                        for k, a in adams.items()}}


def eval_pairs(n: int = 5) -> list:
    """``n`` test-split pairs (uint8 frames, uint16 mm depths)."""
    return [eval_pair(100 + i) for i in range(n)]


def eval_epoch(mesh, init_path: str) -> dict:
    """``run_eval_epoch`` of the resnet18-HU weights over 5 test pairs at
    the global batch (the last batch 1 valid of 4), at a 32×48 crop."""
    model = load_checkpoint(init_path)[0]
    step = make_eval_step(device="cpu", mesh=mesh)
    tracker = run_eval_epoch(model, step, eval_pairs(), GLOBAL_BATCH,
                             crop_hw=(32, 48), device="cpu", mesh=mesh)
    return tracker.to_dict()


def serve(mesh, init_path: str) -> torch.Tensor:
    """The serving pipeline (uint8 frames in, depth at frame size out) of
    the resnet18-HU weights over 4 frames: this rank's rows."""
    model = load_checkpoint(init_path)[0]
    frames = np.stack([p[0] for p in eval_pairs(GLOBAL_BATCH)])
    infer = make_serving_fn(model, upsample_to=(480, 640), preprocess=True,
                            device="cpu", mesh=mesh)
    return infer(torch.from_numpy(frames))

