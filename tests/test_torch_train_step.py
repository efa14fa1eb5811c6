"""The PyTorch port's ENB0-HU training step against the JAX fixture.

``tests/make_torch_train_fixture.py`` records one JAX training step of
ENB0-HU (``e2e/ENB0-HU-synthetic.ede``, drop-connect off, two
``render_scene`` frames, the 228×304 crop, f32, the fused loss). Here the
port's CPU step, given the same augmentation draws, is held to it without
JAX, JAX must still reproduce it, and a bf16 step runs on the CPU.
"""

import numpy as np
import pytest
import torch

from efficientdepthestimation_tpu_torch.apps.common import load_any_checkpoint
from efficientdepthestimation_tpu_torch.checkpoints.convert import to_jax_leaf
from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
    synthetic_train_set,
)
from efficientdepthestimation_tpu_torch.ops.kernels.fused_loss import (
    fused_depth_loss_bwd,
    fused_depth_loss_fwd,
)
from efficientdepthestimation_tpu_torch.ops.kernels.upproj import upsample_conv
from efficientdepthestimation_tpu_torch.training.train_step import (
    create_train_state,
    make_train_step,
)

import make_torch_train_fixture as mk

# The port's f32 step against JAX's, both on the CPU: the loss and the
# metric sums to 1e-5 relative; gradients to 1e-2 relative to their leaf's
# largest value (measured 2.4e-3 at most: two implementations' sums over
# a whole ENB0-HU backward), BN statistics to 1e-5.
STEP_RTOL, GRAD_REL, STAT_TOL = 1e-5, 1e-2, dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on a few cores: two
    PyTorch intra-op threads each keep them from oversubscribing the
    cores, which slows a CPU training step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture():
    return dict(np.load(mk.FIXTURE_PATH))


def _batch(seeds=mk.SEEDS):
    pairs = synthetic_train_set(seeds)
    return {"image": torch.from_numpy(np.stack([p[0] for p in pairs])),
            "depth": torch.from_numpy(np.stack([p[1] for p in pairs])),
            "num_valid": len(seeds)}


def _state_entries(model, grads: bool) -> dict:
    """The model's gradients (or parameters and statistics), keyed
    ``collection/JAX path``."""
    items = (((n, p.grad) for n, p in model.named_parameters()) if grads
             else model.state_dict().items())
    out = {}
    for name, value in items:
        collection, path, arr = to_jax_leaf(name, value)
        out[f"{collection}/{path}"] = arr
    return out


def test_port_step_matches_fixture(fixture):
    batch = _batch()
    assert int(batch["image"].sum()) == int(fixture["frames_sum"])
    assert int(batch["depth"].sum()) == int(fixture["depths_sum"])
    model = load_any_checkpoint(mk.CHECKPOINT, device="cpu")
    model.E.drop_connect_rate = 0.0
    state = create_train_state(model, mk.LR, mk.WEIGHT_DECAY)
    step = make_train_step(crop_hw=mk.CROP_HW, device="cpu")
    draws = {k[len("draw_"):]: torch.from_numpy(v)
             for k, v in fixture.items() if k.startswith("draw_")}
    state, metrics = step(state, batch, 0, draws=draws)
    assert state.step == 1
    for name, value in metrics.items():
        np.testing.assert_allclose(float(value),
                                   float(fixture[f"metric/{name}"]),
                                   rtol=STEP_RTOL, err_msg=name)

    grads = _state_entries(model, grads=True)
    for path in mk.GRAD_LEAVES:
        ref = fixture[f"grad/{path}"]
        np.testing.assert_allclose(grads[f"params/{path}"], ref, rtol=0,
                                   atol=GRAD_REL * np.abs(ref).max(),
                                   err_msg=path)

    values = _state_entries(model, grads=False)
    for path in mk.STAT_LEAVES:
        np.testing.assert_allclose(values[f"batch_stats/{path}"],
                                   fixture[f"stat/{path}"], **STAT_TOL,
                                   err_msg=path)
    # Adam's first update is ±lr·g/(|g|+eps) per element: where g is within
    # float noise of 0 the two steps may go opposite ways (2·lr apart); at
    # most 1 element in 1000 may do so, every other agrees to 1e-6.
    for path in mk.PARAM_LEAVES:
        err = np.abs(values[f"params/{path}"] - fixture[f"param/{path}"])
        assert err.max() <= 2 * mk.LR * 1.001, path
        assert (err > 1e-6).sum() <= err.size // 1000, path


def test_jax_reproduces_fixture(fixture):
    """The JAX package still computes what the fixture holds (two ENB0-HU
    train-step compiles on the CPU, about half a minute)."""
    fresh = mk.jax_reference()
    assert set(fresh) == set(fixture)
    for key, value in fixture.items():
        np.testing.assert_allclose(fresh[key], value, rtol=1e-5, atol=1e-7,
                                   err_msg=key)


def test_bf16_step_on_cpu():
    """Mixed precision: bf16 activations and weights in the forward, f32
    masters updated, BN statistics move, the loss is finite; on the CPU
    the plain versions run and no kernel launch is counted."""
    model = load_any_checkpoint(mk.CHECKPOINT, device="cpu")
    state = create_train_state(model, 1e-4)
    step = make_train_step(mixed_precision=True, crop_hw=(64, 96),
                           device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    launches = (fused_depth_loss_fwd.launches, fused_depth_loss_bwd.launches,
                upsample_conv.launches)
    state, metrics = step(state, _batch((4, 5, 6)), 3)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["batch_size"]) == 3.0
    after = model.state_dict()
    assert all(v.dtype == torch.float32 for v in after.values()
               if v.is_floating_point())
    assert not torch.equal(after["R.conv2.weight"], before["R.conv2.weight"])
    assert not torch.equal(after["E._bn0.running_mean"],
                           before["E._bn0.running_mean"])
    assert launches == (fused_depth_loss_fwd.launches,
                        fused_depth_loss_bwd.launches,
                        upsample_conv.launches)
