"""Microbatch accumulation, the remat policies, ``split_preprocess`` and
``make_grad_snapshot`` of the port's training step, on the CPU.

The first four tests are ``tests/test_train_accum_remat.py``'s on the port
(with Adam, so gradients are compared where that file compares SGD
updates); then ``accum_steps=2`` against the JAX package's on the same
inputs, remat with drop-connect on (the same masks in the recompute, the BN
statistics moved once), ``split_preprocess`` bit for bit, and the gradient
probe. Models: ResNet-18 HU at random weights and 32×48 where the two
sides compute the same numbers, ENB0-HU from ``e2e/ENB0-HU-synthetic.ede``
on rendered scenes at 64×96 elsewhere (its f32 gradient is
well-conditioned there: ``test_torch_serialization``).
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from efficientdepthestimation_tpu.training import train_step as jstep

from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    to_jax_variables,
)
from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
    synthetic_train_set,
)
from efficientdepthestimation_tpu_torch.models.common import randomize_
from efficientdepthestimation_tpu_torch.models.registry import build_model
from efficientdepthestimation_tpu_torch.training import train_step as pstep

from test_torch_serialization import _enb0_hu, _scenes
from test_torch_train_families import _flat, check_gradients
from test_torch_train_step import STAT_TOL, STEP_RTOL

LR = WEIGHT_DECAY = 1e-4
# Tests whose two sides run the same operations on the same numbers in
# another grouping (a batch of 4 against two of 2): the gradients as
# check_gradients holds them; the loss and metric sums to STEP_RTOL.
METRICS = ("mae", "mse", "abs_rel", "delta1", "delta2", "delta3")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_model():
    return randomize_(build_model("resnet18", "hu2018"), 5)


def _batch(rng, n: int = 4) -> dict:
    return {"image": torch.from_numpy(
                rng.standard_normal((n, 32, 48, 3), np.float32)),
            "depth": torch.from_numpy(
                rng.uniform(1, 9, (n, 16, 24, 1)).astype(np.float32))}


def _step(model, batch, seed=7, **kw):
    """(metrics as floats, gradients, state) of one port step on a copy."""
    model = copy.deepcopy(model)
    state = pstep.create_train_state(model, LR, WEIGHT_DECAY)
    step = pstep.make_train_step(preprocess=False, device="cpu", **kw)
    state, metrics = step(state, batch, seed)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads, state


def _grad_tree(grads: dict) -> dict:
    return to_jax_variables(grads)["params"]


def test_accum_matches_single_step_on_duplicated_microbatch(rng):
    """Two identical microbatches, each weighted 1/2, give the gradient and
    loss of one: each microbatch runs the single step's forward."""
    model = _tiny_model()
    small = _batch(rng, 2)
    doubled = {k: torch.cat([v, v]) for k, v in small.items()}
    m_a, g_a, _ = _step(model, small)
    m_b, g_b, _ = _step(model, doubled, accum_steps=2)
    assert np.isclose(m_a["loss"], m_b["loss"], rtol=1e-6)
    for name, g in g_a.items():
        torch.testing.assert_close(g_b[name], g, rtol=1e-6, atol=1e-9,
                                   msg=name)


def test_accum_padded_tail_matches_monolithic_gradient():
    """[x1, x2, x1, x2] with num_valid=2: the monolithic masked step's BN
    statistics are each microbatch's, and the second microbatch is all
    padding (weight 0, its metric sums zeroed, no 0/0). ENB0-HU on rendered
    scenes: a random ResNet-18 at 32×48 is too ill-conditioned in f32 for
    a batch of 4 and two of 2 to agree to GRAD_REL."""
    model, _ = _enb0_hu()
    small = {k: torch.from_numpy(v) for k, v in _scenes((2, 3)).items()}
    batch = {k: torch.cat([v, v]) for k, v in small.items()}
    batch["num_valid"] = 2
    m_a, g_a, _ = _step(model, batch)
    m_b, g_b, _ = _step(model, batch, accum_steps=2)
    assert np.isfinite(m_b["loss"])
    for name in METRICS:
        assert np.isfinite(m_b[name]), f"{name} NaN through accum"
        np.testing.assert_allclose(m_b[name], m_a[name], rtol=STEP_RTOL,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(m_b["loss"], m_a["loss"], rtol=STEP_RTOL)
    assert m_a["batch_size"] == m_b["batch_size"] == 2.0
    check_gradients(_grad_tree(g_b), _grad_tree(g_a))


@pytest.mark.parametrize("mixed_precision", [False, True])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_matches_no_remat(remat, mixed_precision):
    """ENB0-HU with drop-connect on: the recompute draws the same masks and
    leaves the BN statistics as the forward moved them, so the step is the
    plain step's, bit for bit (the CPU repeats the same operations in the
    same order; bf16 too, the cast made once outside the recompute)."""
    model, _ = _enb0_hu()
    model.E.drop_connect_rate = 0.2
    batch = {k: torch.from_numpy(v) for k, v in _scenes((4, 5)).items()}
    kw = dict(mixed_precision=mixed_precision)
    m_a, g_a, s_a = _step(model, batch, **kw)
    m_b, g_b, s_b = _step(model, batch, remat=remat, **kw)
    assert m_a == m_b
    for name, g in g_a.items():
        assert torch.equal(g_b[name], g), name
    before = model.state_dict()
    after_a, after_b = s_a.model.state_dict(), s_b.model.state_dict()
    for name, value in after_a.items():
        assert torch.equal(after_b[name], value), name
    assert not torch.equal(after_b["E._bn0.running_mean"],
                           before["E._bn0.running_mean"])
    # drop-connect is on: another step seed draws other masks
    m_c, _, _ = _step(model, batch, seed=8, remat=remat, **kw)
    assert m_c["loss"] != m_b["loss"]


def test_bad_arguments_raise(rng):
    with pytest.raises(ValueError, match="remat"):
        pstep.make_train_step(remat="bogus", device="cpu")
    with pytest.raises(ValueError, match="accum_steps"):
        pstep.make_train_step(accum_steps=0, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        _step(_tiny_model(), _batch(rng, 3), accum_steps=2)


def _keep_grads() -> optax.GradientTransformation:
    """An optax transformation whose state is the last gradient and whose
    update is 0: the JAX step's gradient, read from its new state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def test_accum_matches_jax_accum():
    """``accum_steps=2`` on four rendered scenes with num_valid=3 (the
    second microbatch half padding) against the JAX package's
    ``accum_steps=2`` step: loss, metric sums, gradients, BN statistics."""
    model, jm = _enb0_hu()
    data = _scenes((6, 7, 8, 9))
    m, grads, state = _step(model, {**{k: torch.from_numpy(v)
                                       for k, v in data.items()},
                                    "num_valid": 3}, accum_steps=2)
    jstate = jstep.create_train_state(
        jm, to_jax_variables(model.state_dict()), _keep_grads())
    fed = {k: jnp.asarray(v) for k, v in data.items()}
    fed["num_valid"] = jnp.asarray(3, jnp.int32)
    new, ref = jstep.make_train_step(preprocess=False, donate=False,
                                     accum_steps=2)(jstate, fed,
                                                    jax.random.PRNGKey(0))
    for name, value in ref.items():
        np.testing.assert_allclose(m[name], float(value), rtol=STEP_RTOL,
                                   err_msg=name)
    check_gradients(_grad_tree(grads), jax.device_get(new.opt_state))
    stats = _flat(to_jax_variables(state.model.state_dict())["batch_stats"])
    for key, value in _flat(jax.device_get(new.batch_stats)).items():
        np.testing.assert_allclose(stats[key], value, **STAT_TOL,
                                   err_msg=key)


def _raw_batch() -> dict:
    pairs = synthetic_train_set((0, 1))
    return {"image": torch.from_numpy(np.stack([p[0] for p in pairs])),
            "depth": torch.from_numpy(np.stack([p[1] for p in pairs])),
            "num_valid": 2}


def test_split_preprocess_is_the_monolithic_step():
    model, _ = _enb0_hu()
    model.E.drop_connect_rate = 0.2
    batch = _raw_batch()
    out = []
    for split in (False, True):
        state = pstep.create_train_state(copy.deepcopy(model), LR,
                                         WEIGHT_DECAY)
        step = pstep.make_train_step(crop_hw=(64, 96), device="cpu",
                                     split_preprocess=split)
        state, metrics = step(state, batch, 3)
        out.append(({k: float(v) for k, v in metrics.items()},
                    state.model.state_dict()))
    assert out[0][0] == out[1][0]
    for name, value in out[0][1].items():
        assert torch.equal(out[1][1][name], value), name


def test_grad_snapshot_is_the_step_gradient_applied_to_nothing():
    """The probe draws the step's augmentation and masks (drop-connect on,
    E frozen: its gradient is still reported) and changes nothing."""
    model, _ = _enb0_hu()
    model.E.drop_connect_rate = 0.2
    batch = _raw_batch()
    state = pstep.create_train_state(model, LR, WEIGHT_DECAY,
                                     frozen_prefixes=("E",))
    state.step = 4
    before = {k: v.clone() for k, v in model.state_dict().items()}
    snapshot = pstep.make_grad_snapshot(crop_hw=(64, 96), device="cpu")
    grads = snapshot(state, batch, 3)
    after = model.state_dict()
    for name, value in before.items():
        assert torch.equal(after[name], value), name
    assert all(p.grad is None for p in model.parameters())
    assert not state.optimizer.state and state.step == 4
    assert sorted(grads) == sorted(n for n, _ in model.named_parameters())
    assert grads["E._conv_stem.weight"].abs().sum() > 0

    step = pstep.make_train_step(crop_hw=(64, 96), device="cpu")
    step(state, batch, 3)
    for name, p in model.named_parameters():
        if p.requires_grad:
            assert torch.equal(p.grad, grads[name]), name


# Calls of each kernel's plain version in one bf16 ENB0-HU step on the CPU,
# which the card replaces with launches (upsample-conv, loss forward, loss
# backward): the recompute runs the upsample-conv op again (the "dots"
# policy keeps aten matmuls and convs, not ``ede::upsample_conv``), and
# each microbatch runs the forward and the loss.
KERNEL_CALLS = {"none": (5, 1, 1), "full": (10, 1, 1), "dots": (10, 1, 1),
                "accum2": (10, 2, 2)}


@pytest.mark.parametrize("policy", sorted(KERNEL_CALLS))
def test_kernel_calls_per_step(policy, monkeypatch):
    from efficientdepthestimation_tpu_torch.ops.kernels import (
        fused_loss,
        upproj,
    )

    calls = []
    for module, name in ((upproj, "upsample_conv_plain"),
                         (fused_loss, "fused_depth_loss_fwd_plain"),
                         (fused_loss, "fused_depth_loss_bwd_plain")):
        plain = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _p=plain, _n=name, **k:
                            calls.append(_n) or _p(*a, **k))
    kw = ({"accum_steps": 2} if policy == "accum2" else
          {"remat": None if policy == "none" else policy})
    model, _ = _enb0_hu()
    state = pstep.create_train_state(model, LR)
    pstep.make_train_step(mixed_precision=True, crop_hw=(64, 96),
                          device="cpu", **kw)(state, _raw_batch(), 0)
    assert tuple(calls.count(n) for n in (
        "upsample_conv_plain", "fused_depth_loss_fwd_plain",
        "fused_depth_loss_bwd_plain")) == KERNEL_CALLS[policy]
