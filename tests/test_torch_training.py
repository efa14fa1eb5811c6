"""The PyTorch port's training pieces against the JAX package, on the CPU.

Each piece gets the same numpy inputs (and weights, through
``from_jax_variables``) in both packages, in f32; gradients and updated
statistics are compared leaf by leaf through ``to_jax_leaf``. The loss runs
the port's plain versions (what the kernel pair computes on the card)
against ``fused_depth_loss(..., interpret=True)``. Tolerances are stated
beside each comparison.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from efficientdepthestimation_tpu.data.datasets import (
    batch_iterator as jax_batch_iterator,
)
from efficientdepthestimation_tpu.data.transforms import (
    train_preprocess as jax_train_preprocess,
)
from efficientdepthestimation_tpu.models import common as jcommon
from efficientdepthestimation_tpu.models import efficientnet as jeff
from efficientdepthestimation_tpu.models import hu2018 as jhu
from efficientdepthestimation_tpu.ops.pallas.fused_loss import (
    fused_depth_loss as jax_fused_depth_loss,
)
from efficientdepthestimation_tpu.training import metrics as jmetrics
from efficientdepthestimation_tpu.training.train_step import (
    adam_with_l2,
    step_lr as jax_step_lr,
)

from efficientdepthestimation_tpu_torch.apps import train as ptrain
from efficientdepthestimation_tpu_torch.apps.common import load_any_checkpoint
from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    from_jax_variables,
    to_jax_leaf,
)
from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
    read_ede,
)
from efficientdepthestimation_tpu_torch.data import synthetic_nyu
from efficientdepthestimation_tpu_torch.data.datasets import batch_iterator
from efficientdepthestimation_tpu_torch.data.transforms import (
    draw_augmentation,
    train_preprocess,
)
from efficientdepthestimation_tpu_torch.models.common import BatchNorm
from efficientdepthestimation_tpu_torch.models.efficientnet import (
    EfficientNetFeatures,
    MBConvBlock,
)
from efficientdepthestimation_tpu_torch.models import hu2018
from efficientdepthestimation_tpu_torch.models.hu2018 import UpProjection
from efficientdepthestimation_tpu_torch.ops.kernels.fused_loss import (
    fused_depth_loss,
    fused_depth_loss_bwd,
    fused_depth_loss_bwd_plain,
    fused_depth_loss_fwd,
    fused_depth_loss_fwd_plain,
)
from efficientdepthestimation_tpu_torch.ops.kernels.upproj import upsample_conv
from efficientdepthestimation_tpu_torch.training import metrics as pmetrics
from efficientdepthestimation_tpu_torch.training import train_step as pstep
from efficientdepthestimation_tpu_torch.training.loss import depth_loss

from make_torch_port_fixture import CHECKPOINT
from make_torch_train_fixture import augmentation_draws

# f32 on the CPU, sums in another order: outputs to 1e-5; gradients, which
# pass back through batch statistics (sums over N·H·W), to 1e-4 relative
# and, since such sums cancel in some elements, 1e-5 of the largest value
# of their tensor (at least 1e-5) absolute.
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on a few cores: two
    PyTorch intra-op threads each keep them from oversubscribing the
    cores, which slows a CPU training step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_grad_close(actual, expected, err_msg=""):
    expected = np.asarray(expected)
    atol = GRAD_ATOL * max(1.0, float(np.abs(expected).max()))
    np.testing.assert_allclose(actual, expected, rtol=GRAD_RTOL, atol=atol,
                               err_msg=err_msg)


def _leaf(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return np.asarray(tree)


def _assert_grads_match(module, jax_grads):
    """Every parameter gradient of the port against its JAX leaf."""
    for name, p in module.named_parameters():
        _, path, grad = to_jax_leaf(name, p.grad)
        _assert_grad_close(grad, _leaf(jax_grads, path), name)


def _assert_stats_match(module, jax_stats):
    """Updated running statistics: one f32 EMA step, to 1e-6."""
    for name, buf in module.named_buffers():
        _, path, value = to_jax_leaf(name, buf)
        np.testing.assert_allclose(value, _leaf(jax_stats, path), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def _randomized(variables, seed):
    """Running statistics and BN affine parameters off their init."""
    rng = np.random.default_rng(seed)

    def randomize(path, leaf):
        name = path[-1].key
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape), leaf.dtype)
        if name in ("mean", "bias") or (name == "scale" and leaf.ndim == 1):
            return jnp.asarray(rng.uniform(-0.2, 0.2, leaf.shape)
                               + (name == "scale"), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(randomize, variables)


def _grads_and_stats(module, variables, x, g, *args, **kw):
    """JAX training-mode apply: output, new batch_stats, and the gradients
    of sum(out·g) in the params and in x."""

    def f(params, xx):
        out, upd = module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            xx, *args, mutable=["batch_stats"], **kw)
        return jnp.sum(out * g), (out, upd["batch_stats"])

    (_, (out, stats)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"], x)
    return out, stats, gp, gx


def _port_module(module, variables):
    module.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    return module.train()


# ---------------------------------------------------------------- the loss


def _loss_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(1.0, 9.0, (*shape, 1)).astype(np.float32)
    target = rng.uniform(1.0, 9.0, (*shape, 1)).astype(np.float32)
    pred[0] = target[0] = 2.5  # a flat image: every gradient is 0 there
    pred[1] = target[1]        # pred == target, not flat
    pred[-1, 3:9, 4:12] = 6.0  # a flat patch in pred only
    return pred, target


@pytest.mark.parametrize("num_valid", [None, 2])
@pytest.mark.parametrize("shape", [(3, 17, 23), (2, 114, 152)])
def test_fused_loss_plain_matches_jax(shape, num_valid):
    """Value and gradient of the plain path against the Pallas kernel in
    interpret mode with its custom VJP; f32, to 1e-5 relative (value) and
    1e-6 absolute (gradients of size ~1/(N·H·W))."""
    pred, target = _loss_inputs(shape, seed=sum(shape))
    ref, ref_grad = jax.value_and_grad(
        lambda p: jax_fused_depth_loss(p, jnp.asarray(target), True,
                                       num_valid=num_valid))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    loss = fused_depth_loss(p, torch.from_numpy(target), num_valid)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-4, atol=1e-6)
    assert not p.grad[0].any()  # flat image: exactly zero
    if num_valid == 2 and shape[0] == 3:
        assert not p.grad[2].any()  # beyond num_valid: no gradient


def test_fused_loss_matches_autograd_of_depth_loss():
    """The closed-form backward against autograd through the plain
    ``training.loss.depth_loss`` (sign(0) = 0 in both); f32, 1e-6."""
    pred, target = _loss_inputs((4, 29, 31), seed=3)
    p1 = torch.from_numpy(pred).requires_grad_()
    p2 = torch.from_numpy(pred).requires_grad_()
    t = torch.from_numpy(target)
    l1 = fused_depth_loss(p1, t, 3)
    l2 = depth_loss(p2, t, 3)
    (l1 + l2).backward()
    np.testing.assert_allclose(l1.item(), l2.item(), rtol=1e-5)
    np.testing.assert_allclose(p1.grad.numpy(), p2.grad.numpy(), rtol=1e-4,
                               atol=1e-7)


def test_fused_loss_wrappers_run_plain_on_cpu():
    pred, target = _loss_inputs((2, 9, 13), seed=4)
    p = torch.from_numpy(pred[..., 0]).bfloat16()
    t = torch.from_numpy(target[..., 0])
    fwd, bwd = fused_depth_loss_fwd.launches, fused_depth_loss_bwd.launches
    sums = fused_depth_loss_fwd(p, t)
    assert sums.shape == (2, 4) and sums.dtype == torch.float32
    assert torch.equal(sums, fused_depth_loss_fwd_plain(p, t))
    mask, coef = torch.ones(2), torch.full((1,), 0.5)
    dp = fused_depth_loss_bwd(p, t, mask, coef)
    assert dp.dtype == torch.bfloat16 and dp.shape == p.shape
    assert torch.equal(dp, fused_depth_loss_bwd_plain(p, t, mask, coef))
    assert (fused_depth_loss_fwd.launches, fused_depth_loss_bwd.launches) \
        == (fwd, bwd)  # no kernel on the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        fused_depth_loss_fwd(p.to("meta"), t.to("meta"))


# ------------------------------------------------- modules in training mode


def test_batch_norm_train_matches_jax():
    """Batch statistics from E[x²]−E[x]², unbiased running variance, EMA
    with the module's momentum; output, gradients and statistics."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 5, 7, 6)) * 2 + 1).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jm = jcommon.BatchNorm(momentum=0.01, eps=1e-3)
    variables = _randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                    use_running_average=True), 6)
    out, stats, gp, gx = _grads_and_stats(jm, variables, jnp.asarray(x),
                                          jnp.asarray(g),
                                          use_running_average=False)
    bn = _port_module(BatchNorm(6, eps=1e-3, momentum=0.01), variables)
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out),
                               **OUT_TOL)
    _assert_grad_close(xt.grad.numpy(), gx)
    _assert_grads_match(bn, gp)
    _assert_stats_match(bn, stats)


def test_mbconv_train_matches_jax():
    """A stride-1 residual MBConv (expand 6, SE) in training with
    drop-connect at rate 0.3: the mask JAX drew is read off its output (a
    dropped sample's output equals its input exactly) and injected into
    the port."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 9, 11, 16)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    args = dict(kernel=3, stride=1, expand=6, cin=16, cout=16, se=0.25,
                image_size=(224, 224))
    jm = jeff.MBConvBlock(**args, drop_rate=0.3)
    variables = _randomized(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)),
                            8)
    out, stats, gp, gx = _grads_and_stats(
        jm, variables, jnp.asarray(x), jnp.asarray(g), True,
        rngs={"dropout": jax.random.PRNGKey(11)})
    out = np.asarray(out)
    mask = (out != x).any(axis=(1, 2, 3))
    assert 0 < mask.sum() < len(mask), mask  # both kinds of sample
    block = _port_module(MBConvBlock(**args), variables)
    xt = torch.from_numpy(x).requires_grad_()
    y = block(xt, torch.from_numpy(mask.astype(np.float32))[:, None, None,
                                                            None], 0.7)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), out, **OUT_TOL)
    _assert_grad_close(xt.grad.numpy(), gx)
    _assert_grads_match(block, gp)
    _assert_stats_match(block, stats)


def test_drop_connect_draws_from_the_generator():
    enc = EfficientNetFeatures("efficientnet-b0").train()
    x = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = enc(x, generator=torch.Generator().manual_seed(1))
        b = enc(x, generator=torch.Generator().manual_seed(1))
        c = enc(x, generator=torch.Generator().manual_seed(2))
        with pytest.raises(ValueError, match="Generator"):
            enc(x)
        enc.drop_connect_rate = 0.0
        enc(x)  # no drop-connect, no generator needed
    assert all(torch.equal(s, t) for s, t in zip(a, b))
    assert not all(torch.equal(s, t) for s, t in zip(a, c))


@pytest.mark.parametrize("in_hw,size,cin,f", [
    ((7, 9), (14, 19), 16, 8),   # direct: the upsample_conv op and its VJP
    ((5, 6), (20, 24), 24, 8),   # the einsum rewrite
])
def test_upprojection_train_matches_jax(in_hw, size, cin, f, monkeypatch):
    """Each route forced, whatever ``should_fuse`` gives these shapes."""
    einsum = cin == 24
    monkeypatch.setattr(hu2018, "should_fuse", lambda *a: einsum)
    calls = []
    monkeypatch.setattr(hu2018, "upsample_conv",
                        lambda *a: calls.append(a) or upsample_conv(*a))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, *in_hw, cin)).astype(np.float32)
    g = rng.standard_normal((2, *size, f)).astype(np.float32)
    jm = jhu.UpProjection(features=f)
    variables = _randomized(
        jm.init(jax.random.PRNGKey(2), jnp.asarray(x), size), 10)
    out, stats, gp, gx = _grads_and_stats(jm, variables, jnp.asarray(x),
                                          jnp.asarray(g), size, True)
    up = _port_module(UpProjection(cin, f), variables)
    xt = torch.from_numpy(x).requires_grad_()
    y = up(xt, size)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out),
                               **OUT_TOL)
    _assert_grad_close(xt.grad.numpy(), gx)
    _assert_grads_match(up, gp)
    _assert_stats_match(up, stats)
    assert len(calls) == (0 if einsum else 1)


# ------------------------------------------------------- data and metrics


def test_train_preprocess_matches_jax():
    """Two 480×640 scenes, the draws rebuilt from the JAX key. Rotated
    uint8 values can round to the other side of .5 where the shear sums run
    in another order: at most 1 value in 10⁴ may differ, by at most one
    uint8 step after lighting, jitter and normalization (0.03); all else and
    the depths to 1e-4."""
    pairs = synthetic_nyu.synthetic_train_set((2, 3))
    images = np.stack([p[0] for p in pairs])
    depths = np.stack([p[1] for p in pairs])
    key = jax.random.PRNGKey(5)
    ref_i, ref_d = jax_train_preprocess(key, jnp.asarray(images),
                                        jnp.asarray(depths))
    draws = {k: torch.from_numpy(np.array(v))
             for k, v in augmentation_draws(key, 2).items()}
    out_i, out_d = train_preprocess(torch.from_numpy(images),
                                    torch.from_numpy(depths), draws)
    assert out_i.shape == (2, 228, 304, 3) and out_d.shape == (2, 114, 152, 1)
    err = np.abs(out_i.numpy() - np.asarray(ref_i))
    assert (err > 1e-4).sum() <= err.size // 10_000, (err > 1e-4).sum()
    assert err.max() <= 0.03
    np.testing.assert_allclose(out_d.numpy(), np.asarray(ref_d), rtol=1e-5,
                               atol=1e-4)


def test_draw_augmentation_shapes_and_ranges():
    d = draw_augmentation(torch.Generator().manual_seed(0), 256)
    assert d["flip"].dtype == torch.bool and d["flip"].shape == (256,)
    assert 0.3 < d["flip"].float().mean() < 0.7
    assert d["angles"].abs().max() <= 5.0 and d["alpha"].shape == (256, 3)
    assert sorted(d["order"].tolist()) == [0, 1, 2]
    for k in ("a_b", "a_c", "a_s"):
        assert d[k].shape == (256,) and d[k].abs().max() <= 0.4
    again = draw_augmentation(torch.Generator().manual_seed(0), 256)
    assert all(torch.equal(d[k], again[k]) for k in d)


def test_synthetic_scenes_match_jax():
    from efficientdepthestimation_tpu.data.synthetic_nyu import render_scene

    for seed in (0, 7):
        rgb, depth_m = render_scene(seed, (48, 64))
        prgb, pdepth = synthetic_nyu.render_scene(seed, (48, 64))
        assert np.array_equal(rgb, prgb) and np.array_equal(depth_m, pdepth)
    _, d8 = synthetic_nyu.train_pair(0, (48, 64))
    assert d8.dtype == np.uint8
    assert np.array_equal(d8, np.clip(render_scene(0, (48, 64))[1] * 25.5,
                                      0, 255).astype(np.uint8))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(shuffle=True, seed=3, pad_last=True),
    dict(shuffle=True, seed=3, pad_last=True, skip_batches=2),
    dict(drop_last=True),
])
def test_batch_iterator_matches_jax(kw):
    data = [(np.full((2, 3), i, np.uint8), np.full((2,), i, np.uint8))
            for i in range(11)]
    ours = list(batch_iterator(data, 4, **kw))
    ref = list(jax_batch_iterator(data, 4, **kw))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a["num_valid"] == b["num_valid"]
        assert np.array_equal(a["image"], b["image"])
        assert np.array_equal(a["depth"], b["depth"])


@pytest.mark.parametrize("num_valid", [None, 2])
def test_depth_metrics_match_jax(num_valid):
    """Sums with the reference's quirks: a zero and a NaN label, negative
    outputs (log10 NaN), padded samples; f32, to 1e-6."""
    rng = np.random.default_rng(11)
    out = rng.uniform(-0.5, 9, (3, 6, 7, 1)).astype(np.float32)
    lab = rng.uniform(0.5, 9, (3, 6, 7, 1)).astype(np.float32)
    lab[0, 0, 0] = 0.0
    ref = jmetrics.depth_metrics_batch(jnp.asarray(out), jnp.asarray(lab),
                                       num_valid=num_valid)
    ours = pmetrics.depth_metrics_batch(torch.from_numpy(out),
                                        torch.from_numpy(lab), num_valid)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-6,
                                   err_msg=k)
    lab[1, 2, 3] = np.nan
    ref = jmetrics.depth_metrics_batch(jnp.asarray(out), jnp.asarray(lab))
    ours = pmetrics.depth_metrics_batch(torch.from_numpy(out),
                                        torch.from_numpy(lab))
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-6,
                                   err_msg=k)


def test_metrics_tracker_matches_jax():
    ref, ours = jmetrics.MetricsTracker(), pmetrics.MetricsTracker()
    rng = np.random.default_rng(12)
    for i in range(4):
        sums = {k: float(rng.uniform(0, 2)) for k in ref.METRIC_KEYS}
        sums["batch_size"] = 2.0
        if i == 2:
            sums["log10"] = float("nan")  # ignored by the meter
        ref.update_from_sums(sums)
        ours.update_from_sums(sums)
    assert str(ours) == str(ref)
    assert ours.rmse == ref.rmse


# ----------------------------------------------------- step and optimizer


def test_step_lr_and_adam_with_l2_match_optax():
    """Three Adam updates with L2 decay under StepLR (2 steps an epoch,
    step_size 1, so the LR drops between updates), E frozen, against
    optax's chain; f32, to 1e-6."""
    rng = np.random.default_rng(13)
    shapes = {"E": (3, 4), "D": (5,), "R": (2, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    schedule = jax_step_lr(1e-2, steps_per_epoch=2, step_size=1)
    tx = adam_with_l2(schedule, 1e-2, frozen_prefixes=("E",))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    for g in grads:
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)

    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.tensor(v)))
    state = pstep.create_train_state(
        module, pstep.step_lr(1e-2, steps_per_epoch=2, step_size=1), 1e-2,
        frozen_prefixes=("E",))
    for g in grads:
        for k, p in module.named_parameters():
            p.grad = torch.tensor(g[k]) if p.requires_grad else None
        state.optimizer.step()
        state.scheduler.step()
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert schedule(5) == pstep.step_lr(1e-2, 2, 1)(5)


def test_training_entry_points_need_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pstep.make_train_step()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain.run_train_epoch(None, None, [], 2, 0, 0)
    pstep.make_train_step(device="cpu")


def test_run_train_epoch_on_cpu():
    """Three scenes at batch 2 (the second batch padded), ENB0-HU at a
    64×96 crop: metrics drained one step behind, hooks called, stop."""
    model = load_any_checkpoint(CHECKPOINT, device="cpu")
    state = pstep.create_train_state(model, 1e-4)
    step = pstep.make_train_step(crop_hw=(64, 96), device="cpu")
    data = synthetic_nyu.synthetic_train_set((0, 1, 2))
    saved = []
    state, summary, stopped = ptrain.run_train_epoch(
        state, step, data, 2, seed=0, epoch=0, save_every=1,
        checkpoint_cb=lambda s, e, k: saved.append((e, k)), device="cpu")
    assert not stopped and state.step == 2 and saved == [(0, 1), (0, 2)]
    assert np.isfinite(summary["loss"])
    state, _, stopped = ptrain.run_train_epoch(
        state, step, data, 2, seed=0, epoch=1, stop_after_steps=3,
        device="cpu")
    assert stopped and state.step == 3


def test_to_jax_leaf_inverts_from_jax_variables():
    _, tree = read_ede(CHECKPOINT)
    for key, value in from_jax_variables(tree).items():
        collection, path, arr = to_jax_leaf(key, value)
        assert np.array_equal(arr, _leaf(tree[collection], path)), key
