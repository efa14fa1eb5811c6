"""The hand-written kernels as registered ``ede::`` ops, on the CPU.

Each op passes ``torch.library.opcheck`` (schema, autograd registration,
fake implementation, AOT dispatch with dynamic shapes) at small shapes; a
module that calls every op exports with ``torch.export`` with the ops in
its graph, and the exported program computes what the eager calls do; and
the f32 ENB0-HU training step, whose upsample-conv and loss now go
through the ops, still matches the JAX training fixture with each
kernel's plain version called as often as the card launches the kernel.
"""

import numpy as np
import pytest
import torch
from torch import nn

from efficientdepthestimation_tpu_torch.ops.kernels import (
    depthwise,
    fused_loss,
    upproj,
)
from efficientdepthestimation_tpu_torch.ops.kernels.depthwise import (
    depthwise_bn_swish,
)
from efficientdepthestimation_tpu_torch.ops.kernels.fused_loss import (
    fused_depth_loss,
    fused_depth_loss_bwd,
    fused_depth_loss_fwd,
)
from efficientdepthestimation_tpu_torch.ops.kernels.upproj import upsample_conv


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _dw_args(dtype, stride, pad, seed=0):
    g = _gen(seed)
    x = torch.randn(2, 9, 11, 8, generator=g).to(dtype)
    taps = torch.randn(3, 3, 8, generator=g).to(dtype)
    scale = torch.rand(8, generator=g) + 0.5
    bias = torch.randn(8, generator=g)
    return x, taps, scale, bias, [stride, stride], list(pad)


def _up_args(dtype, grad=True):
    g = _gen(1)
    x = torch.randn(2, 4, 5, 6, generator=g).to(dtype)
    k = (0.2 * torch.randn(5, 5, 6, 4, generator=g)).to(dtype)
    return x.requires_grad_(grad), k.requires_grad_(grad), [8, 10]


def _loss_args(dtype=torch.float32):
    g = _gen(2)
    pred = (torch.rand(3, 6, 8, generator=g) * 4 + 1).to(dtype)
    target = torch.rand(3, 6, 8, generator=g) * 4 + 1
    return pred, target


def _case(name):
    if name.startswith("depthwise"):
        _, dt, stride = name.split("-")
        pad = (0, 1, 0, 1) if stride == "2" else (1, 1, 1, 1)
        return torch.ops.ede.depthwise_bn_swish, _dw_args(
            getattr(torch, dt), int(stride), pad)
    if name.startswith("upsample_conv"):
        dt = getattr(torch, name.split("-")[1])
        return torch.ops.ede.upsample_conv, _up_args(dt)
    pred, target = _loss_args(torch.bfloat16 if "bf16" in name
                              else torch.float32)
    mask = torch.tensor([1.0, 0.0, 1.0])
    if name.startswith("loss_fwd"):
        return torch.ops.ede.fused_depth_loss_fwd, (pred, target)
    if name.startswith("loss_bwd"):
        return torch.ops.ede.fused_depth_loss_bwd, (
            pred, target, mask, torch.tensor([0.25]))
    denominator = 4.0 if name.endswith("denominator") else None
    return torch.ops.ede.fused_depth_loss, (
        pred.requires_grad_(), target, mask, denominator)


@pytest.mark.parametrize("name", [
    "depthwise-float32-1", "depthwise-float32-2", "depthwise-bfloat16-2",
    "upsample_conv-float32", "upsample_conv-bfloat16", "loss_fwd",
    "loss_fwd-bf16", "loss_bwd", "loss", "loss-denominator"])
def test_opcheck(name):
    op, args = _case(name)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


class _AllOps(nn.Module):
    def forward(self, x, taps, scale, bias, xu, k, pred, target, mask, coef):
        y, sums = depthwise_bn_swish(x, taps, scale, bias, stride=2,
                                     padding=((0, 1), (0, 1)))
        u = upsample_conv(xu, k, (8, 10))
        return (y, sums, u, fused_depth_loss_fwd(pred, target),
                fused_depth_loss_bwd(pred, target, mask, coef))


def test_export_keeps_the_ops():
    """``torch.export`` of the wrappers: each op one node of the graph,
    shapes from the fake implementations, values those of eager calls."""
    x, taps, scale, bias, _, _ = _dw_args(torch.float32, 2, (0, 1, 0, 1))
    xu, k, _ = _up_args(torch.float32, grad=False)
    pred, target = _loss_args()
    args = (x, taps, scale, bias, xu, k, pred, target,
            torch.tensor([1.0, 0.0, 1.0]), torch.tensor([0.5]))
    program = torch.export.export(_AllOps(), args, strict=False)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert sorted(t for t in targets if t.startswith("ede.")) == [
        "ede.depthwise_bn_swish.default", "ede.fused_depth_loss_bwd.default",
        "ede.fused_depth_loss_fwd.default", "ede.upsample_conv.default"]
    got = program.module()(*args)
    want = _AllOps()(*args)
    assert [tuple(t.shape) for t in got] == [
        (2, 4, 5, 8), (2, 8), (2, 8, 10, 4), (3, 4), (3, 6, 8)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_meta_tensors_take_the_fake_implementations():
    """The ops on meta tensors (no data): output shapes and dtypes under
    stride and asymmetric padding, the upsampled size, the loss pair's."""
    meta = dict(device="meta")
    y, sums = torch.ops.ede.depthwise_bn_swish(
        torch.empty(2, 13, 17, 8, dtype=torch.bfloat16, **meta),
        torch.empty(5, 5, 8, dtype=torch.bfloat16, **meta),
        torch.empty(8, **meta), torch.empty(8, **meta), [2, 2], [1, 2, 2, 1])
    assert (y.shape, y.dtype, sums.shape, sums.dtype) == (
        (2, 6, 8, 8), torch.bfloat16, (2, 8), torch.float32)
    u = torch.ops.ede.upsample_conv(torch.empty(3, 4, 5, 6, **meta),
                                    torch.empty(5, 5, 6, 10, **meta), [9, 11])
    assert u.shape == (3, 9, 11, 10)
    p = torch.empty(4, 6, 8, dtype=torch.bfloat16, **meta)
    t = torch.empty(4, 6, 8, **meta)
    assert torch.ops.ede.fused_depth_loss_fwd(p, t).shape == (4, 4)
    dp = torch.ops.ede.fused_depth_loss_bwd(p, t, torch.empty(4, **meta),
                                            torch.empty(1, **meta))
    assert (dp.shape, dp.dtype) == ((4, 6, 8), torch.bfloat16)


def test_loss_gradient_is_the_backward_op():
    """The loss op's autograd formula is the backward op with the mean's
    coefficient; no CPU call counts as a launch."""
    pred, target = _loss_args()
    pred.requires_grad_()
    counts = (fused_depth_loss_fwd.launches, fused_depth_loss_bwd.launches)
    loss = fused_depth_loss(pred, target, num_valid=2, denominator=5)
    loss.backward()
    mask = torch.tensor([1.0, 1.0, 0.0])
    coef = torch.tensor([1.0 / (5 * 6 * 8)])
    assert torch.equal(pred.grad, fused_depth_loss_bwd(pred.detach(), target,
                                                       mask, coef))
    assert (fused_depth_loss_fwd.launches,
            fused_depth_loss_bwd.launches) == counts


def test_training_step_matches_fixture_through_the_ops(monkeypatch):
    """One f32 ENB0-HU step (drop-connect off) on the JAX fixture's batch
    and draws: its loss and metrics match the fixture, and the kernels'
    plain versions are called as often as the card launches the kernels
    (2 upsample-conv in f32, one loss forward, one loss backward, no
    depthwise in training)."""
    import make_torch_train_fixture as mk

    from efficientdepthestimation_tpu_torch.apps.common import (
        load_any_checkpoint,
    )
    from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
        synthetic_train_set,
    )
    from efficientdepthestimation_tpu_torch.training.train_step import (
        create_train_state,
        make_train_step,
    )

    calls = []
    for module, name in ((depthwise, "depthwise_bn_swish_plain"),
                         (upproj, "upsample_conv_plain"),
                         (fused_loss, "fused_depth_loss_fwd_plain"),
                         (fused_loss, "fused_depth_loss_bwd_plain")):
        plain = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _p=plain, _n=name, **k:
                            calls.append(_n) or _p(*a, **k))
    fixture = dict(np.load(mk.FIXTURE_PATH))
    pairs = synthetic_train_set(mk.SEEDS)
    batch = {"image": torch.from_numpy(np.stack([p[0] for p in pairs])),
             "depth": torch.from_numpy(np.stack([p[1] for p in pairs])),
             "num_valid": len(pairs)}
    model = load_any_checkpoint(mk.CHECKPOINT, device="cpu")
    model.E.drop_connect_rate = 0.0
    state = create_train_state(model, mk.LR, mk.WEIGHT_DECAY)
    draws = {k[len("draw_"):]: torch.from_numpy(v)
             for k, v in fixture.items() if k.startswith("draw_")}
    _, metrics = make_train_step(crop_hw=mk.CROP_HW, device="cpu")(
        state, batch, 0, draws=draws)
    for name, value in metrics.items():
        np.testing.assert_allclose(float(value),
                                   float(fixture[f"metric/{name}"]),
                                   rtol=1e-5, err_msg=name)
    assert [calls.count(n) for n in (
        "depthwise_bn_swish_plain", "upsample_conv_plain",
        "fused_depth_loss_fwd_plain", "fused_depth_loss_bwd_plain")] == [
        0, 2, 1, 1]
