"""Card-only tests of the PyTorch port's CUDA kernels, serving and training.

Each test skips, inside its body, where there is no CUDA card. This file
imports no JAX, so it runs on a machine that has none; the repo's
``conftest.py`` imports JAX, hence on the card:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
    make_infer_fn,
    make_serving_fn,
)
from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
    synthetic_train_set,
)
from efficientdepthestimation_tpu_torch.ops.kernels.depthwise import (
    depthwise_bn_swish,
    depthwise_bn_swish_plain,
)
from efficientdepthestimation_tpu_torch.ops.kernels.fused_loss import (
    fused_depth_loss,
    fused_depth_loss_bwd,
    fused_depth_loss_bwd_plain,
    fused_depth_loss_fwd,
    fused_depth_loss_fwd_plain,
    masked_total,
)
from efficientdepthestimation_tpu_torch.ops.kernels.upproj import (
    upsample_conv,
    upsample_conv_plain,
)
from efficientdepthestimation_tpu_torch.training.train_step import (
    create_train_state,
    make_train_step,
)

from make_torch_port_fixture import CHECKPOINT, FIXTURE_PATH, fixture_frames

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _dw_args(dtype, c=72, hw=(17, 23), b=3):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(b, *hw, c, generator=g)
    taps = torch.randn(5, 5, c, generator=g)
    scale = torch.rand(c, generator=g) + 0.5
    bias = torch.randn(c, generator=g)
    return [x.to(dtype).cuda(), taps.to(dtype).cuda(), scale.cuda(),
            bias.cuda()]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_kernels_match_plain_on_card(dtype, tol):
    _need_card()
    args = _dw_args(dtype)
    for stride, pad in ((1, ((2, 2), (2, 2))), (2, ((1, 2), (1, 2)))):
        y, sums = depthwise_bn_swish(*args, stride=stride, padding=pad)
        y_ref, sums_ref = depthwise_bn_swish_plain(*args, stride, pad)
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(sums, sums_ref, rtol=1e-4, atol=1e-2)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 9, 11, 20, generator=g).to(dtype).cuda()
    k = (0.1 * torch.randn(5, 5, 20, 36, generator=g)).to(dtype).cuda()
    torch.testing.assert_close(upsample_conv(x, k, (18, 22)).float(),
                               upsample_conv_plain(x, k, (18, 22)).float(),
                               rtol=tol, atol=tol)


def test_launch_counters_count_card_launches():
    _need_card()
    args = _dw_args(torch.bfloat16)
    before = depthwise_bn_swish.launches
    depthwise_bn_swish(*args, stride=1, padding=2)
    depthwise_bn_swish_plain(*args, 1, 2)
    assert depthwise_bn_swish.launches == before + 1
    x = torch.zeros(1, 4, 4, 8, device="cuda")
    before = upsample_conv.launches
    upsample_conv(x, torch.zeros(5, 5, 8, 4, device="cuda"), (8, 8))
    assert upsample_conv.launches == before + 1


def test_wrappers_check_their_inputs_on_card():
    _need_card()
    x, taps, scale, bias = _dw_args(torch.bfloat16)
    with pytest.raises(TypeError):
        depthwise_bn_swish(x, taps.float(), scale, bias)
    with pytest.raises(ValueError, match="contiguous"):
        depthwise_bn_swish(x.transpose(1, 2), taps, scale, bias)
    with pytest.raises(ValueError, match="k must be 3 or 5"):
        depthwise_bn_swish(x, torch.zeros(7, 7, 72, dtype=x.dtype,
                                          device="cuda"), scale, bias)
    with pytest.raises(ValueError, match="do not fit"):
        upsample_conv(x, torch.zeros(3, 3, 72, 4, dtype=x.dtype,
                                     device="cuda"), (34, 46))


def test_serving_on_card_matches_fixture():
    _need_card()
    fixture = np.load(FIXTURE_PATH)
    model = load_any_checkpoint(CHECKPOINT)
    frames = torch.from_numpy(fixture_frames()).cuda()
    out32 = make_infer_fn(model, preprocess=True)(frames)[..., 0].cpu()
    np.testing.assert_allclose(out32.numpy(), fixture["depth"], rtol=1e-3,
                               atol=1e-3)
    dw, up = depthwise_bn_swish.launches, upsample_conv.launches
    out = make_serving_fn(model, upsample_to=None)(frames)[..., 0].cpu()
    assert (depthwise_bn_swish.launches - dw,
            upsample_conv.launches - up) == (16, 4)
    err = np.abs(out.numpy() - fixture["depth"])
    assert err.max() <= 0.5 and err.mean() <= 0.05


def _loss_args(dtype, shape=(5, 37, 70), seed=0):
    """pred in ``dtype`` and f32 target on the card; image 0 flat in both,
    image 1 with pred == target."""
    g = torch.Generator().manual_seed(seed)
    target = torch.rand(shape, generator=g) * 8 + 1
    pred = torch.rand(shape, generator=g) * 8 + 1
    pred[0] = target[0] = 3.0
    pred[1] = target[1]
    return pred.to(dtype).cuda(), target.cuda()


# Kernel vs plain version: per-image sums of up to 17,328 O(1) terms in
# another order (rtol 1e-5, atol 1e-2); dp f32 to 1e-4 relative and 1e-5 of
# its largest value, bf16 within one bf16 step (2^-8 relative).
@pytest.mark.parametrize("dtype,dp_tol", [(torch.float32, 1e-4),
                                          (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", [(5, 37, 70), (64, 114, 152)])
def test_loss_kernels_match_plain_on_card(dtype, dp_tol, shape):
    _need_card()
    pred, target = _loss_args(dtype, shape)
    sums = fused_depth_loss_fwd(pred, target)
    ref = fused_depth_loss_fwd_plain(pred, target)
    torch.testing.assert_close(sums, ref, rtol=1e-5, atol=1e-2)
    assert torch.equal(sums, fused_depth_loss_fwd(pred, target))  # no atomics
    for num_valid in (shape[0], 3):
        mask = (torch.arange(shape[0], device="cuda") < num_valid).float()
        coef = torch.full((1,), 0.7 / (num_valid * shape[1] * shape[2]),
                          device="cuda")
        dp = fused_depth_loss_bwd(pred, target, mask, coef)
        dp_ref = fused_depth_loss_bwd_plain(pred, target, mask, coef)
        assert dp.dtype == dtype
        scale = dp_ref.float().abs().max().item()
        torch.testing.assert_close(dp.float(), dp_ref.float(), rtol=dp_tol,
                                   atol=max(dp_tol, 1e-5) * scale)
        assert not dp[0].any()  # flat: exactly zero, sign(0) = 0
        assert not dp[num_valid:].any()
        torch.testing.assert_close(masked_total(sums, mask, shape[1] *
                                                shape[2]),
                                   masked_total(ref, mask, shape[1] *
                                                shape[2]), rtol=1e-5,
                                   atol=1e-6)


def test_loss_launch_counters_count_card_launches():
    _need_card()
    pred, target = _loss_args(torch.bfloat16)
    pred.requires_grad_()
    fwd, bwd = fused_depth_loss_fwd.launches, fused_depth_loss_bwd.launches
    fused_depth_loss(pred[..., None], target[..., None], 4).backward()
    fused_depth_loss_fwd_plain(pred.detach(), target)
    assert (fused_depth_loss_fwd.launches - fwd,
            fused_depth_loss_bwd.launches - bwd) == (1, 1)
    assert pred.grad.dtype == torch.bfloat16 and not pred.grad[4].any()


def test_loss_wrappers_check_their_inputs_on_card():
    _need_card()
    pred, target = _loss_args(torch.float32)
    with pytest.raises(TypeError):
        fused_depth_loss_fwd(pred, target.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        fused_depth_loss_fwd(pred.transpose(1, 2), target.transpose(1, 2))
    with pytest.raises(ValueError, match="both be"):
        fused_depth_loss_fwd(pred, target[:, :-1])
    with pytest.raises(ValueError, match="mask"):
        fused_depth_loss_bwd(pred, target, torch.ones(4, device="cuda"),
                             torch.ones(1, device="cuda"))


def test_bf16_train_step_on_card():
    """One bf16 ENB0-HU step at batch 4: 1 + 1 loss launches, 4
    upsample_conv, no depthwise kernel; finite loss; f32 masters move."""
    _need_card()
    model = load_any_checkpoint(CHECKPOINT)
    state = create_train_state(model, 1e-4)
    step = make_train_step(mixed_precision=True)
    pairs = synthetic_train_set(range(4))
    batch = {"image": torch.from_numpy(np.stack([p[0] for p in pairs])),
             "depth": torch.from_numpy(np.stack([p[1] for p in pairs])),
             "num_valid": 3}
    before = model.R.conv2.weight.detach().clone()
    counters = (fused_depth_loss_fwd, fused_depth_loss_bwd, upsample_conv,
                depthwise_bn_swish)
    start = [c.launches for c in counters]
    state, metrics = step(state, batch, 0)
    torch.cuda.synchronize()
    assert [c.launches - s for c, s in zip(counters, start)] == [1, 1, 4, 0]
    assert np.isfinite(metrics["loss"].item())
    assert metrics["batch_size"].item() == 3.0
    assert model.R.conv2.weight.dtype == torch.float32
    assert not torch.equal(model.R.conv2.weight, before)
