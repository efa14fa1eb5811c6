"""Card-only tests of the PyTorch port's CUDA kernels and serving path.

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
from efficientdepthestimation_tpu_torch.ops.kernels.depthwise import (
    depthwise_bn_swish,
    depthwise_bn_swish_plain,
)
from efficientdepthestimation_tpu_torch.ops.kernels.upproj import (
    upsample_conv,
    upsample_conv_plain,
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
