"""Card-only tests of the PyTorch port's CUDA kernels, serving and training.

Each test skips, inside its body, where there is no CUDA card. This file
imports no JAX, so it runs on a machine that has none; the repo's
``conftest.py`` imports JAX, hence on the card:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
    make_infer_fn,
    make_serving_fn,
)
from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
    synthetic_train_set,
)
from efficientdepthestimation_tpu_torch.models.common import randomize_
from efficientdepthestimation_tpu_torch.models.registry import build_model
from efficientdepthestimation_tpu_torch.ops.kernels import (
    depthwise,
    fused_loss,
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
from efficientdepthestimation_tpu_torch.ops.kernels import upproj
from efficientdepthestimation_tpu_torch.ops.kernels.upproj import (
    upsample_conv,
    upsample_conv_plain,
)
from efficientdepthestimation_tpu_torch.ops.conv import conv2d, depthwise_impl
from efficientdepthestimation_tpu_torch.ops.norm import batch_norm
from efficientdepthestimation_tpu_torch.ops.quant import (
    _int_mm,
    int_conv2d,
    quant_conv2d,
)
from efficientdepthestimation_tpu_torch.training.train_step import (
    create_train_state,
    make_train_step,
)

from make_torch_port_fixture import (
    CHECKPOINT,
    FIXTURE_PATH,
    LR_CHECKPOINT,
    LR_FIXTURE_PATH,
    fixture_frames,
)

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


# Kernel vs plain version on the card, as chip_smoke.TOL: sums in another
# order, so f32 y to f32 rounding, bf16 y within one bf16 step; the SE sums
# add up to 17,328 O(1) terms, hence their absolute floor.
DW_TOL = {torch.float32: dict(y=(1e-4, 1e-4), sums=(1e-4, 1e-2)),
          torch.bfloat16: dict(y=(1e-2, 1e-3), sums=(1e-4, 1e-2))}
UP_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}

# The depthwise sites of ENB0-HU and ENB4-HU at 228x304 (input hw, C, k,
# stride, padding), each once; then ragged ones: C not a multiple of 8,
# stride 2, 1x1 and 3x5 planes.
_S1K3, _S1K5 = ((1, 1), (1, 1)), ((2, 2), (2, 2))
_S2K3, _S2K5 = ((0, 1), (0, 1)), ((1, 2), (1, 2))
DW_SITES = [
    ((114, 152), 32, 3, 1, _S1K3), ((114, 152), 96, 3, 2, _S2K3),
    ((57, 76), 144, 3, 1, _S1K3), ((57, 76), 144, 5, 2, _S2K5),
    ((28, 38), 240, 5, 1, _S1K5), ((28, 38), 240, 3, 2, _S2K3),
    ((14, 19), 480, 3, 1, _S1K3), ((14, 19), 480, 5, 1, _S1K5),
    ((14, 19), 672, 5, 1, _S1K5), ((14, 19), 672, 5, 2, _S2K5),
    ((7, 9), 1152, 5, 1, _S1K5), ((7, 9), 1152, 3, 1, _S1K3),
    ((114, 152), 48, 3, 1, _S1K3), ((114, 152), 24, 3, 1, _S1K3),
    ((114, 152), 144, 3, 2, _S2K3), ((57, 76), 192, 3, 1, _S1K3),
    ((57, 76), 192, 5, 2, _S2K5), ((28, 38), 336, 5, 1, _S1K5),
    ((28, 38), 336, 3, 2, _S2K3), ((14, 19), 672, 3, 1, _S1K3),
    ((14, 19), 960, 5, 1, _S1K5), ((14, 19), 960, 5, 2, _S2K5),
    ((7, 9), 1632, 5, 1, _S1K5), ((7, 9), 1632, 3, 1, _S1K3),
    ((7, 9), 2688, 3, 1, _S1K3),
    ((3, 5), 12, 3, 1, _S1K3), ((3, 5), 76, 5, 2, _S2K5),
    ((1, 1), 12, 5, 1, _S1K5), ((1, 1), 76, 3, 2, _S1K3),
    ((9, 11), 12, 3, 2, _S2K3), ((3, 5), 76, 3, 1, _S1K3),
]
# The upsample-conv sites (input hw, output hw, C, O): ENB0-HU's
# D.up2-4, MFF.up1 and MFF.up2 (the kernel's in bf16; in f32 D.up4 and
# MFF.up1), ENB4-HU's and RN50-HU's D.up4 (K is 800 KiB, so it streams
# through the ring), then the einsum route's sites of ENB0-HU (D.up1,
# MFF.up3-4), ENB4-HU (D.up1, MFF.up2-4) and RN50-HU/SN154-HU (all but
# D.up4), all of DN161-HU's (should_fuse's rule, ops/fused.py), then
# ragged ones: C = 13, O = 7 and 36, odd sizes, a size that is not 2x, a
# 1x1 input.
UP_SITES = [
    ((14, 19), (28, 38), 80, 80), ((28, 38), (57, 76), 40, 40),
    ((57, 76), (114, 152), 20, 20), ((57, 76), (114, 152), 24, 32),
    ((28, 38), (114, 152), 40, 32),
    ((14, 19), (28, 38), 112, 112), ((28, 38), (57, 76), 56, 56),
    ((57, 76), (114, 152), 28, 28), ((57, 76), (114, 152), 32, 32),
    ((28, 38), (114, 152), 56, 32), ((57, 76), (114, 152), 128, 128),
    ((7, 9), (14, 19), 160, 160),
    ((14, 19), (114, 152), 80, 32), ((7, 9), (114, 152), 320, 32),
    ((7, 9), (14, 19), 224, 224), ((14, 19), (114, 152), 160, 32),
    ((7, 9), (114, 152), 448, 32),
    ((8, 10), (15, 19), 1024, 1024), ((15, 19), (29, 38), 512, 512),
    ((29, 38), (57, 76), 256, 256), ((57, 76), (114, 152), 256, 32),
    ((29, 38), (114, 152), 512, 32), ((15, 19), (114, 152), 1024, 32),
    ((8, 10), (114, 152), 2048, 32),
    ((7, 9), (14, 19), 1104, 1104), ((14, 19), (28, 38), 552, 552),
    ((28, 38), (57, 76), 276, 276), ((57, 76), (114, 152), 138, 138),
    ((57, 76), (114, 152), 192, 32), ((28, 38), (114, 152), 384, 32),
    ((14, 19), (114, 152), 1056, 32), ((7, 9), (114, 152), 2208, 32),
    ((9, 11), (18, 22), 13, 7), ((9, 11), (17, 23), 13, 36),
    ((5, 7), (13, 9), 13, 7), ((1, 1), (2, 3), 13, 36),
    ((1, 1), (1, 1), 8, 8), ((6, 5), (6, 5), 16, 136),
]


def _site_dw_args(dtype, hw, c, k, b=2, seed=0, offset=0):
    """Depthwise inputs on the card; ``offset`` elements shift x off its
    allocation's 16-byte alignment."""
    g = torch.Generator().manual_seed(seed)
    n = b * hw[0] * hw[1] * c
    x = torch.randn(n + offset, generator=g)[offset:].view(b, *hw, c)
    taps = torch.randn(k, k, c, generator=g) / k
    scale = torch.rand(c, generator=g) + 0.5
    bias = torch.randn(c, generator=g)
    x = torch.empty(n + offset, dtype=dtype, device="cuda")[offset:].view(
        b, *hw, c).copy_(x)
    return [x, taps.to(dtype).cuda(), scale.cuda(), bias.cuda()]


def _site_up_args(dtype, in_hw, c, o, b=2, seed=0, offset=0):
    g = torch.Generator().manual_seed(seed)
    n = b * in_hw[0] * in_hw[1] * c
    x = torch.randn(n, generator=g).view(b, *in_hw, c)
    k = torch.randn(5, 5, c, o, generator=g) / (5 * c ** 0.5)
    x = torch.empty(n + offset, dtype=dtype, device="cuda")[offset:].view(
        b, *in_hw, c).copy_(x)
    return x, k.to(dtype).cuda()


def _check_dw(args, dtype, stride, pad):
    tol = DW_TOL[dtype]
    y, sums = depthwise_bn_swish(*args, stride=stride, padding=pad)
    y_ref, sums_ref = depthwise_bn_swish_plain(*args, stride, pad)
    assert y.dtype == dtype and y.shape == y_ref.shape
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol["y"][0],
                               atol=tol["y"][1])
    torch.testing.assert_close(sums, sums_ref, rtol=tol["sums"][0],
                               atol=tol["sums"][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,c,k,stride,pad", DW_SITES)
def test_depthwise_matches_plain_at_sites(dtype, hw, c, k, stride, pad):
    _need_card()
    _check_dw(_site_dw_args(dtype, hw, c, k), dtype, stride, pad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_hw,out_hw,c,o", UP_SITES)
def test_upsample_conv_matches_plain_at_sites(dtype, in_hw, out_hw, c, o):
    _need_card()
    x, k = _site_up_args(dtype, in_hw, c, o)
    y = upsample_conv(x, k, out_hw)
    assert y.dtype == dtype and y.shape == (2, *out_hw, o)
    rtol, atol = UP_TOL[dtype]
    torch.testing.assert_close(y.float(),
                               upsample_conv_plain(x, k, out_hw).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_take_unaligned_tensors(dtype):
    """x one element off 16-byte alignment: the scalar loads, same values."""
    _need_card()
    for hw, c, k, stride, pad in (((14, 19), 480, 5, 1, _S1K5),
                                  ((9, 11), 12, 3, 2, _S2K3)):
        _check_dw(_site_dw_args(dtype, hw, c, k, offset=1), dtype, stride,
                  pad)
    x, k = _site_up_args(dtype, (14, 19), 80, 80, offset=1)
    k = torch.empty(k.numel() + 2, dtype=dtype, device="cuda")[2:].view(
        k.shape).copy_(k)
    rtol, atol = UP_TOL[dtype]
    torch.testing.assert_close(upsample_conv(x, k, (28, 38)).float(),
                               upsample_conv_plain(x, k, (28, 38)).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_sums_are_deterministic(dtype):
    """The last block adds the partials in tile order: the same bits from
    launch to launch (and the counters are left at 0 for the next)."""
    _need_card()
    for hw, c, k, stride, pad in DW_SITES[:12]:
        args = _site_dw_args(dtype, hw, c, k, b=4, seed=3)
        y1, s1 = depthwise_bn_swish(*args, stride=stride, padding=pad)
        y2, s2 = depthwise_bn_swish(*args, stride=stride, padding=pad)
        assert torch.equal(s1, s2) and torch.equal(y1, y2)


def test_depthwise_sums_hold_across_streams_and_graphs():
    """Launches on two streams at once, and a launch captured in a CUDA
    graph, keep their own reduction counters: their sums are the bits of a
    launch alone, also after an eager batch larger than the counters."""
    _need_card()
    calls = [(_site_dw_args(torch.bfloat16, (14, 19), 480, 3, b=4, seed=5),
              dict(stride=1, padding=_S1K3)),
             (_site_dw_args(torch.bfloat16, (7, 9), 1152, 5, b=4, seed=6),
              dict(stride=1, padding=_S1K5))]
    refs = [depthwise_bn_swish(*args, **kw)[1] for args, kw in calls]
    main = torch.cuda.current_stream()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    sums = [[], []]
    for s in streams:
        s.wait_stream(main)
    for _ in range(20):
        for i, (s, (args, kw)) in enumerate(zip(streams, calls)):
            with torch.cuda.stream(s):
                sums[i].append(depthwise_bn_swish(*args, **kw)[1])
    torch.cuda.synchronize()
    for ref, got in zip(refs, sums):
        assert all(torch.equal(ref, g) for g in got)

    (args, kw), ref = calls[0], refs[0]
    streams[0].wait_stream(main)
    with torch.cuda.stream(streams[0]):
        depthwise_bn_swish(*args, **kw)
    main.wait_stream(streams[0])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _, graph_sums = depthwise_bn_swish(*args, **kw)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(graph_sums, ref)
    wide = _site_dw_args(torch.bfloat16, (1, 1), 12, 5, b=2000, seed=7)
    _check_dw(wide, torch.bfloat16, 1, _S1K5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(graph_sums, ref)
    assert torch.equal(depthwise_bn_swish(*args, **kw)[1], ref)


def _dw_out_hw(hw, k, stride, pad):
    (pt, pb), (pl, pr) = pad
    return ((hw[0] + pt + pb - k) // stride + 1,
            (hw[1] + pl + pr - k) // stride + 1)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("hw,c,k,stride,pad", DW_SITES)
def test_depthwise_launch_config_covers_and_fits(hw, c, k, stride, pad,
                                                 itemsize):
    """The kernel's launch shape, from its source: 16-byte vectors where C
    allows, whole runs, a tile within the output, and 16-byte lanes of a
    multiple of 8 unpadded (no bank conflict to avoid)."""
    _need_card()
    oh, ow = _dw_out_hw(hw, k, stride, pad)
    run = 2 if (k, stride) == (5, 2) else 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b in (2, 128):
        vec, cv, lanes, ps, tr, tc, tpb = depthwise.launch_config(
            b, oh, ow, c, k, stride, itemsize, True, sms)
        assert vec == (16 // itemsize if c % (16 // itemsize) == 0 else 1)
        assert cv * lanes <= 256 and ps >= cv * vec
        assert tc % run == 0 and lanes <= tr * tc // run
        assert tr <= oh and tc < ow + run
        assert 1 <= tpb <= -(-oh // tr) * -(-ow // tc)
        if vec > 1 and cv % 8 == 0:
            assert ps == cv * vec
    # an unaligned x takes the scalar kernel
    assert depthwise.launch_config(2, oh, ow, c, k, stride, itemsize, False,
                                   sms)[0] == 1


@pytest.mark.parametrize("in_hw,out_hw,c,o", UP_SITES)
def test_upsample_conv_tile_covers_and_fits(in_hw, out_hw, c, o):
    """The bf16 kernel's tile, from its source, lies within the output and
    within a block's 256 GEMM rows."""
    _need_card()
    h, w = out_hw
    th, tw = upproj.mma_tile(h, w, c, o)
    assert 1 <= th <= h and 1 <= tw <= w and th * tw <= 256


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
    out = make_serving_fn(model, dtype=torch.bfloat16, preprocess=True)(
        frames)[..., 0].cpu()
    assert (depthwise_bn_swish.launches - dw,
            upsample_conv.launches - up) == (16, 5)
    err = np.abs(out.numpy() - fixture["depth"])
    assert err.max() <= 0.5 and err.mean() <= 0.05


def test_lr_serving_on_card_matches_fixture():
    """ENB0-LR, a MidasNet: its EfficientNet encoder runs the depthwise
    kernel (16 launches a forward), its decoder no upsample-conv."""
    _need_card()
    fixture = np.load(LR_FIXTURE_PATH)
    model = load_any_checkpoint(LR_CHECKPOINT)
    frames = torch.from_numpy(fixture_frames()).cuda()
    dw, up = depthwise_bn_swish.launches, upsample_conv.launches
    out32 = make_infer_fn(model, preprocess=True)(frames)[..., 0].cpu()
    assert (depthwise_bn_swish.launches - dw,
            upsample_conv.launches - up) == (16, 0)
    np.testing.assert_allclose(out32.numpy(), fixture["depth"], rtol=1e-3,
                               atol=1e-3)
    out = make_serving_fn(model, dtype=torch.bfloat16, preprocess=True)(
        frames)[..., 0].cpu()
    err = np.abs(out.numpy() - fixture["depth"])
    assert err.max() <= 0.1 and err.mean() <= 0.01  # as chip_smoke.py


# The configurations this port serves beside ENB0-HU: ENB0-LR with its
# trained weights, the others with chip_smoke.py's random ones. The f32
# forward on the card (its kernels, cuDNN, TF32 off) against the same
# model on the CPU (the plain versions), at batch 2. Sums in other orders
# through 50-100 layers: rtol 1e-3 and atol 1e-4 of the largest |output|
# (random weights set its scale).
@pytest.mark.parametrize("encoder,decoder,seed", [
    ("efficientnet-b0", "lasinger2019", None),
    ("efficientnet-b4", "hu2018", 4), ("efficientnet-b4", "lasinger2019", 5),
    ("resnet50", "hu2018", 6), ("resnet50", "lasinger2019", 7),
    ("densenet161", "hu2018", 8), ("senet154", "hu2018", 9)])
def test_config_on_card_matches_cpu(encoder, decoder, seed):
    _need_card()
    if seed is None:
        model = load_any_checkpoint(LR_CHECKPOINT, device="cpu")
    else:
        model = randomize_(build_model(encoder, decoder), seed)
    x = torch.randn(2, 228, 304, 3, generator=torch.Generator().manual_seed(
        seed or 0))
    with torch.inference_mode():
        ref = model(x)
        out = model.cuda()(x.cuda()).cpu()
    assert out.shape == ref.shape == (2, 114, 152, 1)
    scale = ref.abs().max().item()
    torch.testing.assert_close(out, ref, rtol=1e-3, atol=1e-4 * scale)


# One ENB0-HU site of each route in each dtype, as should_fuse's rule
# gives them (ops/fused.py): (in hw, out hw, C, features a branch, dtype,
# einsum route).
ROUTE_SITES = [((28, 38), (114, 152), 40, 16, torch.bfloat16, False),
               ((7, 9), (14, 19), 160, 80, torch.bfloat16, True),
               ((57, 76), (114, 152), 20, 10, torch.float32, False),
               ((7, 9), (14, 19), 160, 80, torch.float32, True)]


@pytest.mark.parametrize("in_hw,out_hw,c,f,dtype,einsum", ROUTE_SITES)
def test_upprojection_route_on_card(in_hw, out_hw, c, f, dtype, einsum):
    """An UpProjection at a site of each route: should_fuse's route taken
    (one kernel launch, or none), and the output at batch 2 against the
    same module in f32 on the CPU: f32 to rtol 1e-4 and 1e-4 of the
    largest |output| (sums in another order), bf16 to 2e-2 of it (its
    input, branches and 3×3 conv each rounded to bf16)."""
    from efficientdepthestimation_tpu_torch.models.hu2018 import UpProjection
    from efficientdepthestimation_tpu_torch.ops.fused import should_fuse

    _need_card()
    assert should_fuse(in_hw, out_hw, c, f, dtype) == einsum
    up = randomize_(UpProjection(c, f), 10).eval()
    x = torch.randn(2, *in_hw, c, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref = up(x, out_hw)
        launches = upsample_conv.launches
        out = up.cuda().to(dtype)(x.cuda().to(dtype), out_hw).float().cpu()
    assert upsample_conv.launches - launches == (0 if einsum else 1)
    scale = ref.abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert (out - ref).abs().max().item() <= 2e-2 * scale


def _loss_args(dtype, shape=(5, 37, 70), seed=0, offset=0):
    """pred in ``dtype`` and f32 target on the card, in 1-9 on a grid of
    2^-8; where there are 3 images or more, image 0 flat in both and image
    1 with pred == target. ``offset`` elements shift pred off its
    allocation's 16-byte alignment.

    The grid keeps every Sobel sum exact in f32, in any order of addition,
    so both versions see the same zero differences: the gradient of |e|
    jumps from -2 to 2 at e = 0, and on continuous data a difference
    within rounding of 0 (a few pixels in 5 million) would take either
    side. The values keep up to 12 significant bits, which a kernel that
    staged f32 at bf16's 8 would lose (as chip_smoke.loss_grid)."""
    g = torch.Generator().manual_seed(seed)
    target = torch.round((torch.rand(shape, generator=g) * 8 + 1) * 256) / 256
    pred = torch.round((torch.rand(shape, generator=g) * 8 + 1) * 256) / 256
    if shape[0] >= 3:
        pred[0] = target[0] = 3.0
        pred[1] = target[1]
    pred = pred.to(dtype).cuda()
    if offset:
        pred = torch.empty(pred.numel() + offset, dtype=dtype,
                           device="cuda")[offset:].view(shape).copy_(pred)
    return pred, target.cuda()


# Kernel vs plain version: per-image sums of up to 17,328 O(1) terms in
# another order (rtol 1e-5, atol 1e-2); dp f32 to 1e-4 relative and 1e-5 of
# its largest value, bf16 within one bf16 step (2^-8 relative).
LOSS_DP_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _check_loss(pred, target):
    """Both kernels against their plain versions, at num_valid N and at a
    smaller one; flat and masked images get an exactly zero gradient."""
    shape, dtype = tuple(pred.shape), pred.dtype
    dp_tol = LOSS_DP_TOL[dtype]
    sums = fused_depth_loss_fwd(pred, target)
    ref = fused_depth_loss_fwd_plain(pred, target)
    torch.testing.assert_close(sums, ref, rtol=1e-5, atol=1e-2)
    assert torch.equal(sums, fused_depth_loss_fwd(pred, target))  # no atomics
    # a smaller num_valid where it leaves a random image among the valid
    for num_valid in (shape[0], 3) if shape[0] > 3 else (shape[0],):
        mask = (torch.arange(shape[0], device="cuda") < num_valid).float()
        coef = torch.full((1,), 0.7 / (num_valid * shape[1] * shape[2]),
                          device="cuda")
        dp = fused_depth_loss_bwd(pred, target, mask, coef)
        dp_ref = fused_depth_loss_bwd_plain(pred, target, mask, coef)
        assert dp.dtype == dtype
        scale = dp_ref.float().abs().max().item()
        torch.testing.assert_close(dp.float(), dp_ref.float(), rtol=dp_tol,
                                   atol=max(dp_tol, 1e-5) * scale)
        if shape[0] >= 3:
            assert not dp[0].any()  # flat: exactly zero, sign(0) = 0
        assert not dp[num_valid:].any()
        torch.testing.assert_close(masked_total(sums, mask, shape[1] *
                                                shape[2]),
                                   masked_total(ref, mask, shape[1] *
                                                shape[2]), rtol=1e-5,
                                   atol=1e-6)


# The training shape and a ragged one; then shapes that stress the
# bands and clusters: one image, images of 5 rows, W = 70 (not a multiple
# of 8: the scalar path) with 229 rows, and 300 images.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 37, 70), (64, 114, 152),
                                   (1, 114, 152), (3, 5, 7), (2, 229, 70),
                                   (300, 114, 152)])
def test_loss_kernels_match_plain_on_card(dtype, shape):
    _need_card()
    _check_loss(*_loss_args(dtype, shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_kernels_take_unaligned_pred(dtype):
    """pred one element off 16-byte alignment (a slice): the scalar path,
    the same values."""
    _need_card()
    pred, target = _loss_args(dtype, (6, 114, 152), offset=1)
    assert pred.data_ptr() % 16 != 0
    assert not fused_loss.vector_path(pred, target)
    assert fused_loss.vector_path(*_loss_args(dtype, (6, 114, 152)))
    _check_loss(pred, target)


def test_loss_sums_hold_across_streams_and_graphs():
    """No scratch and no counters: launches on two streams at once, and a
    launch captured in a CUDA graph, give the bits of a launch alone."""
    _need_card()
    calls = [_loss_args(torch.bfloat16, (64, 114, 152), seed=5),
             _loss_args(torch.float32, (7, 229, 70), seed=6)]
    refs = [fused_depth_loss_fwd(*args) for args in calls]
    main = torch.cuda.current_stream()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    sums = [[], []]
    for s in streams:
        s.wait_stream(main)
    for _ in range(20):
        for i, (s, args) in enumerate(zip(streams, calls)):
            with torch.cuda.stream(s):
                sums[i].append(fused_depth_loss_fwd(*args))
    torch.cuda.synchronize()
    for ref, got in zip(refs, sums):
        assert all(torch.equal(ref, g) for g in got)

    args, ref = calls[0], refs[0]
    streams[0].wait_stream(main)
    with torch.cuda.stream(streams[0]):
        fused_depth_loss_fwd(*args)
    main.wait_stream(streams[0])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graph_sums = fused_depth_loss_fwd(*args)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(graph_sums, ref)
    assert torch.equal(fused_depth_loss_fwd(*args), ref)


def _device_records(fn) -> int:
    """Device records (kernels, memsets, copies) in a profile of ``fn()``;
    a trace that holds none is traced again (CUPTI now and then drops
    one), up to 5 times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.device_type == torch.autograd.DeviceType.CUDA
                for e in prof.events())
        if n:
            return n
    return 0


def test_loss_calls_are_one_device_operation():
    """Each wrapper call is its kernel alone: no fill, no memset, and the
    forward allocates nothing but its (N, 4) sums."""
    _need_card()
    pred, target = _loss_args(torch.bfloat16, (64, 114, 152))
    mask = torch.ones(64, device="cuda")
    coef = torch.full((1,), 1e-6, device="cuda")
    assert _device_records(lambda: fused_depth_loss_fwd(pred, target)) == 1
    assert _device_records(
        lambda: fused_depth_loss_bwd(pred, target, mask, coef)) == 1
    key = "allocation.all.allocated"
    before = torch.cuda.memory_stats()[key]
    sums = fused_depth_loss_fwd(pred, target)
    assert torch.cuda.memory_stats()[key] - before == 1
    assert sums.shape == (64, 4)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", [(64, 114, 152), (1, 114, 152), (3, 5, 7),
                                   (2, 229, 70), (300, 114, 152)])
def test_loss_launch_config_covers_and_fits(backward, shape):
    """The pair's launch shape, from its source: whole clusters of at most 8
    blocks whose bands cover the image, a strip of threads per 4 columns
    within 512 threads; at the training shape, clusters of more than one
    block."""
    _need_card()
    n, h, w = shape
    for dtype in (torch.float32, torch.bfloat16):
        for vec in (w % 8 == 0, False):
            cluster, band, strips, rows, threads, smem = \
                fused_loss.launch_config(backward, dtype, vec, n, h, w, 0)
            assert 1 <= cluster <= 8 and band * cluster >= h
            assert band * (cluster - 1) < h  # no block without rows
            assert 1 <= strips <= band and rows >= 1
            assert -(-w // 4) * strips <= threads <= 512
            assert threads % 32 == 0 and 0 < smem <= 200 * 1024
            if shape == (64, 114, 152):
                assert cluster > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_kernels_refuse_rows_wider_than_2048(dtype):
    """A thread owns a 4-pixel quad of a row, so the pair takes rows of up
    to 2048 pixels: the widest agrees with the plain versions, and a wider
    call (scalar and 16-byte path) raises before any launch."""
    _need_card()
    _check_loss(*_loss_args(dtype, (2, 5, 2048)))
    mask = torch.ones(2, device="cuda")
    coef = torch.full((1,), 1e-6, device="cuda")
    launches = (fused_depth_loss_fwd.launches, fused_depth_loss_bwd.launches)
    for w in (2049, 4096):
        pred, target = _loss_args(dtype, (2, 5, w))
        with pytest.raises(ValueError, match="at most 2048"):
            fused_depth_loss_fwd(pred, target)
        with pytest.raises(ValueError, match="at most 2048"):
            fused_depth_loss_bwd(pred, target, mask, coef)
    assert (fused_depth_loss_fwd.launches,
            fused_depth_loss_bwd.launches) == launches


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
    """One bf16 ENB0-HU step at batch 4: 1 + 1 loss launches, 5
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
    assert [c.launches - s for c, s in zip(counters, start)] == [1, 1, 5, 0]
    assert np.isfinite(metrics["loss"].item())
    assert metrics["batch_size"].item() == 3.0
    assert model.R.conv2.weight.dtype == torch.float32
    assert not torch.equal(model.R.conv2.weight, before)


# ---------------------------------------------------------- evaluation

# ENB0-HU's 12 distinct depthwise shapes and 5 upsample-conv sites of the
# kernel's route (the first entries of DW_SITES and UP_SITES), at the
# evaluation's batches: 1, the reference's, and 8, also
# ``inference_benchmark``'s (the depthwise launch shape depends on B).
ENB0_HU_DW_SITES, ENB0_HU_UP_SITES = DW_SITES[:12], UP_SITES[:5]
EVAL_BATCHES = (1, 8)


@pytest.mark.parametrize("batch", EVAL_BATCHES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,c,k,stride,pad", ENB0_HU_DW_SITES)
def test_depthwise_matches_plain_at_eval_batch_sites(dtype, hw, c, k, stride,
                                                     pad, batch):
    _need_card()
    _check_dw(_site_dw_args(dtype, hw, c, k, b=batch, seed=8), dtype, stride,
              pad)


@pytest.mark.parametrize("batch", EVAL_BATCHES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_hw,out_hw,c,o", ENB0_HU_UP_SITES)
def test_upsample_conv_matches_plain_at_eval_batch_sites(dtype, in_hw, out_hw,
                                                         c, o, batch):
    _need_card()
    x, k = _site_up_args(dtype, in_hw, c, o, b=batch, seed=8)
    y = upsample_conv(x, k, out_hw)
    assert y.dtype == dtype and y.shape == (batch, *out_hw, o)
    rtol, atol = UP_TOL[dtype]
    torch.testing.assert_close(y.float(),
                               upsample_conv_plain(x, k, out_hw).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_sums_are_deterministic_at_batch1(dtype):
    """At B = 1 the launch shape splits a plane into channel tiles and row
    bands: the sums still come out bit for bit from launch to launch."""
    _need_card()
    for hw, c, k, stride, pad in ENB0_HU_DW_SITES:
        args = _site_dw_args(dtype, hw, c, k, b=1, seed=9)
        first = depthwise_bn_swish(*args, stride=stride, padding=pad)
        for _ in range(3):
            y, s = depthwise_bn_swish(*args, stride=stride, padding=pad)
            assert torch.equal(s, first[1]) and torch.equal(y, first[0])


def test_eval_step_on_card_matches_cpu():
    """``make_eval_step`` for ENB0-HU in f32 on a batch of 4 test pairs
    whose last repeats the third (num_valid 3), on the card (its kernels,
    cuDNN, TF32 off) against the same step on the CPU (the plain
    versions): depth sums to 1e-4 relative, δ sums (scaled by the batch)
    to 3 × 2e-3, as chip_smoke.py's EVAL_* tolerances; the output to
    1e-3 m."""
    from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
        TEST_SEED_OFFSET,
        eval_pair,
    )
    from efficientdepthestimation_tpu_torch.data.transforms import (
        eval_preprocess,
    )
    from efficientdepthestimation_tpu_torch.training.train_step import (
        make_eval_step,
    )

    _need_card()
    pairs = [eval_pair(TEST_SEED_OFFSET + i) for i in (0, 1, 2, 2)]
    rgb = torch.from_numpy(np.stack([p[0] for p in pairs]))
    depth = torch.from_numpy(np.stack([p[1] for p in pairs]))
    model = load_any_checkpoint(CHECKPOINT, device="cpu")
    ref, ref_out = make_eval_step(device="cpu")(
        model, *eval_preprocess(rgb, depth), 3)
    dw, up = depthwise_bn_swish.launches, upsample_conv.launches
    sums, out = make_eval_step()(model.cuda(),
                                 *eval_preprocess(rgb.cuda(), depth.cuda()),
                                 3)
    assert (depthwise_bn_swish.launches - dw,
            upsample_conv.launches - up) == (16, 2)
    assert out.is_cuda and sums["batch_size"] == ref["batch_size"] == 3.0
    for key, value in ref.items():
        if key.startswith("delta"):
            assert abs(sums[key] - value) <= 3 * 2e-3, key
        else:
            np.testing.assert_allclose(sums[key], value, rtol=1e-4,
                                       err_msg=key)
    np.testing.assert_allclose(out.cpu().numpy(), ref_out.numpy(), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("checkpoint,launches", [(CHECKPOINT, (16, 5)),
                                                 (LR_CHECKPOINT, (16, 0))])
def test_pth_serves_as_its_ede_twin(checkpoint, launches, tmp_path):
    """ENB0-HU and ENB0-LR written as reference ``.pth`` files (a raw
    ``state_dict`` under ``module.``; the self-describing MidasNet dict,
    whose schema the ``.ede`` header shares) load onto the card with the
    default device and serve 4 frames in bf16 bit for bit as the
    ``.ede``-loaded model does, with the same launches."""
    from efficientdepthestimation_tpu_torch.checkpoints.pth_import import (
        reference_state_dict,
    )
    from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
        load_checkpoint,
    )

    _need_card()
    source, header = load_checkpoint(checkpoint)
    weights = reference_state_dict(source)
    if header["format"] == "midas-self-describing":
        state = {k: v for k, v in header.items() if k != "format"}
        state["weights"], name = weights, "ENB0-LR.pth"
    else:
        state = {f"module.{k}": v for k, v in weights.items()}
        name = "ENB0-HU.pth"
    torch.save(state, tmp_path / name)
    frames = torch.from_numpy(fixture_frames()).cuda()
    outs = []
    for path in (checkpoint, str(tmp_path / name)):
        serve = make_serving_fn(load_any_checkpoint(path),
                                upsample_to=(480, 640), dtype=torch.bfloat16,
                                preprocess=True)
        dw, up = depthwise_bn_swish.launches, upsample_conv.launches
        outs.append(serve(frames))
        assert (depthwise_bn_swish.launches - dw,
                upsample_conv.launches - up) == launches
    assert outs[0].is_cuda and torch.equal(outs[0], outs[1])


def test_unproject_depth_on_card_matches_cpu():
    """f32 points on the card against the CPU, 1e-6 relative (a quotient
    by a scalar may be a product with its reciprocal there, 1 ulp), with
    zero depths dropped in both; the colours moved unchanged."""
    from efficientdepthestimation_tpu_torch.utils.pointcloud import (
        NYU_V2_INTRINSICS_HALF,
        unproject_depth,
    )

    _need_card()
    gen = torch.Generator().manual_seed(0)
    depth = torch.rand(228, 304, generator=gen) * 9 + 0.5
    depth[::7, ::5] = 0
    colors = torch.rand(228, 304, 3, generator=gen, dtype=torch.float64)
    k = {n: NYU_V2_INTRINSICS_HALF[n] for n in ("fx", "fy", "cx", "cy")}
    for mirror_z in (False, True):
        ref = unproject_depth(depth, colors, mirror_z=mirror_z, **k)
        out = unproject_depth(depth.cuda(), colors.cuda(), mirror_z=mirror_z,
                              **k)
        assert out[0].is_cuda and out[0].shape == ref[0].shape
        assert ref[0].shape[0] == 228 * 304 - 33 * 61
        torch.testing.assert_close(out[0].cpu(), ref[0], rtol=1e-6, atol=0)
        assert torch.equal(out[1].cpu(), ref[1])


# ---------------------------------------------------------- training CLI

def _raw_train_batch(n: int, num_valid=None) -> dict:
    pairs = synthetic_train_set(range(n))
    return {"image": torch.from_numpy(np.stack([p[0] for p in pairs])),
            "depth": torch.from_numpy(np.stack([p[1] for p in pairs])),
            "num_valid": n if num_valid is None else num_valid}


def test_train_state_round_trip_on_card(tmp_path):
    """A bf16 ENB0-HU step with E frozen, saved and loaded into a fresh
    state on the card: every weight, statistic and Adam moment equal and
    on the card, the step and the LR schedule's count restored."""
    from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
        load_train_state,
        save_train_state,
    )
    from efficientdepthestimation_tpu_torch.training.train_step import (
        step_lr,
    )

    _need_card()

    def fresh():
        return create_train_state(load_any_checkpoint(CHECKPOINT),
                                  step_lr(1e-4, 1, step_size=1), 1e-4,
                                  frozen_prefixes=("E",))

    state = fresh()
    make_train_step(mixed_precision=True)(state, _raw_train_batch(2), 0)
    path = str(tmp_path / "train_state.ede")
    save_train_state(path, state, encoder="efficientnet-b0",
                     decoder="hu2018", epoch=0, step_in_epoch=1)
    loaded, header = load_train_state(path, fresh())
    assert loaded.step == state.step == header["step"] == 1
    for key, value in state.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[key], value), key
    params = dict(state.model.named_parameters())
    for name, p in loaded.model.named_parameters():
        if not p.requires_grad:
            assert name.startswith("E.")
            continue
        ours, ref = loaded.optimizer.state[p], state.optimizer.state[
            params[name]]
        assert ours["exp_avg"].is_cuda and float(ours["step"]) == 1.0
        assert torch.equal(ours["exp_avg"], ref["exp_avg"]), name
        assert torch.equal(ours["exp_avg_sq"], ref["exp_avg_sq"]), name
    assert loaded.optimizer.param_groups[0]["lr"] == pytest.approx(1e-5)


def test_device_prefetch_copies_before_use():
    """Batches of 64 MB from a slow producer, each read on the consumer's
    stream as soon as it is handed out: every value arrives."""
    import time

    from efficientdepthestimation_tpu_torch.data.prefetch import (
        device_prefetch,
    )

    _need_card()
    rng = np.random.default_rng(0)
    batches = [{"image": rng.integers(0, 255, (64, 1024, 1024),
                                      dtype=np.uint8),
                "num_valid": i} for i in range(6)]

    def slow():
        for batch in batches:
            time.sleep(0.005)
            yield batch

    seen = []
    for batch in device_prefetch(slow(), size=2):
        assert batch["image"].is_cuda
        torch.cuda._sleep(1_000_000)  # a busy consumer stream
        seen.append((batch["num_valid"],
                     int(batch["image"].sum(dtype=torch.int64))))
    assert seen == [(b["num_valid"], int(b["image"].sum(dtype=np.int64)))
                    for b in batches]


# Launches of one bf16 ENB0-HU step at batch 2 (upsample-conv, loss
# forward, loss backward, depthwise), as the CPU counts the plain versions'
# calls (tests/test_torch_train_accum_remat.py): the recompute runs the
# upsample-conv kernel again, each microbatch the forward and the loss.
TRAIN_LAUNCHES = {"none": (5, 1, 1, 0), "full": (10, 1, 1, 0),
                  "dots": (10, 1, 1, 0), "accum2": (10, 2, 2, 0)}


@pytest.mark.parametrize("policy", sorted(TRAIN_LAUNCHES))
def test_train_step_launches_on_card(policy):
    _need_card()
    kw = ({"accum_steps": 2} if policy == "accum2" else
          {"remat": None if policy == "none" else policy})
    state = create_train_state(load_any_checkpoint(CHECKPOINT), 1e-4)
    step = make_train_step(mixed_precision=True, **kw)
    counters = (upsample_conv, fused_depth_loss_fwd, fused_depth_loss_bwd,
                depthwise_bn_swish)
    start = [c.launches for c in counters]
    state, metrics = step(state, _raw_train_batch(2), 0)
    torch.cuda.synchronize()
    assert tuple(c.launches - s for c, s in zip(counters, start)) == \
        TRAIN_LAUNCHES[policy]
    assert np.isfinite(metrics["loss"].item())


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_matches_no_remat_on_card(remat):
    """f32 ENB0-HU at batch 2 with drop-connect on, cuDNN deterministic:
    the recompute draws the same masks and leaves the BN statistics as the
    forward moved them; gradients to 1e-5 of each leaf's largest value."""
    _need_card()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = []
        for policy in (None, remat):
            model = load_any_checkpoint(CHECKPOINT)
            model.E.drop_connect_rate = 0.2
            state = create_train_state(model, 1e-4)
            state, metrics = make_train_step(remat=policy)(
                state, _raw_train_batch(2), 5)
            out.append((metrics["loss"].item(),
                        {n: p.grad for n, p in model.named_parameters()},
                        model.state_dict()))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (loss_a, grads_a, stats_a), (loss_b, grads_b, stats_b) = out
    assert loss_a == loss_b
    for name, g in grads_a.items():
        torch.testing.assert_close(grads_b[name], g, rtol=0,
                                   atol=1e-5 * float(g.abs().max()),
                                   msg=name)
    for name, value in stats_a.items():
        if "running" in name:
            assert torch.equal(stats_b[name], value), name


# ------------------------------------------------------------ benchmark

# The benchmark's depth maps: nyu_eval_sample(32) frames (224x320) in f32 at
# batch 4, and the remainder 654 NYU test pairs leave at 4.
BENCH_HW, BENCH_BATCHES = (224, 320), (4, 2)


def _bench_sites(model):
    """The inputs of each depthwise and upsample-conv kernel call of an f32
    forward of BENCH_HW frames, recorded at batch 1 on the CPU: (kind,
    shape arguments, parameters taken from the model)."""
    from efficientdepthestimation_tpu_torch.models.efficientnet import (
        MBConvBlock,
    )
    from efficientdepthestimation_tpu_torch.models.hu2018 import UpProjection
    from efficientdepthestimation_tpu_torch.ops.fused import should_fuse

    sites = []

    def on_block(block, args):
        taps = block._depthwise_conv.weight[:, 0].permute(1, 2, 0)
        scale, bias = block._bn1.folded()
        sites.append(("dw", (*args[0].shape[1:3], args[0].shape[-1]
                             * block.expand), (taps, scale, bias),
                      dict(stride=block.stride, padding=block.pad)))

    def on_up(module, args):
        x, size = args
        if not should_fuse(tuple(x.shape[1:3]), tuple(size), x.shape[-1],
                           module.features, torch.float32):
            k = torch.cat([module.conv1.weight, module.conv2.weight],
                          0).permute(2, 3, 1, 0)
            sites.append(("up", tuple(x.shape[1:]), k, tuple(size)))

    hooks = [m.register_forward_pre_hook(on_block) for m in model.modules()
             if isinstance(m, MBConvBlock)]
    hooks += [m.register_forward_pre_hook(on_up) for m in model.modules()
              if isinstance(m, UpProjection)]
    with torch.inference_mode():
        model(torch.zeros(1, *BENCH_HW, 3))
    for h in hooks:
        h.remove()
    return sites


@pytest.mark.parametrize("batch", BENCH_BATCHES)
@pytest.mark.parametrize("checkpoint,counts", [(CHECKPOINT, (16, 2)),
                                               (LR_CHECKPOINT, (16, 0))])
def test_kernels_match_plain_at_benchmark_sites(checkpoint, counts, batch):
    """Each kernel against its plain version at every site ENB0-HU's and
    ENB0-LR's f32 forwards of the benchmark's frames give it."""
    _need_card()
    model = load_any_checkpoint(checkpoint, device="cpu")
    sites = _bench_sites(model)
    assert (sum(s[0] == "dw" for s in sites),
            sum(s[0] == "up" for s in sites)) == counts
    g = torch.Generator().manual_seed(3)
    for site in sites:
        if site[0] == "dw":
            _, (h, w, c), params, kw = site
            x = torch.randn(batch, h, w, c, generator=g).cuda()
            args = [x] + [p.contiguous().cuda() for p in params]
            _check_dw(args, torch.float32, kw["stride"], kw["padding"])
        else:
            _, (h, w, c), k, size = site
            x = torch.randn(batch, h, w, c, generator=g).cuda()
            k = k.contiguous().cuda()
            torch.testing.assert_close(upsample_conv(x, k, size),
                                       upsample_conv_plain(x, k, size),
                                       rtol=UP_TOL[torch.float32][0],
                                       atol=UP_TOL[torch.float32][1])


def _bench_frames(n: int = 4) -> np.ndarray:
    from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
        render_scene,
    )

    return np.stack([render_scene(s, BENCH_HW)[0] for s in range(n)]).astype(
        np.float32) / 255.0


@pytest.mark.parametrize("kind", ["hu", "lr"])
def test_benchmark_depth_models_on_card_match_cpu(kind):
    """The benchmark's wrappers of ENB0-HU and ENB0-LR on the card against
    the same wrappers on the CPU, f32 at batch 4, TF32 off: within 1e-3 m,
    with one forward's launches exact."""
    _need_card()
    from efficientdepthestimation_tpu_torch.benchmark.depth_model import (
        MidasModel,
        ReSIDEModel,
    )

    def make(device):
        if kind == "hu":
            return ReSIDEModel(CHECKPOINT, encoder="efficientnet-b0",
                               device=device)
        return MidasModel(LR_CHECKPOINT, device=device)

    images = torch.from_numpy(_bench_frames())
    card = make(None)
    depthwise.depthwise_bn_swish.launches = 0
    upproj.upsample_conv.launches = 0
    got = card(images)
    torch.cuda.synchronize()
    assert (depthwise.depthwise_bn_swish.launches,
            upproj.upsample_conv.launches) == ((16, 2) if kind == "hu"
                                               else (16, 0))
    assert got.device.type == "cuda" and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), make("cpu")(images), rtol=0,
                               atol=1e-3)


# The card's renders against the CPU's: the share of pixels whose colour
# agrees within 1e-4 (tests/test_torch_renderer.py holds the port's CPU
# renders against JAX's by the same measure).
RENDER_SHARE = {"mesh": 0.999, "splat": 0.999, "raymarch": 0.99}


@pytest.mark.parametrize("engine", sorted(RENDER_SHARE))
def test_renderer_on_card_matches_cpu(engine):
    _need_card()
    from efficientdepthestimation_tpu_torch.benchmark import renderer
    from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
        render_scene,
    )

    rgb, depth = render_scene(3, (240, 320))
    image = torch.from_numpy(rgb.astype(np.float32) / 255.0)
    d = torch.from_numpy(depth.astype(np.float32))
    depth01 = (d - d.min()) / (d.max() - d.min())
    views = torch.from_numpy(renderer.sweep_views(60))[
        sorted(set(range(8)) | set(range(3, 303, 60)))]
    fn = renderer.RENDERERS[engine]
    got = fn(image.cuda(), depth01.cuda(), views)
    want = fn(image, depth01, views)
    assert got.device.type == "cuda" and got.shape == want.shape
    share = float(((got.cpu() - want).abs().amax(-1) <= 1e-4).float().mean())
    assert share >= RENDER_SHARE[engine], share


def test_rendered_sweep_and_visual_metrics_on_card(tmp_path):
    """``create_rendered_images`` on the card writes the CPU's files and
    stills within one grey level on all but 0.1% of the pixels; SSIM and
    PSNR of the stills on the card equal the CPU's within 1e-5."""
    _need_card()
    from PIL import Image

    from efficientdepthestimation_tpu_torch.benchmark import renderer
    from efficientdepthestimation_tpu_torch.benchmark.metrics import (
        psnr,
        ssim,
    )
    from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
        render_scene,
    )

    rgb, depth = render_scene(5, (240, 320))
    samples = [{"image": rgb.astype(np.float32) / 255.0,
                "depth": depth[..., None].astype(np.float32)}]
    for device in ("cuda", "cpu"):
        renderer.create_rendered_images(str(tmp_path / device), samples,
                                        fps=2, device=device)
    stills = {}
    for device in ("cuda", "cpu"):
        root = tmp_path / device / "image" / "000000"
        stills[device] = np.stack([np.asarray(Image.open(root / f))
                                   for f in sorted(os.listdir(root))])
    assert stills["cuda"].shape == stills["cpu"].shape == (5, 240, 320, 3)
    diff = np.abs(stills["cuda"].astype(int) - stills["cpu"].astype(int))
    assert (diff.max(-1) <= 1).mean() >= 0.999
    a = torch.from_numpy(stills["cpu"].astype(np.float32) / 255.0)
    b = torch.from_numpy(np.roll(stills["cpu"], 2, axis=2).astype(
        np.float32) / 255.0)
    for fn in (ssim, psnr):
        assert abs(float(fn(a.cuda(), b.cuda())) - float(fn(a, b))) <= 1e-5


# ---------------------------------------------------------- serving forms

# The depthwise modes "xla" and "shift" against the kernel at ENB0-HU's 12
# depthwise shapes: conv (cuDNN's grouped conv, or the per-tap f32 sum),
# then the folded BN and swish as ops of their own. f32: f32 rounding, as
# DW_TOL. bf16: the modes round three times (the conv's output, the BN's,
# swish's) where the kernel rounds once; a CPU run of this comparison needs
# rtol 2e-2 with atol 4.7e-3, held here to 2e-2 and 1e-2.
MODE_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}


@pytest.mark.parametrize("mode", ["xla", "shift"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,c,k,stride,pad", ENB0_HU_DW_SITES)
def test_depthwise_modes_match_kernel_at_sites(hw, c, k, stride, pad, dtype,
                                               mode):
    _need_card()
    x, taps, scale, bias = _site_dw_args(dtype, hw, c, k, seed=12)
    y, _ = depthwise_bn_swish(x, taps, scale, bias, stride=stride,
                              padding=pad)
    with depthwise_impl(mode):
        acc = conv2d(x, taps.permute(2, 0, 1).unsqueeze(1), stride=stride,
                     padding=pad, groups=c)
    out = F.silu(batch_norm(acc, scale, bias))
    assert out.dtype == dtype and out.shape == y.shape
    rtol, atol = MODE_TOL[dtype]
    torch.testing.assert_close(out.float(), y.float(), rtol=rtol, atol=atol)


# The int8 sites of RN50-HU, SN154-HU and DN161-HU at 228x304 (input hw,
# cin, cout, k, stride; ops/quant.py's gate), at batch 2: ResNet-50's and
# SENet-154's 3x3 and 1x1 convs, SENet's squeeze-excite reduce on a 1x1
# plane, DenseNet-161's two 1x1 convs at 1920 channels, R's 5x5 convs
# and its one-channel head.
INT8_SITES = [
    ((29, 38), 256, 256, 3, 2), ((15, 19), 256, 256, 3, 1),
    ((15, 19), 512, 512, 3, 2), ((8, 10), 2048, 512, 1, 1),
    ((8, 10), 512, 512, 3, 1), ((8, 10), 2048, 1024, 1, 1),
    ((15, 19), 512, 512, 3, 1), ((29, 38), 256, 256, 3, 1),
    ((114, 152), 128, 128, 5, 1), ((114, 152), 128, 1, 5, 1),
    ((57, 76), 256, 512, 3, 2), ((29, 38), 512, 1024, 3, 2),
    ((8, 10), 2048, 2048, 1, 1), ((15, 19), 1024, 2048, 3, 2),
    ((1, 1), 2048, 128, 1, 1), ((14, 19), 1920, 192, 1, 1),
    ((7, 9), 1920, 192, 1, 1),
]


@pytest.mark.parametrize("hw,cin,cout,k,stride", INT8_SITES)
def test_int8_conv_on_card_matches_cpu(hw, cin, cout, k, stride):
    """The int32 conv bit for bit the CPU's (``torch._int_mm`` a tap on
    both), and the dequantized f32 output within f32 rounding."""
    _need_card()
    g = torch.Generator().manual_seed(13)
    pad = ((k // 2, k // 2), (k // 2, k // 2))
    xq = torch.randint(-127, 128, (2, *hw, cin), generator=g,
                       dtype=torch.int8)
    kq = torch.randint(-127, 128, (cout, cin, k, k), generator=g,
                       dtype=torch.int8)
    ref = int_conv2d(xq, kq, (stride, stride), pad)
    assert torch.equal(int_conv2d(xq.cuda(), kq.cuda(), (stride, stride),
                                  pad).cpu(), ref)
    x = torch.randn(2, *hw, cin, generator=g)
    w = torch.randn(cout, cin, k, k, generator=g) / (k * cin ** 0.5)
    bias = torch.randn(cout, generator=g)
    ref = quant_conv2d(x, w, stride=(stride, stride), padding=pad, bias=bias)
    out = quant_conv2d(x.cuda(), w.cuda(), stride=(stride, stride),
                       padding=pad, bias=bias.cuda())
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-6, atol=1e-6)


def test_int_mm_pads_rows_and_one_channel_on_card():
    """``torch._int_mm`` on the card takes M > 16 and N a multiple of 8:
    the R head's one output channel and a short M are padded, and the
    block kept is the exact product."""
    _need_card()
    g = torch.Generator().manual_seed(14)
    for m, n in ((5, 1), (16, 1), (17, 1), (300, 3), (40, 8)):
        a = torch.randint(-127, 128, (m, 128), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, 128), generator=g, dtype=torch.int8)
        out = _int_mm(a.cuda(), w.cuda()).cpu()
        assert out.dtype == torch.int32 and out.shape == (m, n)
        assert torch.equal(out.long(), a.long() @ w.long().t())


# ------------------------------------------- registered ops and artifacts

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_pass_opcheck_on_card(dtype):
    """``torch.library.opcheck`` of the ``ede::`` ops on CUDA tensors: the
    depthwise op under stride 2 and asymmetric padding, the upsample-conv
    op with gradients, the loss pair and the loss."""
    _need_card()
    x, taps, scale, bias = _dw_args(dtype)
    torch.library.opcheck(torch.ops.ede.depthwise_bn_swish,
                          (x, taps, scale, bias, [2, 2], [1, 2, 1, 2]))
    x, k = _site_up_args(dtype, (14, 19), 24, 32)
    torch.library.opcheck(torch.ops.ede.upsample_conv, (
        x.clone().requires_grad_(), k.clone().requires_grad_(), [28, 38]))
    pred, target = _loss_args(dtype)
    mask = torch.ones(pred.shape[0], device="cuda")
    torch.library.opcheck(torch.ops.ede.fused_depth_loss_fwd, (pred, target))
    torch.library.opcheck(torch.ops.ede.fused_depth_loss_bwd, (
        pred, target, mask, torch.full((1,), 1e-3, device="cuda")))
    torch.library.opcheck(torch.ops.ede.fused_depth_loss, (
        pred.clone().requires_grad_(), target, mask, None))


@pytest.mark.parametrize("bake", [True, False])
def test_artifact_on_card_matches_cpu_twin(bake, tmp_path):
    """ENB0-HU's f32 artifact at batch 2, exported on the card and on the
    CPU: launches 16 + 2 (f32 routes) a call on the card, the depth of
    the two within the f32 model tolerance, each on its device."""
    _need_card()
    from efficientdepthestimation_tpu_torch.checkpoints.export import (
        load_serving_artifact,
        save_serving_artifact,
    )

    model = load_any_checkpoint(CHECKPOINT, device="cpu")
    frames = torch.from_numpy(fixture_frames()[:2])
    outs = {}
    for device in ("cuda", "cpu"):
        path = tmp_path / f"{device}.edz"
        meta = save_serving_artifact(
            str(path), model, encoder="efficientnet-b0", decoder="hu2018",
            batch=2, dtype=None, bake_weights=bake, device=device)
        assert meta["device"] == device
        fn, _ = load_serving_artifact(str(path))
        depthwise_bn_swish.launches = upsample_conv.launches = 0
        outs[device] = fn(frames)
        torch.cuda.synchronize()
        launches = (depthwise_bn_swish.launches, upsample_conv.launches)
        assert launches == ((16, 2) if device == "cuda" else (0, 0))
        assert outs[device].device.type == device
    torch.testing.assert_close(outs["cuda"].cpu(), outs["cpu"], rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_hw,out_hw,o", [((8, 10), (15, 19), 48),
                                            ((29, 38), (57, 76), 40),
                                            ((57, 76), (114, 152), 32)])
def test_window_kernel_matches_plain_and_whole_on_card(dtype, in_hw, out_hw,
                                                       o):
    """The upsample-conv kernel's row window (spatial serving's bands of 1,
    2, 3 and 8 ranks, with an unaligned x): its plain version within the
    kernel's tolerance, the whole-image kernel's rows bit for bit, and
    ``opcheck`` of the window op; it launches once a window."""
    _need_card()
    from efficientdepthestimation_tpu_torch.parallel.spatial import (
        owned_rows,
        upsample_conv_rows,
    )

    x, k = _site_up_args(dtype, in_hw, 24, o, b=3, offset=1)
    whole = upsample_conv(x, k, out_hw)
    rtol, atol = UP_TOL[dtype]
    for world in (1, 2, 3, 8):
        for rank in range(world):
            start, stop = owned_rows(out_hw[0], world, rank)
            lo, hi = upsample_conv_rows(start, stop, in_hw[0], out_hw[0])
            args = (x[:, lo:hi].contiguous(), k, out_hw,
                    (lo, in_hw[0], start, stop - start))
            before = upsample_conv.launches
            y = upproj.upsample_conv_window(*args)
            assert upsample_conv.launches == before + 1
            assert torch.equal(y, whole[:, start:stop])
            torch.testing.assert_close(
                y.float(), upproj.upsample_conv_window_plain(*args).float(),
                rtol=rtol, atol=atol)
    torch.library.opcheck(torch.ops.ede.upsample_conv_window,
                          (args[0], k, list(out_hw), list(args[3])))


def _fenced(t: torch.Tensor, rows: int = 2) -> torch.Tensor:
    """A contiguous copy of NHWC ``t`` between ``rows`` rows of NaN on
    either side in memory."""
    pad = rows * t.shape[2] * t.shape[3]
    flat = torch.full((t.numel() + 2 * pad,), float("nan"), dtype=t.dtype,
                      device=t.device)
    return flat[pad:pad + t.numel()].view(t.shape).copy_(t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_hw,out_hw", [((8, 10), (15, 19)),
                                          ((15, 20), (29, 38)),
                                          ((29, 38), (57, 76))])
def test_window_kernel_reads_only_its_slice_on_card(dtype, in_hw, out_hw):
    """ENB0's decoder steps of 0.5 put every other upsampled row on a source
    row, and the kernel also loads the row below it, at a weight of 0. With
    each window's source rows between rows of NaN in memory, the window
    equals the whole image's rows for every rank of 1-8 and every image of
    the batch: the kernel read no row outside the slice it was given."""
    _need_card()
    from efficientdepthestimation_tpu_torch.parallel.spatial import (
        owned_rows,
        upsample_conv_rows,
    )

    x, k = _site_up_args(dtype, in_hw, 24, 32, b=2)
    whole = upsample_conv(x, k, out_hw)
    for world in range(1, 9):
        for rank in range(world):
            start, stop = owned_rows(out_hw[0], world, rank)
            if stop == start:
                continue
            lo, hi = upsample_conv_rows(start, stop, in_hw[0], out_hw[0])
            y = upproj.upsample_conv_window(
                _fenced(x[:, lo:hi]), k, out_hw,
                (lo, in_hw[0], start, stop - start))
            assert torch.equal(y, whole[:, start:stop]), (world, rank)


def test_spatial_serving_in_a_world_of_one_on_card():
    """Spatial serving in a world of one on the card (every row the rank's
    band): the kernels' launches of one card, the output within the f32
    tolerance of the plain serving fn's."""
    _need_card()
    from efficientdepthestimation_tpu_torch.parallel import create_mesh

    model = load_any_checkpoint(CHECKPOINT, device="cuda")
    frames = torch.from_numpy(fixture_frames()[:2]).cuda()
    want = make_serving_fn(model, upsample_to=(480, 640), preprocess=True,
                           device="cuda")(frames)
    fn = make_serving_fn(model, upsample_to=(480, 640), preprocess=True,
                         mesh=create_mesh(device="cuda"), spatial=True)
    depthwise_bn_swish.launches = upsample_conv.launches = 0
    got = fn(frames)
    assert (depthwise_bn_swish.launches, upsample_conv.launches) == (16, 2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
