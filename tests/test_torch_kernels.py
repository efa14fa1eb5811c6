"""The PyTorch port's kernel modules and numeric substrate against JAX.

Each plain PyTorch version is held against the JAX function it replaces:
``depthwise_bn_swish_plain`` against the Pallas kernel run in interpret
mode, ``upsample_conv_plain`` against ``upsample_conv_pallas`` in interpret
mode. The CUDA kernels themselves run only on a card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from efficientdepthestimation_tpu.ops import conv as jconv
from efficientdepthestimation_tpu.ops import fused as jfused
from efficientdepthestimation_tpu.ops import resize as jresize
from efficientdepthestimation_tpu.ops.pallas.depthwise import (
    depthwise_bn_swish as jax_depthwise_bn_swish,
)
from efficientdepthestimation_tpu.ops.pallas.upproj import (
    _padded_matrix,
    upsample_conv_pallas,
)

from efficientdepthestimation_tpu_torch.ops import conv, fused, resize
from efficientdepthestimation_tpu_torch.ops.kernels import build
from efficientdepthestimation_tpu_torch.ops.kernels.depthwise import (
    depthwise_bn_swish,
    depthwise_bn_swish_plain,
)
from efficientdepthestimation_tpu_torch.ops.kernels.upproj import (
    upsample_conv,
    upsample_conv_plain,
)


def _dw_inputs(seed, k, c, hw, b=2):
    rng = np.random.default_rng(seed)
    h, w = hw
    return (rng.standard_normal((b, h, w, c)).astype(np.float32),
            rng.standard_normal((k, k, c)).astype(np.float32),
            rng.uniform(0.5, 2.0, (c,)).astype(np.float32),
            rng.standard_normal((c,)).astype(np.float32))


# ENB0's static same pads (canonical 224): k3 s1 (1,1), k5 s1 (2,2),
# k3 s2 (0,1), k5 s2 (1,2); C not a multiple of the kernel's 32 lanes too.
@pytest.mark.parametrize("k,stride,c,hw", [
    (3, 1, 32, (19, 27)),
    (5, 1, 48, (15, 19)),
    (3, 2, 16, (21, 26)),
    (5, 2, 32, (29, 38)),
    (3, 1, 40, (7, 9)),
    (5, 2, 24, (14, 19)),
])
def test_depthwise_plain_matches_jax(k, stride, c, hw):
    x, taps, scale, bias = _dw_inputs(k * 100 + c, k, c, hw)
    pad = conv.same_padding_static((224, 224), (k, k), (stride, stride))
    assert pad == jconv.same_padding_static((224, 224), (k, k),
                                            (stride, stride))
    y_ref, sums_ref = jax_depthwise_bn_swish(
        jnp.asarray(x), jnp.asarray(taps), jnp.asarray(scale),
        jnp.asarray(bias), stride=(stride, stride), padding=pad,
        interpret=True)
    y, sums = depthwise_bn_swish_plain(
        torch.from_numpy(x), torch.from_numpy(taps), torch.from_numpy(scale),
        torch.from_numpy(bias), stride=stride, padding=pad)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_ref),
                               rtol=1e-4, atol=1e-4)


def test_depthwise_wrapper_runs_plain_on_cpu():
    x, taps, scale, bias = (torch.from_numpy(a)
                            for a in _dw_inputs(0, 3, 24, (9, 11)))
    before = depthwise_bn_swish.launches
    y, sums = depthwise_bn_swish(x, taps, scale, bias, stride=2,
                                 padding=((0, 1), (0, 1)))
    y_ref, sums_ref = depthwise_bn_swish_plain(x, taps, scale, bias, 2,
                                               ((0, 1), (0, 1)))
    assert torch.equal(y, y_ref) and torch.equal(sums, sums_ref)
    assert y.shape == (2, 4, 5, 24) and sums.dtype == torch.float32
    assert depthwise_bn_swish.launches == before  # no kernel on the CPU


def test_depthwise_plain_bf16_rounds_once():
    x, taps, scale, bias = (torch.from_numpy(a)
                            for a in _dw_inputs(1, 5, 16, (8, 10)))
    xb, tb = x.bfloat16(), taps.bfloat16()
    y, sums = depthwise_bn_swish_plain(xb, tb, scale, bias, 1,
                                       ((2, 2), (2, 2)))
    y32, sums32 = depthwise_bn_swish_plain(xb.float(), tb.float(), scale,
                                           bias, 1, ((2, 2), (2, 2)))
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, y32.bfloat16())
    assert torch.equal(sums, sums32)  # sums are taken before the cast


def test_wrappers_reject_other_devices():
    x = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        depthwise_bn_swish(x, torch.zeros(3, 3, 8), torch.ones(8),
                           torch.zeros(8))
    with pytest.raises(ValueError, match="unsupported device"):
        upsample_conv(x, torch.zeros(5, 5, 8, 4), (8, 8))


# The four direct-path sites of ENB0-HU at 228×304 (in → out), narrow C/O.
@pytest.mark.parametrize("in_hw,out_hw,c,o", [
    ((14, 19), (28, 38), 4, 6),     # D.up2
    ((28, 38), (57, 76), 3, 4),     # D.up3
    ((57, 76), (114, 152), 2, 4),   # D.up4
    ((57, 76), (114, 152), 3, 5),   # MFF.up1
])
def test_upsample_conv_plain_matches_jax(in_hw, out_hw, c, o):
    rng = np.random.default_rng(sum(in_hw) + c)
    x = rng.standard_normal((1, *in_hw, c)).astype(np.float32)
    k = (0.2 * rng.standard_normal((5, 5, c, o))).astype(np.float32)
    ref = upsample_conv_pallas(jnp.asarray(x), jnp.asarray(k), out_hw, True)
    y = upsample_conv_plain(torch.from_numpy(x), torch.from_numpy(k), out_hw)
    assert y.shape == (1, *out_hw, o)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_upsample_conv_wrapper_runs_plain_on_cpu():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, 7, 3)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((5, 5, 3, 4)).astype(np.float32))
    before = upsample_conv.launches
    assert torch.equal(upsample_conv(x, k, (10, 13)),
                       upsample_conv_plain(x, k, (10, 13)))
    assert upsample_conv.launches == before


def test_upsample_conv_pair_matches_jax():
    """The einsum rewrite at a site should_fuse sends to it (D.up1)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 9, 12)).astype(np.float32)
    k1 = (0.1 * rng.standard_normal((5, 5, 12, 6))).astype(np.float32)
    k2 = (0.1 * rng.standard_normal((5, 5, 12, 6))).astype(np.float32)
    assert fused.should_fuse((7, 9), (14, 19), 160, 80)
    r1, r2 = jfused.upsample_conv_pair(jnp.asarray(x), jnp.asarray(k1),
                                       jnp.asarray(k2), (14, 19))
    t1, t2 = fused.upsample_conv_pair(torch.from_numpy(x),
                                      torch.from_numpy(k1),
                                      torch.from_numpy(k2), (14, 19))
    np.testing.assert_allclose(t1.numpy(), np.asarray(r1), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t2.numpy(), np.asarray(r2), rtol=1e-4,
                               atol=1e-5)


def test_should_fuse_matches_jax():
    """Same cost model, same choice at every Hu decoder site shape."""
    sites = [((7, 9), (14, 19), 160, 80), ((14, 19), (28, 38), 80, 40),
             ((28, 38), (57, 76), 40, 20), ((57, 76), (114, 152), 20, 10),
             ((57, 76), (114, 152), 24, 16), ((28, 38), (114, 152), 40, 16),
             ((14, 19), (114, 152), 80, 16), ((7, 9), (114, 152), 320, 16),
             ((12, 16), (48, 64), 2048, 16), ((6, 8), (12, 16), 1024, 512)]
    for in_hw, out_hw, cin, cout in sites:
        assert fused.should_fuse(in_hw, out_hw, cin, cout) == \
            jfused.should_fuse(in_hw, out_hw, cin, cout)
        assert fused.fuse_costs(in_hw, out_hw, cin, cout) == \
            jfused.fuse_costs(in_hw, out_hw, cin, cout)


@pytest.mark.parametrize("in_hw,out_hw", [((7, 9), (14, 19)),
                                          ((114, 152), (480, 640)),
                                          ((5, 5), (5, 5))])
def test_resize_bilinear_align_corners_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(5).standard_normal((2, *in_hw, 3)).astype(
        np.float32)
    ref = jresize.resize_bilinear_align_corners(jnp.asarray(x), out_hw)
    y = resize.resize_bilinear_align_corners(torch.from_numpy(x), out_hw)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("filt", ["bilinear", "bicubic", "box", "nearest"])
def test_pil_resize_matches_jax(filt):
    x = np.random.default_rng(6).uniform(0, 255, (1, 30, 40, 3)).astype(
        np.float32)
    for size in ((15, 20), (45, 53)):
        ref = jresize.pil_resize(jnp.asarray(x), size, filt)
        y = resize.pil_resize(torch.from_numpy(x), size, filt)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("k,stride,pad,groups", [
    (3, 2, ((0, 1), (0, 1)), 1),   # the stem's asymmetric static pad
    (5, 1, 2, 1),
    (1, 1, 0, 1),
    (3, 1, 1, 4),
])
def test_conv2d_matches_jax(k, stride, pad, groups):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 11, 13, 8)).astype(np.float32)
    w_hwio = rng.standard_normal((k, k, 8 // groups, 12)).astype(np.float32)
    ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(w_hwio), stride=stride,
                       padding=pad, groups=groups)
    y = conv.conv2d(torch.from_numpy(x),
                    torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy()),
                    stride=stride, padding=pad, groups=groups)
    assert y.is_contiguous()
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["depthwise_bn_swish"])



def test_cached_constants_serve_autograd_after_inference():
    """Matrices first built under inference mode stay usable with grad."""
    x = torch.randn(1, 3, 4, 2)
    with torch.inference_mode():
        resize.resize_bilinear_align_corners(x, (6, 7))
    xg = x.clone().requires_grad_()
    resize.resize_bilinear_align_corners(xg, (6, 7)).sum().backward()
    assert xg.grad is not None and xg.grad.shape == x.shape


@pytest.mark.parametrize("in_hw,out_hw", [((14, 19), (28, 38)),
                                          ((57, 76), (114, 152)),
                                          ((5, 7), (13, 9)),
                                          ((1, 1), (2, 3))])
def test_upsample_conv_plain_is_the_padded_matrix_form(in_hw, out_hw):
    """The function the kernel computes, with the conv's zero border folded
    into zero rows of the interpolation matrices as in the Pallas kernel
    (JAX ``_padded_matrix``), is the plain version's, in f32."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, *in_hw, 13)).astype(np.float32)
    k = (0.2 * rng.standard_normal((5, 5, 13, 7))).astype(np.float32)
    a = _padded_matrix(in_hw[0], out_hw[0], 2).astype(np.float64)
    b = _padded_matrix(in_hw[1], out_hw[1], 2).astype(np.float64)
    up = np.einsum("Hh,nhwc,Ww->nHWc", a, x.astype(np.float64), b)
    h, w = out_hw
    ref = sum(np.einsum("nhwc,co->nhwo", up[:, dp:dp + h, dq:dq + w],
                        k[dp, dq]) for dp in range(5) for dq in range(5))
    y = upsample_conv_plain(torch.from_numpy(x), torch.from_numpy(k), out_hw)
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-4)
