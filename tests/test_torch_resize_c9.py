"""C9: the eval preprocess of uint8 frames whose Scale-240 pass reads more
than two source pixels an output (a downsample) against the JAX package's,
both on the CPU.

``quantize_uint8`` rounds each resampled value to a uint8 level, and a
value within f32 rounding of a tie goes to the side its sum's rounding
gives it. The JAX package sums a pass as XLA's CPU dot does; the port sums
it tap by tap in that dot's order (``ops.resize.xla_cpu_sum_order``: four
running sums by source index mod 4 in blocks of 2048, or one in blocks of
512), so each pass is JAX's bit for bit and the levels are JAX's. The
order was read off one XLA version (``XLA_CPU_RULE_FITTED_ON``), which a
failure names beside this one's.
"""

import jax
import jax.numpy as jnp
import jaxlib
import numpy as np
import pytest
import torch

from efficientdepthestimation_tpu.data.transforms import (
    eval_preprocess_image_only as jax_eval_preprocess,
)
from efficientdepthestimation_tpu.data.transforms import (
    scale_short_side as jax_scale_short_side,
)
from efficientdepthestimation_tpu.ops.resize import (
    _apply_separable as jax_apply_separable,
)
from efficientdepthestimation_tpu.ops.resize import (
    pil_resize_matrix as jax_pil_resize_matrix,
)

from efficientdepthestimation_tpu_torch.data.transforms import (
    eval_preprocess_image_only,
    scale_short_side,
    scale_short_side_size,
)
from efficientdepthestimation_tpu_torch.ops.resize import (
    XLA_CPU_RULE_FITTED_ON,
    _pil_pass,
    pil_sum_program,
    xla_cpu_sum_order,
)

VERSIONS = (f"ops.resize's XLA CPU sum order was read off "
            f"{XLA_CPU_RULE_FITTED_ON}; this is jax {jax.__version__}, "
            f"jaxlib {jaxlib.__version__}")
# 300x500 -> 240x400: 3 taps in both passes; 1080x1920 -> 240x427: 7-9.
SIZES = [(300, 500), (1080, 1920)]
# The normalization after the levels, (x / 255 - mean) / std, rounds in
# another order than XLA's fused form: 4.8e-7 at most; one uint8 level
# apart would be 1 / (255 * 0.225) = 0.017.
NORMALIZE_ATOL = 1e-6


def frames(hw, seed):
    return np.random.default_rng(seed).integers(0, 256, (1, *hw, 3),
                                                dtype=np.uint8)


def taps(in_size, out_size):
    return int((pil_sum_program(in_size, out_size)[1] != 0)
               .sum(axis=(0, 1, 2)).max())


@pytest.mark.parametrize("hw", SIZES)
def test_scale_240_levels_match_jax(hw):
    """The uint8 levels of Scale(240) (``pil_resize(quantize_uint8=True)``)
    and the normalized tensor ``eval_preprocess_image_only`` returns."""
    x = frames(hw, 0)
    want = np.asarray(jax_scale_short_side(
        jnp.asarray(x).astype(jnp.float32), 240, "bilinear", True))
    got = scale_short_side(torch.from_numpy(x).float(), 240, "bilinear",
                           True).numpy()
    off = int((got != want).sum())
    assert off == 0, f"{off} of {want.size} uint8 levels differ; {VERSIONS}"
    want = np.asarray(jax_eval_preprocess(jnp.asarray(x)))
    got = eval_preprocess_image_only(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMALIZE_ATOL,
                               err_msg=VERSIONS)


@pytest.mark.parametrize("hw", SIZES)
def test_each_pass_is_jax_bit_for_bit(hw):
    """Each pass in f32 before the levels, from the same input: JAX's is its
    separable product with the identity on the other axis (exact)."""
    (h, w), x = hw, frames(hw, 1).astype(np.float32)
    oh, ow = scale_short_side_size(h, w, 240)
    assert min(taps(h, oh), taps(w, ow)) > 2
    want_h = np.array(jax_apply_separable(
        jnp.asarray(x), jax_pil_resize_matrix(h, oh),
        np.eye(w, dtype=np.float32)))
    got_h = _pil_pass(torch.from_numpy(x), h, oh, 1, "bilinear").numpy()
    np.testing.assert_array_equal(got_h, want_h, err_msg=VERSIONS)
    want_w = np.asarray(jax_apply_separable(
        jnp.asarray(want_h), np.eye(oh, dtype=np.float32),
        jax_pil_resize_matrix(w, ow)))
    got_w = _pil_pass(torch.from_numpy(want_h), w, ow, 2, "bilinear").numpy()
    np.testing.assert_array_equal(got_w, want_w, err_msg=VERSIONS)


@pytest.mark.parametrize("in_size,out_size", [
    (2160, 240),   # a 4K frame's rows: four sums, a window across k = 2048
    (1100, 320),   # (320 - 1) % 64 >= 48: one sum, windows across 512
    (3000, 240),   # 25-26 taps, four sums, a window across 2048
])
def test_blocks_of_the_sum_match_jax(in_size, out_size):
    """Windows that straddle the dot's K blocks, a few rows deep."""
    assert in_size > xla_cpu_sum_order(out_size)[1]
    x = np.random.default_rng(in_size).integers(
        0, 256, (1, in_size, 8, 3)).astype(np.float32)
    want = np.asarray(jax_apply_separable(
        jnp.asarray(x), jax_pil_resize_matrix(in_size, out_size),
        np.eye(8, dtype=np.float32)))
    got = _pil_pass(torch.from_numpy(x), in_size, out_size, 1,
                    "bilinear").numpy()
    np.testing.assert_array_equal(got, want, err_msg=VERSIONS)
