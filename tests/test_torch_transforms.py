"""The PyTorch port's eval preprocessing against the JAX package's.

Both resample with PIL's bilinear matrices and round to uint8 between the
Scale and the crop. Summed in another order, a value within an ulp of a .5
tie can round the other way, which moves that pixel by one quantisation step
of the normalized output: 1/(255·std), at most 1/(255·0.224) ≈ 0.0175 (the
green channel). The tolerance is: at most one such step on at most 0.1% of
values, 1e-5 everywhere else.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from efficientdepthestimation_tpu.data import transforms as jt

from efficientdepthestimation_tpu_torch.data import transforms as tt

STEP = 1.0 / (255 * min(tt.IMAGENET_STD))  # one uint8 level, normalized


def _assert_preprocess_close(ours: np.ndarray, ref: np.ndarray) -> None:
    assert ours.shape == ref.shape
    diff = np.abs(ours - ref)
    assert diff.max() <= STEP + 1e-5
    assert np.mean(diff > 1e-5) <= 1e-3


@pytest.mark.parametrize("hw", [(480, 640), (240, 320), (300, 500)])
def test_eval_preprocess_matches_jax(hw):
    frames = np.random.default_rng(sum(hw)).integers(0, 256, (2, *hw, 3),
                                                     dtype=np.uint8)
    ref = np.asarray(jt.eval_preprocess_image_only(jnp.asarray(frames)))
    ours = tt.eval_preprocess_image_only(torch.from_numpy(frames))
    assert ours.dtype == torch.float32 and ours.is_contiguous()
    _assert_preprocess_close(ours.numpy(), ref)


def test_demo_preprocess_matches_jax():
    frames = np.random.default_rng(2).integers(0, 256, (1, 480, 640, 3),
                                               dtype=np.uint8)
    ref = np.asarray(jt.demo_preprocess(jnp.asarray(frames)))
    ours = tt.demo_preprocess(torch.from_numpy(frames)).numpy()
    _assert_preprocess_close(ours, ref)


def test_normalize_imagenet_matches_jax():
    x = np.random.default_rng(3).uniform(0, 1, (2, 5, 7, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        tt.normalize_imagenet(torch.from_numpy(x)).numpy(),
        np.asarray(jt.normalize_imagenet(jnp.asarray(x))), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("h,w", [(480, 640), (640, 480), (240, 320),
                                 (241, 333), (100, 240)])
def test_scale_and_crop_boxes_match_jax(h, w):
    size = tt.scale_short_side_size(h, w, 240)
    assert size == jt.scale_short_side_size(h, w, 240)
    assert tt.center_crop_box(*size, 228, 304) == \
        jt.center_crop_box(*size, 228, 304)
