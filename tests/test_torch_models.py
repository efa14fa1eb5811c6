"""The PyTorch port's Hu2018 models against the JAX modules, random weights.

The JAX module initialises the variables; its running statistics are then
randomised so every BatchNorm fold is non-trivial; ``from_jax_variables``
gives the port the same weights. Small inputs keep the CPU time low; the
static same padding and the stage splits do not depend on the input size.
Tolerance rtol 1e-3, atol 1e-4 (as ``test_parity_full_size.py``).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from efficientdepthestimation_tpu.models import (
    efficientnet as jax_efficientnet,
)
from efficientdepthestimation_tpu.models.efficientnet import (
    efficientnet_block_channels as jax_block_channels,
)
from efficientdepthestimation_tpu.models.registry import (
    build_model as jax_build_model,
)

from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    from_jax_variables,
    to_jax_leaf,
)
from efficientdepthestimation_tpu_torch.models.efficientnet import (
    efficientnet_block_channels,
)
from efficientdepthestimation_tpu_torch.models.registry import build_model

TOL = dict(rtol=1e-3, atol=1e-4)


def _random_variables(model, input_hw, seed):
    variables = model.init({"params": jax.random.PRNGKey(seed)},
                           jnp.zeros((1, *input_hw, 3)), False)
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


@pytest.mark.parametrize("variant", ["efficientnet-b0", "efficientnet-b4"])
def test_block_channels_match_jax(variant):
    assert efficientnet_block_channels(variant) == \
        jax_block_channels(variant)


@pytest.mark.parametrize("variant,input_hw", [
    ("efficientnet-b0", (64, 96)),
    ("efficientnet-b4", (64, 96)),
])
def test_hu_model_matches_jax(variant, input_hw):
    jm = jax_build_model(variant, "hu2018")
    variables = _random_variables(jm, input_hw, seed=1)
    model = build_model(variant, "hu2018")
    model.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    x = np.random.default_rng(2).standard_normal(
        (2, *input_hw, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), False))
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, input_hw[0] // 2,
                                      input_hw[1] // 2, 1)
    np.testing.assert_allclose(out, ref, **TOL)


def test_training_mode_matches_jax():
    """ENB0-HU in training mode (batch statistics, drop-connect off) against
    ``apply(..., True, mutable=["batch_stats"])``: the output and every
    updated running statistic, f32; statistics to 1e-6 (one EMA step)."""
    input_hw = (64, 96)
    jm = jax_build_model("efficientnet-b0", "hu2018")
    jm = jm.clone(encoder_factory=functools.partial(
        jax_efficientnet.EfficientNetFeatures, variant="efficientnet-b0",
        drop_connect_rate=0.0))
    variables = _random_variables(jm, input_hw, seed=3)
    model = build_model("efficientnet-b0", "hu2018")
    model.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    model.E.drop_connect_rate = 0.0
    x = np.random.default_rng(4).standard_normal(
        (2, *input_hw, 3)).astype(np.float32)
    ref, updates = jax.jit(functools.partial(
        jm.apply, train=True, mutable=["batch_stats"]))(variables,
                                                        jnp.asarray(x))
    with torch.no_grad():
        out = model.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    stats = updates["batch_stats"]
    for name, buf in model.named_buffers():
        _, path, value = to_jax_leaf(name, buf)
        expected = stats
        for key in path.split("/"):
            expected = expected[key]
        np.testing.assert_allclose(value, np.asarray(expected), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
