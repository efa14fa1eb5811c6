"""The port builds each released configuration with exactly the JAX model's
variables, at full width and depth.

For each of the six released configurations ({ENB0, ENB4, RN50} × {HU, LR},
reference README.md:49-56) the JAX variable tree comes from
``jax.eval_shape`` of the module's init at 228×304, so nothing is computed;
``from_jax_variables`` of that tree (zeros of each leaf's shape) must have
the keys and shapes of the port's ``state_dict`` and load strictly. Also the
registry's other entry points against the JAX package's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from efficientdepthestimation_tpu.models import registry as jax_registry

from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    from_jax_variables,
)
from efficientdepthestimation_tpu_torch.models import registry
from efficientdepthestimation_tpu_torch.models.hu2018 import HuDepthModel
from efficientdepthestimation_tpu_torch.models.midas import MidasNet

RELEASED = [(enc, dec) for enc in ("efficientnet-b0", "efficientnet-b4",
                                   "resnet50")
            for dec in ("hu2018", "lasinger2019")]


def _jax_tree_zeros(model, input_hw=(228, 304)) -> dict:
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *input_hw, 3)),
        False))
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)


@pytest.mark.parametrize("encoder,decoder", RELEASED)
def test_released_config_has_the_jax_variables(encoder, decoder):
    state = from_jax_variables(_jax_tree_zeros(
        jax_registry.build_model(encoder, decoder)))
    model = registry.build_model(encoder, decoder)
    ours = model.state_dict()
    assert sorted(state) == sorted(ours)
    for key, value in state.items():
        assert tuple(value.shape) == tuple(ours[key].shape), key
    model.load_state_dict(state, strict=True)
    assert not model.training
    assert isinstance(model, HuDepthModel if decoder == "hu2018"
                      else MidasNet)


def test_encoder_specs_match_jax():
    for name, spec in registry.ENCODER_SPECS.items():
        jspec = jax_registry.encoder_spec(name)
        assert (spec.name, spec.block_channels, spec.num_features) == \
            (jspec.name, jspec.block_channels, jspec.num_features), name
    assert set(registry.ENCODER_SPECS) == set(jax_registry.ENCODER_SPECS)
    with pytest.raises(ValueError, match="Unknown encoder"):
        registry.encoder_spec("vgg16")
    with pytest.raises(ValueError, match="Unknown decoder"):
        registry.build_model("resnet50", "unet")


def test_midas_build_options_match_jax():
    """``num_features``, ``non_negative`` and the HW sizes reach the
    decoder as in the JAX package."""
    jm = jax_registry.build_model("resnet18", "lasinger2019",
                                  output_size=(50, 60), input_size=(100, 120),
                                  num_features=32, non_negative=True)
    model = registry.build_model("resnet18", "midas", output_size=(50, 60),
                                 input_size=(100, 120), num_features=32,
                                 non_negative=True)
    assert model.output_size == jm.output_size == (50, 60)
    assert model.input_size == jm.input_size == (100, 120)
    assert model.decoder.feature_count == 32 and model.decoder.non_negative
    auto = registry.build_model("efficientnet-b4", "lasinger2019")
    assert auto.decoder.feature_count == 32  # the first tap's channels
    assert auto.output_size == (114, 152) and auto.input_size == (228, 304)


@pytest.mark.parametrize("flags,encoder", [
    (dict(is_resnet=True), "resnet50"),
    (dict(is_densenet=True), "densenet161"),
    (dict(is_senet=True), "senet154"),
    (dict(is_efficientnet=True), "efficientnet-b0"),
    (dict(is_efficientnet=True, efficientnet_variant="efficientnet-b4"),
     "efficientnet-b4"),
])
def test_define_model_matches_jax(flags, encoder):
    jm = jax_registry.define_model(**flags)
    model = registry.define_model(**flags)
    assert isinstance(model, HuDepthModel)
    assert model.block_channel == tuple(jm.block_channel)
    assert model.num_features == jm.num_features
    assert type(model.E).__name__ == {
        "resnet50": "ResNetFeatures", "densenet161": "DenseNetFeatures",
        "senet154": "SENetFeatures"}.get(encoder, "EfficientNetFeatures")
    with pytest.raises(ValueError, match="No encoder"):
        registry.define_model()


def test_model_from_checkpoint_name():
    model = registry.model_from_checkpoint_name("RN50-LR.pth",
                                                output_size=(57, 76))
    assert isinstance(model, MidasNet) and model.output_size == (57, 76)
    assert isinstance(registry.model_from_checkpoint_name(
        "/a/ENB4-HU.ede"), HuDepthModel)
    dn161 = registry.model_from_checkpoint_name("DN161-HU.pth")
    assert isinstance(dn161, HuDepthModel) and dn161.num_features == 2208
    assert type(dn161.E).__name__ == "DenseNetFeatures"
