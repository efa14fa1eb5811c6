"""The port's SENet encoders (SENet-154 and the Cadene zoo) and their
Hu2018 / MiDaS models against the JAX package, on the CPU.

Forwards as ``tests/test_torch_densenet.py``: seeded numpy variables of
``jax.eval_shape``, 64×96 inputs, rtol 1e-3 and atol 1e-4
(``test_torch_midas.TOL``), here at ``layers=(1, 1, 1, 1)`` for each of
the three bottleneck styles (the stem, the first block of every stage with
its downsample, the SE module); full depth is held against the golden
fixture (``tests/test_torch_golden_full_size.py``). Keys at full width;
anything the port only moves must be equal.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from efficientdepthestimation_tpu.checkpoints import pth_import as jpth
from efficientdepthestimation_tpu.checkpoints import (
    serialization as jserialization,
)
from efficientdepthestimation_tpu.models import hu2018 as jax_hu2018
from efficientdepthestimation_tpu.models import midas as jax_midas
from efficientdepthestimation_tpu.models.registry import (
    build_model as jax_build_model,
)
from efficientdepthestimation_tpu.models.senet import (
    SENET_CONFIGS as JAX_SENET_CONFIGS,
    SENetFeatures as JaxSENetFeatures,
    senet_block_channels as jax_senet_block_channels,
)

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
)
from efficientdepthestimation_tpu_torch.checkpoints import pth_import
from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    from_jax_variables,
)
from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
    load_checkpoint,
)
from efficientdepthestimation_tpu_torch.models.hu2018 import HuDepthModel
from efficientdepthestimation_tpu_torch.models.midas import MidasNet
from efficientdepthestimation_tpu_torch.models.registry import build_model
from efficientdepthestimation_tpu_torch.models.senet import (
    SENET_CONFIGS,
    SENetFeatures,
    senet_block_channels,
)

from test_torch_densenet import (
    MIDAS_SIZES,
    check_jax_variables,
    check_key_rule,
    check_model,
)
from test_torch_midas import INPUT_HW, TOL, _inputs, _load, random_variables
from torch_tmp_cleanup import delete_tmp_path  # noqa: F401  (autouse)

SMALL = (1, 1, 1, 1)
# One variant of each bottleneck style.
STYLES = ["senet154", "se_resnet50", "se_resnext50_32x4d"]
# SN154-HU, SN154-LR and the rest of the zoo under Hu2018, at full width.
FULL_WIDTH = [("senet154", "hu2018"), ("senet154", "lasinger2019")] + [
    (name, "hu2018") for name in sorted(SENET_CONFIGS) if name != "senet154"]


def small_models(variant: str, decoder: str) -> tuple:
    """(JAX model, port model) of ``variant`` at ``layers=SMALL``."""
    channels = senet_block_channels(variant)
    factory = functools.partial(JaxSENetFeatures, variant=variant,
                                layers=SMALL)
    encoder = SENetFeatures(variant, layers=SMALL)
    if decoder == "hu2018":
        return (jax_hu2018.HuDepthModel(encoder_factory=factory,
                                        num_features=channels[-1],
                                        block_channel=tuple(channels)),
                HuDepthModel(encoder, channels[-1], channels).eval())
    return (jax_midas.MidasNet(encoder_factory=factory,
                               encoder_block_channels=tuple(channels),
                               **MIDAS_SIZES),
            MidasNet(encoder, channels, **MIDAS_SIZES).eval())


def test_senet_configs_match_jax():
    assert SENET_CONFIGS == JAX_SENET_CONFIGS
    for name in SENET_CONFIGS:
        assert senet_block_channels(name) == jax_senet_block_channels(name)


@pytest.mark.parametrize("decoder", ["hu2018", "lasinger2019"])
@pytest.mark.parametrize("variant", STYLES)
def test_senet_taps_and_output_match_jax(variant, decoder):
    check_model(*small_models(variant, decoder), seed=31)


@pytest.mark.parametrize("encoder,decoder", FULL_WIDTH)
def test_senet_model_has_the_jax_variables(encoder, decoder):
    check_jax_variables(encoder, decoder)


@pytest.mark.parametrize("encoder,decoder", FULL_WIDTH)
def test_senet_key_rule_matches_jax(encoder, decoder):
    check_key_rule(encoder, decoder)


@pytest.mark.parametrize("vintage", ["se_module.", "se_"])
def test_senet_pth_forward_matches_jax_import(vintage, tmp_path):
    """SN154-HU at ``layers=SMALL`` written as the reference released it
    (raw ``state_dict``, ``module.`` prefix), its SE keys in either of the
    reference's vintages (``se_module.fc1``; ``se_fc1``,
    reside_model.py:42-43): ``load_any_checkpoint`` gives back every
    weight and forwards as JAX's ``import_pth``."""
    jm, model = small_models("senet154", "hu2018")
    variables = random_variables(jm, jnp.zeros((1, *INPUT_HW, 3)), False,
                                 seed=33)
    source = _load(model, variables)
    state = {f"module.{k}".replace("se_module.", vintage):
             v for k, v in pth_import.reference_state_dict(source).items()}
    assert any(f".{vintage}fc1." in k for k in state)
    path = str(tmp_path / "SN154-HU.pth")
    torch.save(state, path)
    loaded = load_any_checkpoint(path, small_models("senet154", "hu2018")[1],
                                 device="cpu")
    for key, value in source.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key
    ref_model, ref_vars = jpth.import_pth(path, model=jm,
                                          example_input_hw=INPUT_HW)
    x = _inputs((2, *INPUT_HW, 3), seed=34)
    ref = np.asarray(jax.jit(ref_model.apply)(ref_vars, jnp.asarray(x)))
    with torch.inference_mode():
        out = loaded(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_sn154_ede_from_jax_loads_and_forwards(tmp_path):
    """A ``hu2018-state`` ``.ede`` of SN154-HU at full depth that JAX's
    ``save_checkpoint`` wrote loads through ``load_checkpoint`` and
    ``load_any_checkpoint`` with JAX's every value, and forwards as JAX's
    ``load_checkpoint`` model."""
    jm = jax_build_model("senet154", "hu2018")
    variables = random_variables(jm, jnp.zeros((1, *INPUT_HW, 3)), False,
                                 seed=35)
    path = str(tmp_path / "sn154.ede")
    jserialization.save_checkpoint(path, variables, encoder="senet154",
                                   decoder="hu2018")
    model, header = load_checkpoint(path)
    assert header["encoder"] == "senet154"
    want = from_jax_variables(variables)
    for key, value in model.state_dict().items():
        assert torch.equal(value, want[key]), key
    model = load_any_checkpoint(path, device="cpu")
    ref_model, ref_vars, _ = jserialization.load_checkpoint(path)
    x = _inputs((2, *INPUT_HW, 3), seed=36)
    ref = np.asarray(jax.jit(ref_model.apply)(ref_vars, jnp.asarray(x)))
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
