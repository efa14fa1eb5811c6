"""The port's DenseNet encoder and DN161-HU / DN161-LR against the JAX
package, on the CPU.

Forwards: JAX variables from ``jax.eval_shape`` filled from a seeded numpy
generator (``test_torch_midas.random_variables``), so only forwards compile;
64×96 inputs, MiDaS output 32×48; the encoder's taps and the model's output
to rtol 1e-3, atol 1e-4 (``test_torch_midas.TOL``). Keys: the JAX tree at
full width, from ``jax.eval_shape`` at 228×304; what the port only moves
(keys, shapes, weights written and read back) must be equal.
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
from efficientdepthestimation_tpu.models.densenet import (
    DenseNetFeatures as JaxDenseNetFeatures,
    densenet_block_channels as jax_densenet_block_channels,
)
from efficientdepthestimation_tpu.models.registry import (
    build_model as jax_build_model,
)

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
)
from efficientdepthestimation_tpu_torch.checkpoints import pth_import
from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    from_jax_variables,
    to_jax_leaf,
)
from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
    load_checkpoint,
)
from efficientdepthestimation_tpu_torch.models.densenet import (
    DENSENET_CONFIGS,
    DenseNetFeatures,
    densenet_block_channels,
)
from efficientdepthestimation_tpu_torch.models.hu2018 import HuDepthModel
from efficientdepthestimation_tpu_torch.models.midas import MidasNet
from efficientdepthestimation_tpu_torch.models.registry import build_model

from test_torch_midas import (
    INPUT_HW,
    TOL,
    _check_taps,
    _inputs,
    _load,
    random_variables,
)
from torch_tmp_cleanup import delete_tmp_path  # noqa: F401  (autouse)

MIDAS_SIZES = dict(output_size=(32, 48), input_size=INPUT_HW)
FULL_HW = (228, 304)


def jax_taps_and_out(jm, variables, x: np.ndarray) -> tuple:
    """A JAX model's encoder taps and output in one compile: the taps are
    the captured output of its ``E`` (Hu2018) or ``encoder`` (MiDaS)."""
    name = "encoder" if hasattr(jm, "encoder_block_channels") else "E"
    out, state = jax.jit(lambda v, x: jm.apply(
        v, x, capture_intermediates=lambda m, _: m.name == name))(
            variables, jnp.asarray(x))
    (taps,) = state["intermediates"][name]["__call__"]
    return taps, np.asarray(out)


def check_model(jm, model, seed: int) -> None:
    """``model`` loaded with ``jm``'s seeded random variables gives its
    taps and output on 64×96 inputs."""
    variables = random_variables(jm, jnp.zeros((1, *INPUT_HW, 3)), False,
                                 seed=seed)
    model = _load(model, variables)
    x = _inputs((2, *INPUT_HW, 3), seed=seed + 1)
    ref_taps, ref = jax_taps_and_out(jm, variables, x)
    encoder = model.encoder if isinstance(model, MidasNet) else model.E
    with torch.inference_mode():
        taps = encoder(torch.from_numpy(x))
        out = model(torch.from_numpy(x)).numpy()
    _check_taps(taps, ref_taps)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)


@functools.lru_cache(maxsize=None)
def jax_shapes(encoder: str, decoder: str):
    """(JAX model, ``jax.eval_shape`` of its init) at full width, 228×304."""
    jm = jax_build_model(encoder, decoder)
    return jm, jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *FULL_HW, 3)),
        False))


def check_jax_variables(encoder: str, decoder: str) -> None:
    """The port's model has the JAX model's variables: every key and shape,
    loading strictly."""
    _, shapes = jax_shapes(encoder, decoder)
    state = from_jax_variables(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes))
    model = build_model(encoder, decoder)
    ours = model.state_dict()
    assert sorted(state) == sorted(ours)
    for key, value in state.items():
        assert tuple(value.shape) == tuple(ours[key].shape), key
    model.load_state_dict(state, strict=True)
    assert isinstance(model, HuDepthModel if decoder == "hu2018"
                      else MidasNet)


def check_key_rule(encoder: str, decoder: str) -> None:
    """The port → JAX name rule over every leaf: ``to_jax_leaf`` gives the
    JAX path, and ``reference_key`` the JAX package's ``_torch_key``."""
    jm, shapes = jax_shapes(encoder, decoder)
    want = {}
    for collection, tree in shapes.items():
        for path, _ in jpth._iter_leaf_paths(tree):
            want[collection, "/".join(path)] = jpth._torch_key(
                path, collection, jm)
    model = build_model(encoder, decoder)
    translate = pth_import._encoder_translator(model)
    got = set()
    for key, value in model.state_dict().items():
        collection, path, _ = to_jax_leaf(key, value)
        assert (collection, path) in want, key
        assert pth_import.reference_key(key, translate) == \
            want[collection, path], key
        got.add((collection, path))
    assert got == set(want)


@pytest.mark.parametrize("variant", sorted(DENSENET_CONFIGS))
def test_densenet_encoder_has_the_jax_variables(variant):
    assert densenet_block_channels(variant) == \
        jax_densenet_block_channels(variant)
    shapes = jax.eval_shape(lambda: JaxDenseNetFeatures(variant).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *INPUT_HW, 3))))
    state = from_jax_variables(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    encoder = DenseNetFeatures(variant)
    assert sorted(state) == sorted(encoder.state_dict())
    encoder.load_state_dict(state, strict=True)


def test_densenet161_block_channels():
    """DN161's taps; D's first 1×1 takes 2208 to 1104, as the reference's
    ``E_densenet`` under ``D(num_features=2208)`` (modules.py:78-105)."""
    assert densenet_block_channels("densenet161") == [192, 384, 1056, 2208]
    model = build_model("densenet161")
    assert model.num_features == 2208
    assert tuple(model.D.conv.weight.shape) == (1104, 2208, 1, 1)
    assert tuple(model.MFF.up4.conv1.weight.shape) == (16, 2208, 5, 5)
    assert tuple(model.R.conv0.weight.shape) == (133, 133, 5, 5)


@pytest.mark.parametrize("decoder", ["hu2018", "lasinger2019"])
def test_dn161_taps_and_output_match_jax(decoder):
    """Full depth and width: the taps after each transition's conv (before
    its pool) and after relu(norm5), and the depth."""
    kw = MIDAS_SIZES if decoder == "lasinger2019" else {}
    check_model(jax_build_model("densenet161", decoder, **kw),
                build_model("densenet161", decoder, **kw), seed=21)


@pytest.mark.parametrize("decoder", ["hu2018", "lasinger2019"])
def test_dn161_has_the_jax_variables(decoder):
    check_jax_variables("densenet161", decoder)


@pytest.mark.parametrize("decoder", ["hu2018", "lasinger2019"])
def test_dn161_key_rule_matches_jax(decoder):
    check_key_rule("densenet161", decoder)


def test_dn161_pth_forward_matches_jax_import(tmp_path):
    """DN161-HU written as the reference released it (``module.``-prefixed
    raw ``state_dict``, the old torchvision ``norm.1`` keys) loads through
    ``load_any_checkpoint`` and forwards as JAX's ``import_pth``."""
    jm = jax_build_model("densenet161", "hu2018")
    variables = random_variables(jm, jnp.zeros((1, *INPUT_HW, 3)), False,
                                 seed=23)
    source = _load(build_model("densenet161"), variables)
    path = str(tmp_path / "DN161-HU.pth")
    torch.save({f"module.{k}": v for k, v in
                pth_import.reference_state_dict(source).items()}, path)
    assert any(".norm.1." in k for k in torch.load(path))
    model = load_any_checkpoint(path, device="cpu")
    for key, value in source.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key
    ref_model, ref_vars = jpth.import_pth(path, example_input_hw=INPUT_HW)
    x = _inputs((2, *INPUT_HW, 3), seed=24)
    ref = np.asarray(jax.jit(ref_model.apply)(ref_vars, jnp.asarray(x)))
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_dn161_ede_from_jax_loads_and_forwards(tmp_path):
    """A ``hu2018-state`` ``.ede`` that JAX's ``save_checkpoint`` wrote
    loads through ``load_checkpoint`` and ``load_any_checkpoint`` with
    JAX's every value, and forwards as JAX's ``load_checkpoint`` model."""
    jm = jax_build_model("densenet161", "hu2018")
    variables = random_variables(jm, jnp.zeros((1, *INPUT_HW, 3)), False,
                                 seed=25)
    path = str(tmp_path / "dn161.ede")
    jserialization.save_checkpoint(path, variables, encoder="densenet161",
                                   decoder="hu2018")
    model, header = load_checkpoint(path)
    assert header["encoder"] == "densenet161"
    want = from_jax_variables(variables)
    for key, value in model.state_dict().items():
        assert torch.equal(value, want[key]), key
    model = load_any_checkpoint(path, device="cpu")
    ref_model, ref_vars, _ = jserialization.load_checkpoint(path)
    x = _inputs((2, *INPUT_HW, 3), seed=26)
    ref = np.asarray(jax.jit(ref_model.apply)(ref_vars, jnp.asarray(x)))
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
