"""The port's ``.ede`` writers against the JAX package's readers, and back,
and a train state resumed across the two packages, on the CPU.

Every format the port writes (``hu2018-state``, ``midas-self-describing``,
``train-state`` with and without a frozen encoder, ``discriminator``) loads
in the JAX package with every leaf bit for bit, and every file the JAX
package writes loads in the port bit for bit. The train state's optimizer
is optax's state-dict layout; the resume tests take one step in one package
and the next in the other (f32, preprocessed inputs, 64×96, ENB0-HU with
drop-connect off), held to ``tests/test_torch_train_step.py``'s tolerances, the
gradients and Adam's first moments as
``test_torch_train_families.check_gradients`` holds random-weight
gradients.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from flax import serialization as flax_serialization

from efficientdepthestimation_tpu.apps.common import (
    load_any_checkpoint as jax_load_any_checkpoint,
)
from efficientdepthestimation_tpu.checkpoints import (
    serialization as jserialization,
)
from efficientdepthestimation_tpu.models import midas as jax_midas
from efficientdepthestimation_tpu.models.efficientnet import (
    EfficientNetFeatures as JaxEfficientNetFeatures,
)
from efficientdepthestimation_tpu.models.registry import (
    build_model as jax_build_model,
)
from efficientdepthestimation_tpu.training import train_step as jstep

from efficientdepthestimation_tpu_torch.checkpoints import serialization
from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    to_jax_variables,
)
from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
    render_scene,
)
from efficientdepthestimation_tpu_torch.data.transforms import (
    normalize_imagenet,
)
from efficientdepthestimation_tpu_torch.models.common import randomize_
from efficientdepthestimation_tpu_torch.models.efficientnet import (
    EfficientNetFeatures,
    efficientnet_block_channels,
)
from efficientdepthestimation_tpu_torch.models.midas import Discriminator
from efficientdepthestimation_tpu_torch.models.registry import build_model
from efficientdepthestimation_tpu_torch.training import train_step as pstep

from test_torch_midas import TOL, random_variables
from test_torch_train_families import check_gradients, models
from test_torch_train_step import GRAD_REL, STAT_TOL, STEP_RTOL

INPUT_HW = (64, 96)
LR = WEIGHT_DECAY = 1e-4
STEPS_PER_EPOCH = 3
LR_CHECKPOINT = "e2e/ENB0-LR-synthetic.ede"
HU_CHECKPOINT = "e2e/ENB0-HU-synthetic.ede"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}"
        if isinstance(value, dict):
            out.update(_flat(value, name))
        else:
            out[name] = np.asarray(value)
    return out


def _assert_trees_equal(ours, ref):
    """Same leaves, same dtypes, same bits."""
    ours, ref = _flat(ours), _flat(ref)
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        assert ours[key].dtype == value.dtype, key
        np.testing.assert_array_equal(ours[key], value, err_msg=key)


def _port_model(encoder: str, decoder: str, seed: int = 3):
    kw = ({} if decoder == "hu2018"
          else dict(output_size=(32, 48), input_size=INPUT_HW))
    return randomize_(build_model(encoder, decoder, **kw), seed)


def _jax_model(encoder: str, decoder: str):
    kw = ({} if decoder == "hu2018"
          else dict(output_size=(32, 48), input_size=INPUT_HW))
    return jax_build_model(encoder, decoder, **kw)


def _variables(model) -> dict:
    return to_jax_variables(model.state_dict())


def _port_state(model, frozen=()):
    return pstep.create_train_state(
        model, pstep.step_lr(LR, STEPS_PER_EPOCH, step_size=1),
        WEIGHT_DECAY, frozen_prefixes=frozen)


def _jax_state(jm, variables, frozen=()):
    tx = jstep.adam_with_l2(
        jstep.step_lr(LR, STEPS_PER_EPOCH, step_size=1), WEIGHT_DECAY,
        frozen_prefixes=frozen)
    return jstep.create_train_state(jm, variables, tx)


def _port_random_updates(state, n: int, seed: int):
    """``n`` Adam updates of ``state`` with seeded random gradients."""
    gen = torch.Generator().manual_seed(seed)
    for _ in range(n):
        for p in state.model.parameters():
            p.grad = (torch.randn(p.shape, generator=gen)
                      if p.requires_grad else None)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
    return state


def _jax_random_updates(state, n: int, seed: int):
    rng = np.random.default_rng(seed)
    update = jax.jit(lambda s, g: s.apply_gradients(g, s.batch_stats))
    for _ in range(n):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape, np.float32), state.params)
        state = update(state, grads)
    return state


def _batch(seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((2, *INPUT_HW, 3), np.float32),
            "depth": rng.uniform(1, 9, (2, 32, 48, 1)).astype(np.float32)}


# --- model files ------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["hu2018-state", "midas-self-describing",
                                 "discriminator"])
def test_port_writes_jax_reads(fmt, tmp_path):
    path = str(tmp_path / "model.ede")
    if fmt == "discriminator":
        model = randomize_(Discriminator(), 4)
        serialization.save_discriminator(path, model)
        jm, variables = jserialization.load_discriminator(path)
        assert (jm.in_channels, jm.adversarial_training) == (4, False)
    elif fmt == "hu2018-state":
        model = _port_model("resnet18", "hu2018")
        serialization.save_checkpoint(path, model, encoder="resnet18",
                                      decoder="hu2018")
        _, variables, header = jserialization.load_checkpoint(path)
        assert header["format"] == fmt and header["encoder"] == "resnet18"
    else:
        model = _port_model("resnet18", "lasinger2019")
        serialization.save_midas(path, model)
        jm, variables = jserialization.load_midas(path)
        assert jm.output_size == (32, 48) and jm.input_size == INPUT_HW
    _assert_trees_equal(variables, _variables(model))


@pytest.mark.parametrize("fmt", ["hu2018-state", "midas-self-describing",
                                 "discriminator"])
def test_jax_writes_port_reads(fmt, tmp_path):
    path = str(tmp_path / "model.ede")
    if fmt == "discriminator":
        jm = jax_midas.Discriminator(in_channels=4)
        variables = random_variables(jm, jnp.zeros((1, 40, 48, 4)), False,
                                     seed=8)
        jserialization.save_discriminator(path, jm, variables)
        model, header = serialization.load_discriminator(path)
        assert model.in_channels == 4
    elif fmt == "hu2018-state":
        jm = _jax_model("resnet18", "hu2018")
        variables = random_variables(jm, jnp.zeros((1, *INPUT_HW, 3)), False,
                                     seed=9)
        jserialization.save_checkpoint(path, variables, encoder="resnet18",
                                       decoder="hu2018")
        model, header = serialization.load_checkpoint(path)
    else:
        jm = _jax_model("resnet18", "lasinger2019")
        variables = random_variables(jm, jnp.zeros((1, *INPUT_HW, 3)), False,
                                     seed=10)
        jserialization.save_midas(path, jm, variables)
        model, header = serialization.load_midas(path)
        assert model.output_size == (32, 48)
        assert model.input_size == INPUT_HW
    assert header["format"] == fmt
    _assert_trees_equal(_variables(model), variables)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_discriminator_adversarial_training_round_trip(writer, tmp_path):
    """``adversarial_training: true`` survives a file written by either
    package and read by both, with the weights unchanged."""
    path = str(tmp_path / "disc.ede")
    if writer == "jax":
        jm = jax_midas.Discriminator(in_channels=4, adversarial_training=True)
        variables = random_variables(jm, jnp.zeros((1, 40, 48, 4)), False,
                                     seed=8)
        jserialization.save_discriminator(path, jm, variables)
    else:
        model = randomize_(Discriminator(adversarial_training=True), 4)
        serialization.save_discriminator(path, model)
        variables = _variables(model)
    model, header = serialization.load_discriminator(path)
    jm, jvariables = jserialization.load_discriminator(path)
    assert header["options"]["adversarial_training"] is True
    assert model.adversarial_training is True
    assert jm.adversarial_training is True
    assert model.in_channels == jm.in_channels == 4
    _assert_trees_equal(_variables(model), variables)
    _assert_trees_equal(jvariables, variables)


@pytest.mark.parametrize("source", ["ENB0-LR", "resnet18"])
def test_save_midas_header_matches_jax(source, tmp_path):
    """The self-describing header, field for field, of ENB0-LR (from its
    ``.ede``) and of a ResNet-18 MidasNet, as both packages write it."""
    if source == "ENB0-LR":
        model, _ = serialization.load_midas(LR_CHECKPOINT)
        jm, variables = jserialization.load_midas(LR_CHECKPOINT)
    else:
        model = _port_model("resnet18", "lasinger2019")
        jm, variables = _jax_model("resnet18", "lasinger2019"), _variables(
            model)
    ours, ref = str(tmp_path / "ours.ede"), str(tmp_path / "ref.ede")
    serialization.save_midas(ours, model)
    jserialization.save_midas(ref, jm, variables)
    header, tree = serialization.read_ede(ours)
    ref_header, ref_tree = serialization.read_ede(ref)
    assert header == ref_header
    _assert_trees_equal(tree, ref_tree)


def test_port_checkpoint_serves_in_jax(tmp_path):
    """A ``hu2018-state`` file the port writes serves through the JAX
    package's ``load_any_checkpoint`` to the port's own output."""
    model = _port_model("resnet18", "hu2018").eval()
    path = str(tmp_path / "RN18-HU.ede")
    serialization.save_checkpoint(path, model, encoder="resnet18",
                                  decoder="hu2018")
    jm, variables = jax_load_any_checkpoint(path)
    x = np.random.default_rng(11).standard_normal((2, *INPUT_HW, 3),
                                                  np.float32)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


# --- train states -----------------------------------------------------------


def _jax_opt_leaves(opt_state) -> dict:
    return _flat(flax_serialization.to_state_dict(opt_state))


def _moments(state, key: str) -> dict:
    """The port's Adam moments ``exp_avg``/``exp_avg_sq`` in the JAX
    layout."""
    return to_jax_variables(
        {n: state.optimizer.state[p][key]
         for n, p in state.model.named_parameters() if p.requires_grad}
    )["params"]


@pytest.mark.parametrize("frozen", [(), ("E",)])
def test_port_train_state_loads_in_jax(frozen, tmp_path):
    model = _port_model("resnet18", "hu2018")
    state = _port_random_updates(_port_state(model, frozen), 2, seed=1)
    path = str(tmp_path / "train_state.ede")
    serialization.save_train_state(path, state, encoder="resnet18",
                                   decoder="hu2018", epoch=1, step_in_epoch=2)
    jm = _jax_model("resnet18", "hu2018")
    fresh = _jax_state(jm, _variables(_port_model("resnet18", "hu2018", 7)),
                       frozen)
    restored, header = jserialization.load_train_state(path, fresh)
    assert (header["epoch"], header["step"], header["step_in_epoch"]) == (
        1, 2, 2)
    assert int(restored.step) == 2
    ours = _variables(model)
    _assert_trees_equal({"params": restored.params,
                         "batch_stats": restored.batch_stats}, ours)
    leaves = _jax_opt_leaves(restored.opt_state)
    prefix = "/inner_states/trained/inner_state" if frozen else ""
    assert int(leaves[f"{prefix}/1/0/count"]) == 2
    assert int(leaves[f"{prefix}/1/1/count"]) == 2
    for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        got = {k[len(f"{prefix}/1/0/{key}"):]: v for k, v in leaves.items()
               if k.startswith(f"{prefix}/1/0/{key}/")}
        _assert_trees_equal({"": got}, {"": _flat(_moments(state,
                                                            torch_key))})
        if frozen:  # optax keeps the frozen key, with no moments under it
            assert "E" not in {k.split("/")[1] for k in got}
    # the update optax would take next is the one torch's Adam takes
    assert float(jstep.step_lr(LR, STEPS_PER_EPOCH, 1)(2)) == pytest.approx(
        state.optimizer.param_groups[0]["lr"], rel=1e-12)


@pytest.mark.parametrize("frozen", [(), ("E",)])
def test_jax_train_state_loads_in_port(frozen, tmp_path):
    source = _port_model("resnet18", "hu2018", 5)
    jm = _jax_model("resnet18", "hu2018")
    jstate = _jax_random_updates(_jax_state(jm, _variables(source), frozen),
                                 4, seed=2)
    path = str(tmp_path / "train_state.ede")
    jserialization.save_train_state(path, jstate, encoder="resnet18",
                                    decoder="hu2018", epoch=1)
    state = _port_state(_port_model("resnet18", "hu2018", 6), frozen)
    state, header = serialization.load_train_state(path, state)
    assert state.step == 4 and "step_in_epoch" not in header
    _assert_trees_equal(_variables(state.model),
                        {"params": jax.device_get(jstate.params),
                         "batch_stats": jax.device_get(jstate.batch_stats)})
    leaves = _jax_opt_leaves(jax.device_get(jstate.opt_state))
    prefix = "/inner_states/trained/inner_state" if frozen else ""
    for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        ref = {k[len(f"{prefix}/1/0/{key}"):]: v for k, v in leaves.items()
               if k.startswith(f"{prefix}/1/0/{key}/")}
        _assert_trees_equal({"": _flat(_moments(state, torch_key))},
                            {"": ref})
    for n, p in state.model.named_parameters():
        assert p.requires_grad == (n.split(".")[0] not in frozen)
        if p.requires_grad:
            assert float(state.optimizer.state[p]["step"]) == 4.0
    # 4 updates at 3 an epoch, step_size 1: the LR dropped once
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(LR * 0.1)
    assert state.scheduler.last_epoch == 4


def test_train_state_layout_mismatch_raises(tmp_path):
    state = _port_random_updates(
        _port_state(_port_model("resnet18", "hu2018")), 1, seed=3)
    path = str(tmp_path / "train_state.ede")
    serialization.save_train_state(path, state, encoder="resnet18",
                                   decoder="hu2018", epoch=0)
    with pytest.raises(ValueError, match="frozen"):
        serialization.load_train_state(
            path, _port_state(_port_model("resnet18", "hu2018"), ("E",)))
    with pytest.raises(ValueError, match="train-state"):
        serialization.load_train_state(LR_CHECKPOINT, state)
    model, header = serialization.load_checkpoint(path)
    assert header["format"] == "train-state"
    _assert_trees_equal(_variables(model), _variables(state.model))


# --- resuming across packages -----------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_fns():
    return (jstep.make_train_step(preprocess=False, donate=False),
            jstep.make_grad_snapshot(preprocess=False))


def _jax_next_step(jstate, batch):
    """(metrics, gradients, state after) of JAX's next f32 step."""
    train, snapshot = _jax_fns()
    fed = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    grads = jax.device_get(snapshot(jstate, fed, key))
    new, metrics = train(jstate, fed, key)
    return ({k: float(v) for k, v in metrics.items()}, grads,
            jax.device_get(new))


def _port_next_step(state, batch):
    step = pstep.make_train_step(preprocess=False, device="cpu")
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, 0)
    grads = to_jax_variables({n: p.grad for n, p in
                              state.model.named_parameters()})["params"]
    return {k: float(v) for k, v in metrics.items()}, grads, state


def _check_next_steps(port, jax_):
    (metrics, grads, state), (ref_metrics, ref_grads, ref_state) = port, jax_
    assert state.step == int(ref_state.step)
    for name, value in ref_metrics.items():
        np.testing.assert_allclose(metrics[name], value, rtol=STEP_RTOL,
                                   err_msg=name)
    check_gradients(grads, ref_grads)
    stats = _flat(_variables(state.model)["batch_stats"])
    for key, value in _flat(ref_state.batch_stats).items():
        np.testing.assert_allclose(stats[key], value, **STAT_TOL,
                                   err_msg=key)
    # the first moments carry the step before (0.9 of them): a wrong
    # layout or count shows here
    leaves = _jax_opt_leaves(ref_state.opt_state)
    check_gradients(_moments(state, "exp_avg"),
                    {k[len("/1/0/mu/"):]: v for k, v in leaves.items()
                     if k.startswith("/1/0/mu/")})
    assert int(_jax_opt_leaves(ref_state.opt_state)["/1/1/count"]) == 2


def _scenes(seeds) -> dict:
    """``render_scene`` frames at 64×96, ImageNet-normalized, and their
    depths averaged to the model's 32×48 output."""
    scenes = [render_scene(s, INPUT_HW) for s in seeds]
    images = normalize_imagenet(
        torch.from_numpy(np.stack([s[0] for s in scenes])).float() / 255)
    depths = F.avg_pool2d(torch.from_numpy(np.stack([s[1] for s in scenes])
                                           )[:, None], 2)
    return {"image": images.numpy(),
            "depth": depths.permute(0, 2, 3, 1).contiguous().numpy()}


def _enb0_hu():
    """ENB0-HU with drop-connect off in both packages, the port's with the
    weights of ``e2e/ENB0-HU-synthetic.ede``."""
    variant = "efficientnet-b0"
    model, jm = models(
        EfficientNetFeatures(variant, drop_connect_rate=0.0),
        efficientnet_block_channels(variant),
        functools.partial(JaxEfficientNetFeatures, variant=variant,
                          drop_connect_rate=0.0), "hu2018")
    trained, _ = serialization.load_checkpoint(HU_CHECKPOINT)
    model.load_state_dict(trained.state_dict())
    return model, jm


@pytest.mark.parametrize("direction", ["port_then_jax", "jax_then_port"])
def test_resume_across_packages(direction, tmp_path):
    """One f32 step of ENB0-HU in one package, saved; the next step in the
    other, against the next step in the first. (ENB0-HU's trained weights
    and rendered scenes: a one-ulp change of these images moves the
    gradient by 8.8e-4 of its norm, ``test_torch_train_families``'s
    printout; a random-weight ResNet-18 HU at this size proved too
    ill-conditioned in f32 to hold to GRAD_REL after a step.)"""
    first, second = _scenes((0, 1)), _scenes((2, 3))
    model, jm = _enb0_hu()
    path = str(tmp_path / "train_state.ede")
    kw = dict(encoder="efficientnet-b0", decoder="hu2018", epoch=0,
              step_in_epoch=1)
    if direction == "port_then_jax":
        state = _port_state(model)
        _, _, state = _port_next_step(state, first)
        serialization.save_train_state(path, state, **kw)
        jstate, _ = jserialization.load_train_state(
            path, _jax_state(jm, _variables(randomize_(_enb0_hu()[0], 13))))
    else:
        jstate = _jax_state(jm, _variables(model))
        _, _, jstate = _jax_next_step(jstate, first)
        jserialization.save_train_state(path, jstate, **kw)
        state, _ = serialization.load_train_state(
            path, _port_state(randomize_(_enb0_hu()[0], 13)))
    _check_next_steps(_port_next_step(state, second),
                      _jax_next_step(jstate, second))
