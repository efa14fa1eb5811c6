"""One f32 training step of each model family in the port against the JAX
package's step, on the CPU: the MidasNet decoder over EfficientNet-B0 and
ResNet-18 encoders (this file) and the Hu2018 decoder over ResNet-18,
DenseNet-121 and a cut SENet-154 (``test_torch_train_families_hu.py``).

Both packages start from the same seeded random weights
(``models.common.randomize_``, carried over by ``to_jax_variables``), take
one step on the same preprocessed 64×96 batch of two (``preprocess=False``,
drop-connect off, Adam 1e-4 with L2 1e-4), and are held to each other:

- the loss and the ``depth_metrics_batch`` sums, and the BN statistics
  after the step, to ``tests/test_torch_train_step.py``'s ``STEP_RTOL`` and
  ``STAT_TOL``;
- the gradients (the port's ``.grad`` against JAX's ``make_grad_snapshot``)
  by ``check_gradients``.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from efficientdepthestimation_tpu.models import hu2018 as jax_hu2018
from efficientdepthestimation_tpu.models import midas as jax_midas
from efficientdepthestimation_tpu.models.efficientnet import (
    EfficientNetFeatures as JaxEfficientNetFeatures,
)
from efficientdepthestimation_tpu.models.resnet import (
    ResNetFeatures as JaxResNetFeatures,
)
from efficientdepthestimation_tpu.training import train_step as jstep

from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    to_jax_variables,
)
from efficientdepthestimation_tpu_torch.models.common import randomize_
from efficientdepthestimation_tpu_torch.models.efficientnet import (
    EfficientNetFeatures,
    efficientnet_block_channels,
)
from efficientdepthestimation_tpu_torch.models.hu2018 import HuDepthModel
from efficientdepthestimation_tpu_torch.models.midas import MidasNet
from efficientdepthestimation_tpu_torch.models.resnet import (
    ResNetFeatures,
    resnet_block_channels,
)
from efficientdepthestimation_tpu_torch.training import train_step as pstep

from test_torch_train_step import GRAD_REL, STAT_TOL, STEP_RTOL

INPUT_HW = (64, 96)
OUTPUT_HW = (32, 48)
LR = WEIGHT_DECAY = 1e-4
# Gradients of random-weight models at 64x96 are ill-conditioned in f32:
# a one-ulp change of the input images moves the port's own f32 gradient
# by 1.6e-3 to 3.1e-3 of its norm for this file's models and ResNet-18 HU
# (``JAX_PLATFORMS=cpu PYTHONPATH=. python
# tests/test_torch_train_families.py`` prints these), and a leaf
# whose true gradient is near 0 (a BN shift that a following train-mode
# BN removes, EfficientNet's ``_bn2`` biases) is all rounding. So the
# gradient is held as a vector and by leaf norms: the
# whole difference within GRAD_REL of the model gradient's norm (measured
# 4.4e-3, 4.6e-3 for this file's two models), and each leaf's within the
# larger of LEAF_NORM_REL of its own norm and GRAD_REL of the model's
# norm per element of the leaf (measured at most 0.10 of that bound). A
# transposed, swapped or missing gradient moves a leaf by its whole norm.
LEAF_NORM_REL = 0.1
# The deepest encoders at this size are held looser: a one-ulp change of
# the input images alone moves the port's own gradient by 7.3e-3
# (DenseNet-121 HU) and 1.2e-2 (SENet-154 cut to a block a stage) of its
# norm, against 1.6e-3 to 3.1e-3 for the other three; the port against
# JAX measured 2.3e-2 and 1.3e-2, and one DenseNet-121 statistic at 1.01
# of STAT_TOL. For those two:
DEEP_GRAD_REL, DEEP_STAT_TOL = 5e-2, dict(rtol=1e-4, atol=1e-5)


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
            out[name] = np.asarray(value, np.float64)
    return out


def batch(seed: int = 17) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((2, *INPUT_HW, 3), np.float32),
            "depth": rng.uniform(1, 9, (2, *OUTPUT_HW, 1)).astype(
                np.float32)}


def models(encoder, channels, jax_factory, decoder: str) -> tuple:
    """(port model, JAX model) of an encoder under ``decoder``."""
    channels = tuple(channels)
    if decoder == "hu2018":
        return (HuDepthModel(encoder, channels[-1], channels),
                jax_hu2018.HuDepthModel(encoder_factory=jax_factory,
                                        num_features=channels[-1],
                                        block_channel=channels))
    sizes = dict(output_size=OUTPUT_HW, input_size=INPUT_HW)
    return (MidasNet(encoder, channels, **sizes),
            jax_midas.MidasNet(encoder_factory=jax_factory,
                               encoder_block_channels=channels, **sizes))


def check_gradients(grads: dict, ref: dict, rel: float = GRAD_REL) -> None:
    """Gradients (JAX-layout trees) as the comment on LEAF_NORM_REL says,
    with ``rel`` in place of GRAD_REL."""
    ours, ref = _flat(grads), _flat(ref)
    assert sorted(ours) == sorted(ref)
    total = np.sqrt(sum(np.square(v).sum() for v in ref.values()))
    count = sum(v.size for v in ref.values())
    diff = np.sqrt(sum(np.square(ours[k] - v).sum() for k, v in ref.items()))
    assert diff <= rel * total, (diff, total)
    for key, value in ref.items():
        err = np.linalg.norm(ours[key] - value)
        norm = np.linalg.norm(value)
        bound = max(LEAF_NORM_REL * norm,
                    rel * total * np.sqrt(value.size / count))
        assert err <= bound, (key, err, norm, bound)


def check_step(model, jm, seed: int, grad_rel: float = GRAD_REL,
               stat_tol: dict = STAT_TOL) -> None:
    """One f32 step of ``model`` (randomized with ``seed``) and of JAX's
    ``jm`` on the same weights and batch."""
    randomize_(model, seed)
    variables = to_jax_variables(model.state_dict())
    data = batch(seed + 1)

    state = pstep.create_train_state(model, LR, WEIGHT_DECAY)
    step = pstep.make_train_step(preprocess=False, device="cpu")
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in data.items()}, 0)
    grads = to_jax_variables({n: p.grad for n, p in
                              model.named_parameters()})["params"]

    jstate = jstep.create_train_state(jm, variables,
                                      jstep.adam_with_l2(LR, WEIGHT_DECAY))
    fed = {k: jnp.asarray(v) for k, v in data.items()}
    key = jax.random.PRNGKey(0)
    ref_grads = jstep.make_grad_snapshot(preprocess=False)(jstate, fed, key)
    new, ref_metrics = jstep.make_train_step(preprocess=False,
                                             donate=False)(jstate, fed, key)

    for name, value in ref_metrics.items():
        np.testing.assert_allclose(float(metrics[name]), float(value),
                                   rtol=STEP_RTOL, err_msg=name)
    check_gradients(grads, jax.device_get(ref_grads), grad_rel)
    stats = _flat(to_jax_variables(model.state_dict())["batch_stats"])
    for key, value in _flat(jax.device_get(new.batch_stats)).items():
        np.testing.assert_allclose(stats[key], value, **stat_tol,
                                   err_msg=key)


def test_efficientnet_midas_step_matches_jax():
    variant = "efficientnet-b0"
    check_step(*models(
        EfficientNetFeatures(variant, drop_connect_rate=0.0),
        efficientnet_block_channels(variant),
        functools.partial(JaxEfficientNetFeatures, variant=variant,
                          drop_connect_rate=0.0), "lasinger2019"), seed=41)


def test_resnet_midas_step_matches_jax():
    check_step(*models(
        ResNetFeatures("resnet18"), resnet_block_channels("resnet18"),
        functools.partial(JaxResNetFeatures, variant="resnet18"),
        "lasinger2019"), seed=43)


def one_ulp_sensitivity(model, data: dict) -> float:
    """How far the port's own f32 gradient of one step moves, relative to
    its norm, when the input images move by one ulp."""
    grads = []
    for factor in (1.0, 1.0 + 2.0 ** -23):
        fed = dict(data, image=(data["image"] * np.float32(factor)).astype(
            np.float32))
        copy = pstep.create_train_state(
            __import__("copy").deepcopy(model), LR, WEIGHT_DECAY)
        pstep.make_train_step(preprocess=False, device="cpu")(
            copy, {k: torch.from_numpy(v) for k, v in fed.items()}, 0)
        grads.append([p.grad.double() for p in copy.model.parameters()])
    diff = sum(float((a - b).square().sum()) for a, b in zip(*grads))
    norm = sum(float(a.square().sum()) for a in grads[0])
    return float(np.sqrt(diff / norm))


if __name__ == "__main__":
    # The sensitivities the tolerances above and test_torch_serialization
    # quote, at each test's weights and batch.
    from efficientdepthestimation_tpu_torch.models.densenet import (
        DenseNetFeatures,
        densenet_block_channels,
    )
    from efficientdepthestimation_tpu_torch.models.senet import (
        SENetFeatures,
        senet_block_channels,
    )
    from test_torch_serialization import _enb0_hu, _scenes

    variant = "efficientnet-b0"
    cases = {
        "ENB0-LR": (EfficientNetFeatures(variant, drop_connect_rate=0.0),
                    efficientnet_block_channels(variant), "lasinger2019",
                    41),
        "RN18-LR": (ResNetFeatures("resnet18"),
                    resnet_block_channels("resnet18"), "lasinger2019", 43),
        "RN18-HU": (ResNetFeatures("resnet18"),
                    resnet_block_channels("resnet18"), "hu2018", 47),
        "DN121-HU": (DenseNetFeatures("densenet121"),
                     densenet_block_channels("densenet121"), "hu2018", 47),
        "SN154(1,1,1,1)-HU": (SENetFeatures("senet154", layers=(1, 1, 1, 1)),
                              senet_block_channels("senet154"), "hu2018",
                              47)}
    for name, (encoder, channels, decoder, seed) in cases.items():
        model = models(encoder, channels, None, decoder)[0]
        print(name, one_ulp_sensitivity(randomize_(model, seed),
                                        batch(seed + 1)))
    print("ENB0-HU trained, scenes", one_ulp_sensitivity(
        _enb0_hu()[0], _scenes((0, 1))))
