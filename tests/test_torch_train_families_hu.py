"""One f32 training step of the Hu2018 decoder over ResNet-18, DenseNet-121
and SENet-154 cut to one block a stage, in the port against the JAX
package's step, on the CPU, as ``test_torch_train_families.py`` holds the
MidasNet family (its ``check_step``: the same weights and 64×96 batch, the
loss, metric sums, gradients and BN statistics; the two deepest encoders
within ``DEEP_GRAD_REL`` and ``DEEP_STAT_TOL``, whose comment gives the
reason)."""

import functools

import pytest

from efficientdepthestimation_tpu.models.densenet import (
    DenseNetFeatures as JaxDenseNetFeatures,
)
from efficientdepthestimation_tpu.models.resnet import (
    ResNetFeatures as JaxResNetFeatures,
)
from efficientdepthestimation_tpu.models.senet import (
    SENetFeatures as JaxSENetFeatures,
)

from efficientdepthestimation_tpu_torch.models.densenet import (
    DenseNetFeatures,
    densenet_block_channels,
)
from efficientdepthestimation_tpu_torch.models.resnet import (
    ResNetFeatures,
    resnet_block_channels,
)
from efficientdepthestimation_tpu_torch.models.senet import (
    SENetFeatures,
    senet_block_channels,
)

from test_torch_train_families import (  # noqa: F401
    DEEP_GRAD_REL,
    DEEP_STAT_TOL,
    _two_threads,
    check_step,
    models,
)

SENET_LAYERS = (1, 1, 1, 1)


@pytest.mark.parametrize("family", ["resnet18", "densenet121", "senet154"])
def test_hu2018_step_matches_jax(family):
    tol = {}
    if family == "resnet18":
        encoder, channels = ResNetFeatures(family), resnet_block_channels(
            family)
        factory = functools.partial(JaxResNetFeatures, variant=family)
    elif family == "densenet121":
        tol = dict(grad_rel=DEEP_GRAD_REL, stat_tol=DEEP_STAT_TOL)
        encoder = DenseNetFeatures(family)
        channels = densenet_block_channels(family)
        factory = functools.partial(JaxDenseNetFeatures, variant=family)
    else:
        tol = dict(grad_rel=DEEP_GRAD_REL, stat_tol=DEEP_STAT_TOL)
        encoder = SENetFeatures(family, layers=SENET_LAYERS)
        channels = senet_block_channels(family)
        factory = functools.partial(JaxSENetFeatures, variant=family,
                                    layers=SENET_LAYERS)
    check_step(*models(encoder, channels, factory, "hu2018"), seed=47,
               **tol)
