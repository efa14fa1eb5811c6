"""The port at full depth and width against the committed golden fixture,
on the CPU: each configuration of ``tests/full_size_configs.py`` (the six
released ones, SN154-HU with the released ``se_`` keys and DN161-HU with
the old torchvision ``norm.1`` keys), written by the torch mirror of the
reference as a ``.pth`` and read by the port's ``import_pth``, on the
fixture's 96×128 input. Its output against the fixture's ``:out`` and its
encoder taps against the fixture's samples of JAX's taps, at
``tests/test_parity_full_size.py``'s tolerances (rtol 1e-3, atol 1e-4).
Only the port and the torch mirror run, no JAX.
"""

import numpy as np
import pytest
import torch

from efficientdepthestimation_tpu_torch.checkpoints.pth_import import (
    import_pth,
)
from efficientdepthestimation_tpu_torch.models.midas import MidasNet
from efficientdepthestimation_tpu_torch.models.registry import build_model

from full_size_configs import CONFIGS
from make_golden_fixtures import FIXTURE_PATH, digest

TOL = dict(rtol=1e-3, atol=1e-4)
# The port's (encoder, decoder) of each configuration.
MODELS = {"ENB0-HU": ("efficientnet-b0", "hu2018"),
          "ENB4-HU": ("efficientnet-b4", "hu2018"),
          "RN50-HU": ("resnet50", "hu2018"),
          "SN154-HU": ("senet154", "hu2018"),
          "DN161-HU": ("densenet161", "hu2018"),
          "RN50-LR": ("resnet50", "lasinger2019"),
          "ENB0-LR": ("efficientnet-b0", "lasinger2019"),
          "ENB4-LR": ("efficientnet-b4", "lasinger2019")}


@pytest.fixture(scope="module")
def fixtures():
    return dict(np.load(FIXTURE_PATH))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_matches_golden_full_size(name, fixtures):
    _, buf, _, input_hw, _ = CONFIGS[name]()
    encoder, decoder = MODELS[name]
    # A Hu2018 .pth is a raw state_dict, built from the name; a MidasNet
    # describes itself, at the fixture's sizes.
    model = import_pth(buf, None if decoder != "hu2018"
                       else build_model(encoder, decoder))
    x = np.random.default_rng(0).standard_normal(
        (1, *input_hw, 3)).astype(np.float32)
    enc = model.encoder if isinstance(model, MidasNet) else model.E
    with torch.inference_mode():
        taps = enc(torch.from_numpy(x))
        out = model(torch.from_numpy(x)).numpy()[..., 0]
    assert len(taps) == 4
    for i, tap in enumerate(taps):
        np.testing.assert_allclose(
            digest(tap.numpy())["sample"], fixtures[f"{name}:tap{i}:sample"],
            **TOL, err_msg=f"{name}: tap {i}")
    np.testing.assert_allclose(out, fixtures[f"{name}:out"][:, 0], **TOL,
                               err_msg=f"{name}: output")
