"""The spatial-serving cases that ``_torch_spatial_runner.py`` serves on
several ranks and ``test_torch_spatial.py`` serves in one process: each
model from a committed ``.ede`` or a seed, and each serving option, on
inputs made from a seed."""

import functools
import os

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
    make_infer_fn,
)
from efficientdepthestimation_tpu_torch.models.common import randomize_
from efficientdepthestimation_tpu_torch.models.densenet import (
    DenseNetFeatures,
    densenet_block_channels,
)
from efficientdepthestimation_tpu_torch.models.hu2018 import HuDepthModel
from efficientdepthestimation_tpu_torch.models.registry import build_model
from efficientdepthestimation_tpu_torch.models.senet import (
    SENetFeatures,
    senet_block_channels,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDE = {"enb0_hu": os.path.join(ROOT, "e2e", "ENB0-HU-synthetic.ede"),
       "enb0_lr": os.path.join(ROOT, "e2e", "ENB0-LR-synthetic.ede")}
HU_INPUT = (1, 228, 304, 3)    # JAX's own spatial test (test_apps.py:362)
HU_UPSAMPLE = (480, 640)
SMALL_HW = (64, 96)
BATCH = 2  # any batch serves spatially; JAX's test serves 1

# case -> (model, serving options, input kind, upsample_to)
_CASES = {
    "enb0_lr": ("enb0_lr", {}, "small", None),
    "rn18_hu": ("rn18_hu", {}, "small", SMALL_HW),
    "dn121_hu": ("dn121_hu", {}, "small", None),
    "sn154_hu": ("sn154_hu", {}, "small", None),
    "rn18_hu/bf16": ("rn18_hu", {"dtype": torch.bfloat16}, "small", None),
    "rn18_hu/bake": ("rn18_hu", {"bake_weights": True}, "small", None),
    "rn18_hu/int8": ("rn18_hu", {"int8": True}, "small", None),
    # a quantized 1×1 conv: D's, of cin 2048
    "rn50_hu/int8": ("rn50_hu", {"int8": True}, "small", None),
    "enb0_hu/xla": ("enb0_hu", {"dw_impl": "xla"}, "small", None),
    "enb0_hu/shift": ("enb0_hu", {"dw_impl": "shift"}, "small", None),
    "rn18_hu/preprocess": ("rn18_hu", {"preprocess": True}, "frames",
                           (96, 128)),
}
CASES = tuple(_CASES)


@functools.lru_cache(maxsize=None)
def model(name: str) -> torch.nn.Module:
    """ENB0-HU and ENB0-LR from their ``.ede``; RN18-HU, DN121-HU, and
    RN50-HU and SENet-154 with one block a stage, under Hu2018 from
    seeds."""
    if name in EDE:
        return load_any_checkpoint(EDE[name], device="cpu")
    if name == "rn18_hu":
        return randomize_(build_model("resnet18", "hu2018"), 3)
    if name == "rn50_hu":
        model = build_model("resnet50", "hu2018")
        for i in range(1, 5):  # one bottleneck a stage
            stage = f"layer{i}"
            setattr(model.E, stage, getattr(model.E, stage)[:1])
        return randomize_(model, 6)
    if name == "dn121_hu":
        channels = densenet_block_channels("densenet121")
        return randomize_(HuDepthModel(DenseNetFeatures("densenet121"),
                                       channels[-1], channels).eval(), 4)
    channels = senet_block_channels("senet154")
    return randomize_(HuDepthModel(SENetFeatures("senet154", (1, 1, 1, 1)),
                                   channels[-1], channels).eval(), 5)


def hu_input() -> torch.Tensor:
    """JAX's spatial test input: standard normal at (1, 228, 304, 3)."""
    return torch.from_numpy(np.random.default_rng(3).standard_normal(
        HU_INPUT).astype(np.float32))


def _inputs(kind: str) -> torch.Tensor:
    rng = np.random.default_rng(7)
    if kind == "frames":
        return torch.from_numpy(rng.integers(0, 256, (BATCH, 96, 128, 3),
                                             dtype=np.uint8))
    return torch.from_numpy(rng.standard_normal(
        (BATCH, *SMALL_HW, 3)).astype(np.float32))


def serving_fn(case: str, mesh=None):
    """``(fn, inputs, height)``: ``case`` served by ``make_infer_fn``,
    spatially over ``mesh`` when given, its inputs and its output's
    height."""
    name, options, kind, upsample_to = _CASES[case]
    fn = make_infer_fn(model(name), upsample_to=upsample_to, device="cpu",
                       mesh=mesh, spatial=mesh is not None, **options)
    inputs = _inputs(kind)
    if upsample_to is not None:
        height = upsample_to[0]
    elif name == "enb0_lr":
        height = model(name).output_size[0]
    else:
        height = inputs.shape[1] // 2
    return fn, inputs, height
