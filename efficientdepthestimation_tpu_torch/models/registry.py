"""Model factory: the encoder × decoder registry and ``{ENC}-{DEC}``
checkpoint-name parsing.

Counterpart of ``efficientdepthestimation_tpu/models/registry.py`` (the
reference's ``define_model``, ReSIDE/train.py:20-38, and the MiDaS assembly,
train.py:86-91). Every encoder of the JAX registry builds under either
decoder: ResNet, EfficientNet, DenseNet-161, SENet-154 and the rest of the
vendored Cadene zoo (ReSIDE/models/senet.py:398-453), which no reference
entry point instantiates (train.py:26-33).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Callable

from torch import nn

from efficientdepthestimation_tpu_torch.models.densenet import (
    DenseNetFeatures,
    densenet_block_channels,
)
from efficientdepthestimation_tpu_torch.models.efficientnet import (
    EFFICIENTNET_PARAMS,
    EfficientNetFeatures,
    efficientnet_block_channels,
)
from efficientdepthestimation_tpu_torch.models.hu2018 import HuDepthModel
from efficientdepthestimation_tpu_torch.models.midas import MidasNet
from efficientdepthestimation_tpu_torch.models.resnet import (
    RESNET_LAYERS,
    ResNetFeatures,
    resnet_block_channels,
)
from efficientdepthestimation_tpu_torch.models.senet import (
    SENET_CONFIGS,
    SENetFeatures,
    senet_block_channels,
)

__all__ = ["ENCODER_SPECS", "EncoderSpec", "build_model", "define_model",
           "encoder_spec", "model_from_checkpoint_name",
           "parse_checkpoint_name"]


@dataclass(frozen=True)
class EncoderSpec:
    name: str
    factory: Callable[[], nn.Module]
    block_channels: tuple[int, ...]

    @property
    def num_features(self) -> int:
        return self.block_channels[-1]


def _specs() -> dict[str, EncoderSpec]:
    specs = {}
    for name in RESNET_LAYERS:
        specs[name] = EncoderSpec(
            name, functools.partial(ResNetFeatures, variant=name),
            tuple(resnet_block_channels(name)))
    for name in EFFICIENTNET_PARAMS:
        specs[name] = EncoderSpec(
            name, functools.partial(EfficientNetFeatures, variant=name),
            tuple(efficientnet_block_channels(name)))
    specs["densenet"] = specs["densenet161"] = EncoderSpec(
        "densenet161", functools.partial(DenseNetFeatures,
                                         variant="densenet161"),
        tuple(densenet_block_channels("densenet161")))
    for name in SENET_CONFIGS:
        specs[name] = EncoderSpec(
            name, functools.partial(SENetFeatures, variant=name),
            tuple(senet_block_channels(name)))
    specs["senet"] = specs["senet154"]
    return specs


ENCODER_SPECS = _specs()


def encoder_spec(name: str) -> EncoderSpec:
    key = name.lower()
    if key in ENCODER_SPECS:
        return ENCODER_SPECS[key]
    raise ValueError(f"Unknown encoder '{name}'")


def build_model(encoder_name: str, decoder_name: str = "hu2018", *,
                output_size: tuple[int, int] = (114, 152),
                input_size: tuple[int, int] | None = (228, 304),
                num_features: int | str = "auto",
                non_negative: bool = False) -> nn.Module:
    """An encoder×decoder depth model in eval mode, with random weights.

    ``decoder_name`` ∈ {"hu2018", "lasinger2019"}; sizes are HW and apply to
    the MiDaS decoder only, as in the JAX package.
    """
    decoder = decoder_name.lower()
    if decoder not in ("hu2018", "lasinger2019", "midas", "ranftl2019"):
        raise ValueError(f"Unknown decoder '{decoder_name}'")
    spec = encoder_spec(encoder_name)
    if decoder == "hu2018":
        model = HuDepthModel(spec.factory(), num_features=spec.num_features,
                             block_channel=spec.block_channels)
    else:
        model = MidasNet(spec.factory(), spec.block_channels,
                         output_size=output_size, input_size=input_size,
                         num_features=num_features, non_negative=non_negative)
    return model.eval()


def define_model(is_resnet: bool = False, is_densenet: bool = False,
                 is_senet: bool = False, is_efficientnet: bool = False,
                 efficientnet_variant: str = "efficientnet-b0") -> nn.Module:
    """Flag-for-flag port of the reference factory (ReSIDE/train.py:20-38)."""
    if is_resnet:
        return build_model("resnet50", "hu2018")
    if is_densenet:
        return build_model("densenet161", "hu2018")
    if is_senet:
        return build_model("senet154", "hu2018")
    if is_efficientnet:
        return build_model(efficientnet_variant, "hu2018")
    raise ValueError("No encoder selected")


# The released checkpoints follow '{ENC}-{DEC}.pth' with these tokens
# (reference inference_benchmark.py:117-125).
_DECODER_TOKENS = {
    "HU": "hu2018", "hu2018": "hu2018",
    "LR": "lasinger2019", "lasinger2019": "lasinger2019",
}
_ENCODER_TOKENS = {
    "ENB0": "efficientnet-b0", "ENB4": "efficientnet-b4", "RN50": "resnet50",
    "ENB1": "efficientnet-b1", "ENB2": "efficientnet-b2",
    "ENB3": "efficientnet-b3", "ENB5": "efficientnet-b5",
    "ENB6": "efficientnet-b6", "ENB7": "efficientnet-b7",
    "RN18": "resnet18", "RN101": "resnet101", "RN152": "resnet152",
    "DN161": "densenet161", "SN154": "senet154",
}


def parse_checkpoint_name(filename: str) -> tuple[str, str]:
    """'ENB0-HU.pth' → ('efficientnet-b0', 'hu2018'); also the 3-part
    'efficientnet-b0-hu2018.pth' form (inference_benchmark.py:120-125)."""
    stem = os.path.splitext(os.path.basename(filename))[0]
    enc_tok, _, dec_tok = stem.rpartition("-")
    if not enc_tok:
        raise ValueError(f"Cannot parse model from checkpoint name '{filename}'")
    decoder = _DECODER_TOKENS.get(dec_tok, _DECODER_TOKENS.get(dec_tok.upper()))
    encoder = _ENCODER_TOKENS.get(enc_tok, _ENCODER_TOKENS.get(enc_tok.upper()))
    if encoder is None and enc_tok.lower() in ENCODER_SPECS:
        encoder = ENCODER_SPECS[enc_tok.lower()].name
    if encoder is None or decoder is None:
        raise ValueError(f"Cannot parse model from checkpoint name '{filename}'")
    return encoder, decoder


def model_from_checkpoint_name(filename: str, **kwargs) -> nn.Module:
    encoder, decoder = parse_checkpoint_name(filename)
    return build_model(encoder, decoder, **kwargs)
