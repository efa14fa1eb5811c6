"""Model factory and ``{ENC}-{DEC}`` checkpoint-name parsing.

Counterpart of ``efficientdepthestimation_tpu/models/registry.py``. This
slice of the port builds the EfficientNet-B0/B4 encoders with the Hu2018
decoder; the other encoders and the MiDaS decoder are ROADMAP item A7.
"""

from __future__ import annotations

import os

from torch import nn

from efficientdepthestimation_tpu_torch.models.efficientnet import (
    EfficientNetFeatures,
    efficientnet_block_channels,
)
from efficientdepthestimation_tpu_torch.models.hu2018 import HuDepthModel

__all__ = ["build_model", "parse_checkpoint_name"]

_PORTED_ENCODERS = ("efficientnet-b0", "efficientnet-b4")


def build_model(encoder_name: str, decoder_name: str = "hu2018") -> nn.Module:
    """An encoder×decoder depth model in eval mode, with random weights."""
    encoder = encoder_name.lower()
    decoder = decoder_name.lower()
    if decoder in ("lasinger2019", "midas", "ranftl2019"):
        raise NotImplementedError(
            "the MiDaS (lasinger2019) decoder is not ported yet (ROADMAP A7)")
    if decoder != "hu2018":
        raise ValueError(f"Unknown decoder '{decoder_name}'")
    if encoder not in _PORTED_ENCODERS:
        raise NotImplementedError(
            f"encoder '{encoder_name}' is not ported yet (ROADMAP A7); "
            f"ported: {', '.join(_PORTED_ENCODERS)}")
    block_channel = efficientnet_block_channels(encoder)
    return HuDepthModel(EfficientNetFeatures(encoder),
                        num_features=block_channel[-1],
                        block_channel=block_channel).eval()


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
# Full encoder names the 3-part 'efficientnet-b0-hu2018.pth' form may use,
# each with its canonical name (the JAX package's ENCODER_SPECS).
_ENCODER_NAMES = {name: name for name in (
    *_ENCODER_TOKENS.values(), "resnet34", "se_resnet50", "se_resnet101",
    "se_resnet152", "se_resnext50_32x4d", "se_resnext101_32x4d")}
_ENCODER_NAMES.update(densenet="densenet161", senet="senet154")


def parse_checkpoint_name(filename: str) -> tuple[str, str]:
    """'ENB0-HU.pth' → ('efficientnet-b0', 'hu2018'); also the 3-part
    'efficientnet-b0-hu2018.pth' form (inference_benchmark.py:120-125)."""
    stem = os.path.splitext(os.path.basename(filename))[0]
    enc_tok, _, dec_tok = stem.rpartition("-")
    if not enc_tok:
        raise ValueError(f"Cannot parse model from checkpoint name '{filename}'")
    decoder = _DECODER_TOKENS.get(dec_tok, _DECODER_TOKENS.get(dec_tok.upper()))
    encoder = _ENCODER_TOKENS.get(enc_tok, _ENCODER_TOKENS.get(enc_tok.upper()))
    if encoder is None:
        encoder = _ENCODER_NAMES.get(enc_tok.lower())
    if encoder is None or decoder is None:
        raise ValueError(f"Cannot parse model from checkpoint name '{filename}'")
    return encoder, decoder
