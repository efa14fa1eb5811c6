"""The reference's ``.pth`` checkpoints, read into the port's models and
written from them.

Counterpart of ``efficientdepthestimation_tpu/checkpoints/pth_import.py``:

* both checkpoint formats: a raw ``state_dict`` (the Hu2018 models,
  ReSIDE/train.py:158) and MidasNet's self-describing dict {encoder,
  decoder, input_size, output_size, adversarial_training, weights,
  version} with sizes in WH order (lasinger2019.py:372-415);
* the DataParallel ``module.`` prefix, stripped anywhere in a key
  (inference_benchmark.py:141-147, reside_model.py:40), and the SENet
  ``se_`` → ``se_module.`` key vintages (reside_model.py:42-43).

The port's ``state_dict`` keys follow the JAX package's module paths
(``checkpoints/convert.py``), so the JAX package's key rule applies to them
as it stands: a key is the reference's except inside an encoder that the
reference wraps in ``nn.Sequential`` groups (the MiDaS ``Encoder``,
lasinger2019.py:76-120, and Hu's ``E_efficientnet``/``E_senet``,
modules.py:108-200), which the translators below re-index. Both store conv
kernels OIHW, a depthwise one ``(C, 1, k, k)``, so no value is transposed.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
from torch import nn

from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    _jax_modules,
)
from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
    check_midas_version,
    midas_model,
)
from efficientdepthestimation_tpu_torch.models.efficientnet import (
    EfficientNetFeatures,
    efficientnet_stage_splits,
)
from efficientdepthestimation_tpu_torch.models.midas import MidasNet
from efficientdepthestimation_tpu_torch.models.registry import (
    model_from_checkpoint_name,
)
from efficientdepthestimation_tpu_torch.models.resnet import ResNetFeatures
from efficientdepthestimation_tpu_torch.models.senet import SENetFeatures

__all__ = ["load_torch_state_dict", "reference_key", "reference_state_dict",
           "load_reference_state_dict", "import_pth"]


def load_torch_state_dict(path_or_file) -> Any:
    """The object a ``.pth`` file holds, its tensors on the CPU. Not
    ``weights_only``, as in the JAX package, so that every file it loads
    loads here: unpickling runs code, so load only trusted checkpoints."""
    return torch.load(path_or_file, map_location="cpu", weights_only=False)


def _fix_keys(state_dict: Mapping[str, Any], senet: bool = False
              ) -> dict[str, Any]:
    out = {}
    for key, value in state_dict.items():
        key = key.replace("module.", "")
        if senet:
            # reside_model.py:42-43: old checkpoints store 'se_fc1' style keys
            key = key.replace("se_", "se_module.")
            key = key.replace("se_module.module.", "se_module.")
        out[key] = value
    return out


# ---------------------------------------------------------------------------
# port key <-> reference key
# ---------------------------------------------------------------------------


def _identity_translator(parts: tuple[str, ...]) -> str:
    return ".".join(parts)


def _efficientnet_blocks_translator(variant: str, prefix: str) -> Callable:
    """Reference keys of an EfficientNet encoder wrapped in Sequential
    blocks: blocks.0 = Sequential(_conv_stem@0, _bn0@1, MBConv@2..) and
    blocks.g = Sequential(MBConv@0..) for g ≥ 1 (modules.py:185-196,
    lasinger2019.py:76-88)."""
    splits = efficientnet_stage_splits(variant)

    def translate(parts: tuple[str, ...]) -> str:
        head, rest = parts[0], parts[1:]
        if head == "_conv_stem":
            return ".".join((f"{prefix}.0.0",) + rest)
        if head == "_bn0":
            return ".".join((f"{prefix}.0.1",) + rest)
        if head.startswith("_blocks."):
            j = int(head.split(".")[1])
            if j < splits[1]:
                return ".".join((f"{prefix}.0.{2 + j}",) + rest)
            for g in range(1, 4):
                if splits[g] <= j < splits[g + 1]:
                    return ".".join((f"{prefix}.{g}.{j - splits[g]}",)
                                    + rest)
        raise KeyError(f"Unmapped efficientnet path {parts}")

    return translate


def _resnet_midas_translator(parts: tuple[str, ...]) -> str:
    """MiDaS ResNet encoder: blocks.0 = Sequential(conv1@0, bn1@1, relu,
    maxpool, layer1@4); blocks.g = Sequential(layer{g+1}) for g ≥ 1
    (lasinger2019.py:107-111)."""
    head, rest = parts[0], parts[1:]
    if head == "conv1":
        return ".".join(("blocks.0.0",) + rest)
    if head == "bn1":
        return ".".join(("blocks.0.1",) + rest)
    if head.startswith("layer"):
        layer, idx = head.split(".")
        k = int(layer[len("layer"):])
        if k == 1:
            return ".".join((f"blocks.0.4.{idx}",) + rest)
        return ".".join((f"blocks.{k - 1}.0.{idx}",) + rest)
    raise KeyError(f"Unmapped resnet-midas path {parts}")


def _senet_hu_translator(parts: tuple[str, ...]) -> str:
    """Hu E_senet: base = Sequential(layer0@0, layer1@1, ... layer4@4)
    (modules.py:108-121)."""
    head, rest = parts[0], parts[1:]
    if head.startswith("layer0."):
        return ".".join(("base.0." + head[len("layer0."):],) + rest)
    if head.startswith("layer"):
        layer, idx = head.split(".")
        k = int(layer[len("layer"):])
        return ".".join((f"base.{k}.{idx}",) + rest)
    raise KeyError(f"Unmapped senet path {parts}")


def _encoder(model: nn.Module) -> nn.Module | None:
    return model.encoder if isinstance(model, MidasNet) else getattr(
        model, "E", None)


def _encoder_translator(model: nn.Module) -> Callable:
    """The encoder-path translator of ``model``'s encoder class: the
    reference wraps EfficientNet in Sequential blocks under both decoders,
    SENet under Hu2018 and ResNet under MiDaS; DenseNet and the rest keep
    their own paths. SENet is tested first, so that no SENet takes a
    ResNet translator (JAX ``_encoder_translator``)."""
    encoder = _encoder(model)
    midas = isinstance(model, MidasNet)
    if isinstance(encoder, EfficientNetFeatures):
        return _efficientnet_blocks_translator(encoder.variant, "blocks")
    if isinstance(encoder, SENetFeatures):
        return _identity_translator if midas else _senet_hu_translator
    if isinstance(encoder, ResNetFeatures) and midas:
        return _resnet_midas_translator
    return _identity_translator


def reference_key(key: str, translate: Callable) -> str:
    """The reference's key of a port ``state_dict`` key, under the encoder
    translator ``translate`` (the JAX package's ``_torch_key``): numbered
    submodules re-joined to the JAX module names (``_blocks.3``,
    ``layer1.0``), and only a path inside the encoder (``E`` or
    ``encoder``) translated."""
    *modules, leaf = key.split(".")
    mods = _jax_modules(modules)
    if mods and mods[0] in ("E", "encoder") and len(mods) > 1:
        return f"{mods[0]}.{translate(tuple(mods[1:]) + (leaf,))}"
    return key


def reference_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """``model``'s weights and statistics under the reference's keys, on
    the CPU: what ``torch.save`` writes as a reference checkpoint (the
    inverse of ``load_reference_state_dict``)."""
    translate = _encoder_translator(model)
    return {reference_key(k, translate): v.detach().cpu()
            for k, v in model.state_dict().items()}


def load_reference_state_dict(model: nn.Module,
                              state_dict: Mapping[str, Any]) -> nn.Module:
    """Load a reference-keyed ``state_dict`` (prefixes already fixed) into
    ``model``, strictly in both directions: every key of the model must be
    there (``KeyError`` naming the reference key) and every key of the
    file used (``KeyError`` listing the unused), with ``num_batches_tracked``
    dropped; shapes must agree (``ValueError``); values take the dtype of
    the model's tensor."""
    state = {k: v for k, v in state_dict.items()
             if not k.endswith("num_batches_tracked")}
    translate = _encoder_translator(model)
    used, loaded = set(), {}
    for key, template in model.state_dict().items():
        ref = reference_key(key, translate)
        if ref not in state:
            raise KeyError(f"No torch key for {key} (expected '{ref}')")
        value = torch.as_tensor(state[ref])
        used.add(ref)
        if tuple(value.shape) != tuple(template.shape):
            raise ValueError(f"Shape mismatch for {ref}: torch "
                             f"{tuple(value.shape)} vs port "
                             f"{tuple(template.shape)}")
        loaded[key] = value.to(template.dtype)
    unused = set(state) - used
    if unused:
        raise KeyError(f"Unused torch keys: {sorted(unused)[:8]}"
                       f"{'...' if len(unused) > 8 else ''}")
    model.load_state_dict(loaded, strict=True)
    return model


# ---------------------------------------------------------------------------
# top-level import
# ---------------------------------------------------------------------------


def import_pth(path_or_file, model: nn.Module | None = None) -> nn.Module:
    """The model of a reference checkpoint, on the CPU, eval.

    A self-describing MidasNet dict builds its own architecture
    (lasinger2019.py:396-415) and warns on a schema version other than
    ``MIDAS_CHECKPOINT_VERSION``. A raw ``state_dict`` needs ``model`` or a
    file named ``{ENC}-{DEC}.pth`` (``ValueError`` otherwise); a SENet
    encoder's keys are read in both of the reference's vintages
    (``se_module.fc1`` and ``se_fc1``, reside_model.py:42-43).
    """
    state = load_torch_state_dict(path_or_file)
    if isinstance(state, Mapping) and "weights" in state \
            and "encoder" in state:
        check_midas_version(state)
        state_dict = _fix_keys(state["weights"])
        model = midas_model(state) if model is None else model
    else:
        if model is None:
            model = model_from_checkpoint_name(str(path_or_file))
        state_dict = _fix_keys(
            state, senet=isinstance(_encoder(model), SENetFeatures))
    return load_reference_state_dict(model, state_dict).eval()
