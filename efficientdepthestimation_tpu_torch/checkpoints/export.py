"""Ahead-of-time serving artifacts (``torch.export``).

Counterpart of ``efficientdepthestimation_tpu/checkpoints/export.py``. The
whole serving pipeline, uint8 frames (B, H, W, 3) → the PIL-parity eval
preprocess (Scale 240, CenterCrop, ImageNet normalize) → the forward in the
serving dtype → the align-corners upsample to ``out_hw``, is traced once
with ``torch.export`` and written as one file. The hand-written kernels are
registered ops (``ede::depthwise_bn_swish``, ``ede::upsample_conv``;
``ops.kernels``), so they stand in the exported graph as themselves, and a
serving site loads and calls the artifact with ``torch`` and those op
registrations alone: no model classes, no checkpoint parsing.

Two weight modes, as in the JAX package:

- **baked** (the default): the model with its BatchNorms folded
  (``models.common.bake_``, the form ``apps.common.make_infer_fn(...,
  bake_weights=True)`` serves), its tensors inside the exported program;
- **arg weights** (``bake_weights=False``): the exported program takes the
  unbaked model's weights as an input, and the artifact carries them in
  ``weights.msgpack``, in the JAX package's variable tree layout
  (``checkpoints.convert``), never a pickle. The loader binds them, or
  another tree of the same architecture on request, so one artifact
  serves swapped checkpoints.

Batch is static, or symbolic with ``batch=None`` (``torch.export.Dim``), so
that one artifact serves any batch. The file is a zip of ``meta.json`` (the
JAX package's keys, plus ``torch_version`` and ``device``), the program as
``torch.export.save`` writes it, and in arg-weights mode the weights. Its
format name is the port's own: each package refuses the other's artifact.
The program's tensors live on the device it was exported on (``device`` in
the metadata), where it is served.
"""

from __future__ import annotations

import io
import json
import zipfile

import torch
from torch import nn

from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    from_jax_variables,
    pack_tree,
    to_jax_variables,
    unpack_tree,
)
# Registering the kernels' ops, which an exported program calls by name.
from efficientdepthestimation_tpu_torch.ops.kernels import (  # noqa: F401
    depthwise,
    upproj,
)

__all__ = ["export_serving", "save_serving_artifact", "load_serving_artifact",
           "pipeline"]

_PROGRAM_MEMBER = "program.pt2"
_META_MEMBER = "meta.json"
_WEIGHTS_MEMBER = "weights.msgpack"
_FORMAT = "ede-torch-serving-artifact"
_FORMAT_VERSION = 1


class _Pipeline(nn.Module):
    """uint8 frames → depth: the monolithic serving program."""

    def __init__(self, model: nn.Module, crop_hw, out_hw, dtype):
        super().__init__()
        self.model = model
        self.crop_hw, self.out_hw, self.dtype = crop_hw, out_hw, dtype

    def forward(self, frames_u8: torch.Tensor) -> torch.Tensor:
        from efficientdepthestimation_tpu_torch.data.transforms import (
            eval_preprocess_image_only,
        )
        from efficientdepthestimation_tpu_torch.ops.resize import (
            resize_bilinear_align_corners,
        )

        images = eval_preprocess_image_only(frames_u8, self.crop_hw)
        if self.dtype is not None:
            images = images.to(self.dtype)
        depth = self.model(images).float()
        if self.out_hw is not None:
            depth = resize_bilinear_align_corners(depth, self.out_hw)
        return depth


class _ArgWeights(nn.Module):
    """The pipeline with the weights as its first input: it holds no
    tensor of its own, so the exported program carries none."""

    def __init__(self, pipe: _Pipeline):
        super().__init__()
        object.__setattr__(self, "pipe", pipe)  # not a submodule

    def forward(self, weights: dict[str, torch.Tensor],
                frames_u8: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(
            self.pipe, {f"model.{k}": v for k, v in weights.items()},
            (frames_u8,))


def pipeline(model: nn.Module, crop_hw=(228, 304), out_hw=(480, 640),
             dtype=torch.bfloat16) -> nn.Module:
    """The serving pipeline of ``model`` as a module, uint8 frames in, f32
    depth out (the JAX package's ``_pipeline``). ``model`` is used as it
    is: its device, its dtype (``dtype`` casts the images), baked or not."""
    return _Pipeline(model, tuple(crop_hw),
                     None if out_hw is None else tuple(out_hw), dtype)


def _export(module: nn.Module, args: tuple, batch):
    """``torch.export`` of ``module`` on ``args`` (the frames last), their
    batch symbolic when ``batch`` is None."""
    shapes = None
    if batch is None:
        dim = torch.export.Dim("batch", min=1, max=1 << 16)
        shapes = (({k: None for k in args[0]}, {0: dim}) if len(args) == 2
                  else ({0: dim},))
    with torch.no_grad():
        return torch.export.export(module, args, dynamic_shapes=shapes,
                                   strict=False)


def export_serving(model: nn.Module, *, batch: int | None = 128,
                   in_hw=(480, 640), crop_hw=(228, 304), out_hw=(480, 640),
                   dtype=torch.bfloat16, bake_weights: bool = True,
                   device=None):
    """The serving pipeline of ``model`` as a
    ``torch.export.ExportedProgram``, traced on ``device`` (the card unless
    ``"cpu"``), and in arg-weights mode the ``state_dict`` it takes.

    Returns ``(program, weights)``: ``weights`` is None for a baked
    program; else the program's first input, the model's state in
    ``dtype`` on ``device``. ``batch=None`` exports a symbolic batch.
    """
    from efficientdepthestimation_tpu_torch.apps.common import (
        _serving_copy,
        resolve_device,
    )

    device = resolve_device(device)
    served = _serving_copy(model, device, dtype, bake_weights)
    pipe = pipeline(served, crop_hw, out_hw, dtype)
    b = 2 if batch is None else int(batch)
    frames = torch.zeros((b, *in_hw, 3), dtype=torch.uint8, device=device)
    if bake_weights:
        return _export(pipe, (frames,), batch), None
    weights = {k: v.detach() for k, v in served.state_dict().items()}
    return _export(_ArgWeights(pipe), (weights, frames), batch), weights


def save_serving_artifact(path, model: nn.Module, *, encoder: str,
                          decoder: str, batch: int | None = 128,
                          in_hw=(480, 640), crop_hw=(228, 304),
                          out_hw=(480, 640), dtype=torch.bfloat16,
                          bake_weights: bool = True, device=None) -> dict:
    """Export and write a single-file serving artifact; returns its
    metadata. In arg-weights mode the weights are stored as f32 arrays of
    the JAX package's tree (bf16, which numpy lacks, widens exactly) and
    cast back to ``dtype`` at load."""
    from efficientdepthestimation_tpu_torch.apps.common import (
        resolve_device,
    )

    device = resolve_device(device)
    program, weights = export_serving(
        model, batch=batch, in_hw=in_hw, crop_hw=crop_hw, out_hw=out_hw,
        dtype=dtype, bake_weights=bake_weights, device=device)
    meta = {
        "format": _FORMAT,
        "format_version": _FORMAT_VERSION,
        "encoder": encoder,
        "decoder": decoder,
        "batch": batch,  # None: symbolic (any batch)
        "in_hw": list(in_hw),
        "crop_hw": list(crop_hw),
        "out_hw": None if out_hw is None else list(out_hw),
        "dtype": None if dtype is None else str(dtype).removeprefix("torch."),
        "baked_weights": bool(bake_weights),
        "device": device.type,
        "torch_version": torch.__version__,
    }
    buf = io.BytesIO()
    torch.export.save(program, buf)
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(_META_MEMBER, json.dumps(meta, indent=2))
        zf.writestr(_PROGRAM_MEMBER, buf.getvalue())
        if weights is not None:
            zf.writestr(_WEIGHTS_MEMBER,
                        pack_tree(to_jax_variables(weights)))
    return meta


def _bind(tree: dict, meta: dict) -> dict[str, torch.Tensor]:
    """A JAX-layout weight tree as the program's weight input: tensors in
    the artifact's dtype on its device."""
    dtype = getattr(torch, meta["dtype"]) if meta["dtype"] else None
    return {k: (v.to(dtype) if dtype is not None and v.is_floating_point()
                else v).to(meta["device"])
            for k, v in from_jax_variables(tree).items()}


def load_serving_artifact(path, *, bake_on_load: bool = False,
                          weights: dict | None = None):
    """Read an artifact → ``(fn, meta)``; ``fn(frames_u8)`` returns f32
    depth on the artifact's device (frames on another device are copied
    there). Needs ``torch`` and the kernels' op registrations alone.

    An arg-weights artifact serves the tree it carries, or ``weights`` (a
    tree of the JAX layout, e.g. an ``.ede`` file's ``read_ede`` tree, of
    the same architecture), bound once at load. ``bake_on_load`` is
    accepted for parity with the JAX package, where it binds the weights
    as constants; here they are bound at load either way, so on an
    arg-weights artifact it has no effect. As there, it raises on a baked
    artifact, whose weights are already in the program; so does
    ``weights``.
    """
    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read(_META_MEMBER).decode())
        if meta.get("format") != _FORMAT:
            raise ValueError(f"Not a serving artifact of this package: {path}")
        program = torch.export.load(io.BytesIO(zf.read(_PROGRAM_MEMBER)))
        stored = (None if meta["baked_weights"]
                  else unpack_tree(zf.read(_WEIGHTS_MEMBER)))
    module = program.module()
    device = torch.device(meta["device"])
    if stored is None and (bake_on_load or weights is not None):
        raise ValueError(
            "bake_on_load and weights apply to arg-weight artifacts; this "
            "artifact's weights are already baked into the program")
    args = () if stored is None else (
        _bind(stored if weights is None else weights, meta),)

    @torch.inference_mode()
    def fn(frames_u8):
        return module(*args, torch.as_tensor(frames_u8).to(device))

    return fn, meta
