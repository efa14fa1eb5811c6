"""Checkpoint loading and the serving forms of the port.

Counterpart of ``efficientdepthestimation_tpu/apps/common.py``: checkpoints
of both kinds, ``.ede`` and the reference's ``.pth``, and the serving
pipeline: uint8 frames → PIL-parity preprocess → model in the serving
dtype → f32 depth, optionally upsampled (align corners) to the frame size.
It runs in one of three forms: monolithic (``make_infer_fn``), staged
(``make_staged_infer_fn``: encoder → D → MFF → R, MFF's branch tails
optionally merged) and batch-tiled (``make_tiled_infer_fn``), under a
depthwise mode (``ops.conv.depthwise_impl``), on request in dynamic int8
(``ops.quant``), and with constant-baked weights (``bake_weights``: the
BatchNorms folded once, ``models.common.bake_``). ``make_serving_fn``
picks the form: from a policy the autotuner measured (``apps.autotune``),
else by a rule fitted to the card, and bakes whenever it is given a
``batch_hint``, as the JAX package's does.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import copy
import os

import torch
from torch import nn

from efficientdepthestimation_tpu_torch.checkpoints.pth_import import (
    import_pth,
)
from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
    MAGIC,
    load_checkpoint,
)
from efficientdepthestimation_tpu_torch.data.transforms import (
    eval_preprocess_image_only,
)
from efficientdepthestimation_tpu_torch.models.common import bake_
from efficientdepthestimation_tpu_torch.models.hu2018 import HuDepthModel
from efficientdepthestimation_tpu_torch.models.registry import (
    parse_checkpoint_name,
)
from efficientdepthestimation_tpu_torch.ops.conv import depthwise_impl
from efficientdepthestimation_tpu_torch.ops.quant import quantized_convs
from efficientdepthestimation_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
)
from efficientdepthestimation_tpu_torch.parallel.mesh import data_sharding
from efficientdepthestimation_tpu_torch.parallel.spatial import row_sharded

__all__ = ["resolve_device", "infer_arch_from_path", "load_any_checkpoint",
           "make_infer_fn", "make_staged_infer_fn", "make_tiled_infer_fn",
           "make_serving_fn", "serving_form", "TILE_ABOVE", "MFF_MERGES"]

MFF_MERGES = ("module", "grouped", "blockdiag")


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, which must then be present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    return device


def infer_arch_from_path(model_path: str) -> tuple[str, str]:
    """(encoder, decoder) of a checkpoint path: the released-checkpoint
    name ``{ENC}-{DEC}.pth`` (inference_benchmark.py:117-125), else the
    substring sniffing of demo.py:25-31 (hu2018 unless 'lasinger' appears
    or the name ends in '-lr')."""
    try:
        return parse_checkpoint_name(os.path.basename(model_path))
    except ValueError:
        pass
    lower = os.path.splitext(os.path.basename(model_path))[0].lower()
    decoder = ("lasinger2019" if ("lasinger" in lower or lower.endswith("-lr"))
               else "hu2018")
    for token, enc in (
        ("efficientnet-b4", "efficientnet-b4"),
        ("efficientnet-b0", "efficientnet-b0"),
        ("efficientnet", "efficientnet-b4"),  # demo.py's default variant
        ("resnet", "resnet50"), ("densenet", "densenet161"),
        ("senet", "senet154"),
    ):
        if token in lower:
            return enc, decoder
    raise ValueError(f"Cannot infer architecture from '{model_path}'")


def load_any_checkpoint(path: str, model: nn.Module | None = None, *,
                        device=None) -> nn.Module:
    """The model of a checkpoint on ``device``, eval: a native ``.ede``
    (its ``EDE1`` magic) or a reference ``.pth``, a Hu2018 ``state_dict``
    or a self-describing MidasNet (``checkpoints.pth_import.import_pth``).
    ``model``, when given, receives the weights in place of the model the
    file or its name describes."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic != MAGIC:
        return import_pth(path, model=model).to(device)
    loaded, _ = load_checkpoint(path)
    if model is not None:
        model.load_state_dict(loaded.state_dict(), strict=True)
        loaded = model
    return loaded.to(device).eval()


def _serving_copy(model: nn.Module, device, dtype,
                  bake_weights: bool = False) -> nn.Module:
    """An eval copy of ``model`` on ``device``, every floating-point weight,
    bias and statistic cast to ``dtype`` when it is given, as in the JAX
    package; with ``bake_weights`` its BatchNorms folded first, in f32
    (``models.common.bake_``)."""
    model = copy.deepcopy(model).to(device).eval()
    if bake_weights:
        return bake_(model, dtype)
    return model if dtype is None else model.to(dtype)


def _mode(dw_impl: str, int8: bool):
    """The depthwise mode and, with ``int8``, the int8 convs, entered
    around every call of a serving fn: the switches are read at call
    time."""
    stack = contextlib.ExitStack()
    stack.enter_context(depthwise_impl(dw_impl))
    if int8:
        stack.enter_context(quantized_convs())
    return stack


def _prepare(images, device, preprocess: bool, dtype) -> torch.Tensor:
    images = torch.as_tensor(images).to(device)
    if preprocess:
        images = eval_preprocess_image_only(images)
    return images if dtype is None else images.to(dtype)


def _finish(out: torch.Tensor, upsample_to) -> torch.Tensor:
    out = out.float()
    if upsample_to is not None:
        out = resize_bilinear_align_corners(out, upsample_to)
    return out


def make_infer_fn(model: nn.Module, *, upsample_to=None, dtype=None,
                  preprocess: bool = False, device=None, mesh=None,
                  spatial: bool = False, local_rows: bool = False,
                  dw_impl: str = "pallas", int8: bool = False,
                  bake_weights: bool = False):
    """Forward on a copy of ``model`` cast to ``dtype`` on ``device``: the
    monolithic serving form.

    The returned fn takes NHWC images on any device: normalized f32 images,
    or with ``preprocess=True`` raw uint8 frames, which go through
    ``eval_preprocess_image_only`` first. It returns f32 NHWC depth,
    upsampled to ``upsample_to`` (H, W) when given. As in the JAX package,
    ``dtype`` casts every floating-point weight, bias and statistic.

    ``mesh`` (a ``parallel.Mesh``; its device unless ``device`` is given):
    data-parallel serving, the model replicated on every rank. The fn takes
    the whole batch, which the data axis must divide, and each rank
    forwards its rows (``parallel.data_sharding``); the output holds those
    rows and stays on the rank, as JAX's comes back sharded the same way.
    In a world of one that is the whole batch. With ``local_rows=True`` the
    fn takes this rank's rows alone, as
    ``parallel.distributed_batch_iterator`` decodes them, and forwards them
    as they are.

    ``spatial=True`` (with ``mesh``) is spatial serving instead, JAX's
    latency mode for batches too small to data-shard: every rank takes the
    whole batch, of any size, preprocesses the whole frames, then holds a
    block of the image's rows (``parallel.spatial_sharding``) through the
    forward, each conv, pool and resize computing this rank's rows from the
    halo rows it fetches from its neighbours (``parallel.spatial``). The
    output holds this rank's rows of the depth (``upsample_to``'s rows
    when given) and stays on the rank; ``parallel.gather_rows`` puts it
    together. It composes with ``dtype``, ``preprocess``, ``dw_impl``,
    ``int8`` and ``bake_weights`` as the monolithic form does. Eval only.

    ``dw_impl`` ("pallas", "xla" or "shift"; ``ops.conv.depthwise_impl``)
    selects how an EfficientNet encoder's depthwise convs run; the port's
    default is its kernel, the JAX package's "xla". ``int8=True`` runs the
    eligible dense convs in dynamic int8 (``ops.quant``), a change of
    numerics that is never the default.

    Every form serves a copy of the model made when the fn is built, so
    later edits to ``model`` never reach it. ``bake_weights=True`` is the
    JAX package's constant-baked form: there XLA folds the BatchNorm
    affines into the convs of a program closed over the weights; here the
    copy's BatchNorms are folded once, in f32 before the cast to
    ``dtype``, into the conv weights and biases (``models.common.bake_``),
    so that no forward recomputes or applies them. Outputs equal the
    unbaked form's within rounding, not bit for bit.
    """
    if spatial and mesh is None:
        raise ValueError("make_infer_fn: spatial=True needs a mesh")
    if device is None and mesh is not None:
        device = mesh.device
    return _serve(model, {}, upsample_to=upsample_to, dtype=dtype,
                  preprocess=preprocess, device=device, mesh=mesh,
                  local_rows=local_rows, dw_impl=dw_impl, int8=int8,
                  bake_weights=bake_weights, spatial=spatial)


def _serve(model, forward_kw: dict, *, upsample_to, dtype, preprocess,
           device, dw_impl, int8, bake_weights, mesh=None,
           local_rows=False, spatial=False):
    """The serving fn of ``make_infer_fn``, calling the model with
    ``forward_kw``."""
    device = resolve_device(device)
    model = _serving_copy(model, device, dtype, bake_weights)
    sharding = (None if mesh is None or local_rows or spatial
                else data_sharding(mesh))

    @torch.inference_mode()
    def infer(images) -> torch.Tensor:
        if sharding is not None:
            images = images[sharding.rows(images.shape[0])]
        images = _prepare(images, device, preprocess, dtype)
        with _mode(dw_impl, int8), (row_sharded(mesh) if spatial
                                    else contextlib.nullcontext()) as ctx:
            if ctx is not None:
                images = ctx.band(images)
            out = _finish(model(images, **forward_kw), upsample_to)
        return out

    return infer


def make_staged_infer_fn(model: nn.Module, *, upsample_to=None, dtype=None,
                         mff_merge: str = "module", dw_impl: str = "pallas",
                         int8: bool = False, preprocess: bool = False,
                         device=None, bake_weights: bool = False):
    """The Hu2018 forward as four stages, encoder → D → MFF → R.

    ``mff_merge``: "module" runs the MFF module as it is; "grouped" and
    "blockdiag" run its four branch tails as one 64-channel stream
    (``models.hu2018.mff_apply_merged``), the same function.

    The JAX package chains four jit programs and donates each intermediate
    to its last reader. Eager stages are plain calls, and
    ``HuDepthModel.forward`` itself releases each intermediate at its last
    reader, so with the module merge this is the monolithic form; the JAX
    package's name is kept for its candidates and policies. Other models
    get ``make_infer_fn``, as in the JAX package. The other arguments,
    ``bake_weights`` among them, as in ``make_infer_fn``.
    """
    if mff_merge not in MFF_MERGES:
        raise ValueError(f"unknown mff_merge {mff_merge!r}")
    forward_kw = ({"mff_merge": mff_merge} if isinstance(model, HuDepthModel)
                  and mff_merge != "module" else {})
    return _serve(model, forward_kw, upsample_to=upsample_to, dtype=dtype,
                  preprocess=preprocess, device=device, dw_impl=dw_impl,
                  int8=int8, bake_weights=bake_weights)


def make_tiled_infer_fn(model: nn.Module, *, tile_batch: int = 128,
                        staged: bool = True, upsample_to=None, dtype=None,
                        dw_impl: str = "pallas", int8: bool = False,
                        preprocess: bool = False, device=None,
                        mff_merge: str = "module",
                        bake_weights: bool = False):
    """Serve any batch as full ``tile_batch`` tiles plus one remainder
    through the staged (``staged=True``, with ``mff_merge``) or the
    monolithic form, the outputs concatenated on the device: the peak is
    one tile's working set whatever the batch. The default tile is the JAX
    package's, so that signatures and the autotuner's candidates match
    across the packages; the port's built-in rule (``serving_form``) picks
    its own, ``TILE_ABOVE``. ``bake_weights`` as in ``make_infer_fn``."""
    kw = dict(upsample_to=upsample_to, dtype=dtype, dw_impl=dw_impl,
              int8=int8, preprocess=preprocess, device=device,
              bake_weights=bake_weights)
    base = (make_staged_infer_fn(model, mff_merge=mff_merge, **kw) if staged
            else make_infer_fn(model, **kw))

    def infer(images) -> torch.Tensor:
        n = images.shape[0]
        if n <= tile_batch:
            return base(images)
        return torch.cat([base(images[i:i + tile_batch])
                          for i in range(0, n, tile_batch)])

    return infer


# The built-in serving rule, fitted to chip_smoke.py phase 14 on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit: the eight released
# configurations, bf16, 640×480 uint8 frames in, depth at frame size out
# (PERF.md §5 holds the table).
#   * One form below the tiles: the staged form is the monolithic one
#     (HuDepthModel.forward releases each intermediate at its last reader),
#     and the merged MFF tails were no faster ("grouped" 1.4-7.4% slower,
#     "blockdiag" 2.1% slower to 1.0% faster at batch 128).
#   * No tiles up to TILE_ABOVE frames: one call beat two tiles of half
#     the batch in all eight, by 2.4-40% at 256 (six runs) and 1.0-3.5%
#     at 512 (three runs), at about twice their peak (at 512 at most 38.4
#     GiB, DN161-HU).
#   * Tiles of TILE_ABOVE above it: DN161-HU ran out of device memory in
#     one call of 1024 frames in all three runs, and the seven others
#     served 1024 at -0.9% to +1.6% of their rate at 512, so a tile of 512
#     bounds every peak at its measured value for at most that cost.
TILE_ABOVE = 512


def serving_form(batch: int) -> dict:
    """The form ``make_serving_fn`` serves at ``batch`` frames a call where
    no policy entry says otherwise: {"path": ..., and for a tiled path
    "tile_batch"}, by the rule above, for every configuration."""
    if batch > TILE_ABOVE:
        return {"path": "tiled", "tile_batch": TILE_ABOVE}
    return {"path": "monolithic"}


def make_serving_fn(model: nn.Module, *, batch_hint: int | None = None,
                    upsample_to=None, dtype=None, preprocess: bool = False,
                    device=None, mesh=None, spatial: bool = False,
                    local_rows: bool = False, dw_impl: str = "pallas",
                    policy_path: str | None = None, int8: bool = False,
                    bake_weights: bool | None = None):
    """The serving pipeline every app routes through, with the JAX
    package's defaults: normalized f32 NHWC images in, f32 depth at the
    model's output size out, the model in its own dtype. A deployment that
    serves raw frames passes ``preprocess=True`` (uint8 in),
    ``upsample_to=(480, 640)`` (depth at frame size) and
    ``dtype=torch.bfloat16``.

    ``batch_hint``, the frames a call, lets it choose the form: the entry
    of ``policy_path`` (a policy the autotuner measured, ``apps.autotune``)
    under this card's key when there is one, else ``serving_form``'s rule,
    fitted to the card. Without ``batch_hint``, or with ``mesh``, it is
    ``make_infer_fn``. ``dw_impl`` and ``int8`` as in ``make_infer_fn``
    (an entry's int8 also turns it on). ``mesh``, ``spatial`` and
    ``local_rows`` as in ``make_infer_fn``.

    ``bake_weights`` (``make_infer_fn``'s) has the JAX package's default:
    ``None`` bakes whenever ``batch_hint`` is given (fixed-checkpoint batch
    serving) and not otherwise; a policy entry's own ``bake_weights``
    decides for its form, the passed value where the entry has none. Pass
    ``False`` to serve the unbaked form. The JAX package lets a model of
    200 MB or more override baking into argument weights: a limit of the
    compile transport of its TPU host, which has no counterpart on the
    card, so no size overrides baking here."""
    if mesh is not None or batch_hint is None:
        return make_infer_fn(model, upsample_to=upsample_to, dtype=dtype,
                             preprocess=preprocess, device=device, mesh=mesh,
                             spatial=spatial, local_rows=local_rows,
                             dw_impl=dw_impl, int8=int8,
                             bake_weights=bool(bake_weights))
    from efficientdepthestimation_tpu_torch.apps.autotune import (
        build_serving_candidate,
        load_policy,
        policy_key,
    )

    device = resolve_device(device)
    entry = None
    if policy_path:
        entry = load_policy(policy_path).get(
            policy_key(model, batch_hint, dtype, device))
    if entry is not None:
        spec = {"path": entry["path"], "dw_impl": entry["dw_impl"],
                "int8": bool(entry.get("int8", False)) or int8,
                "bake_weights": bool(entry.get("bake_weights",
                                               bool(bake_weights)))}
    else:
        spec = dict(serving_form(batch_hint), dw_impl=dw_impl, int8=int8,
                    bake_weights=bake_weights is None or bool(bake_weights))
    return build_serving_candidate(model, spec, upsample_to=upsample_to,
                                   dtype=dtype, preprocess=preprocess,
                                   device=device)
