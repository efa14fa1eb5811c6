"""Serving and training autotuner: measure every form on this device, cache
the winner.

Counterpart of ``efficientdepthestimation_tpu/apps/autotune.py``.
``autotune_serving`` times every serving form that applies to a model
(``apps.common``: monolithic, staged for Hu2018 models, tiled and
tiled-staged above ``TILE_BATCH``, each under the depthwise modes of an
EfficientNet encoder, and with ``int8`` the dynamic-int8 variants of the
"xla" mode) on the device it serves from and writes the fastest into a JSON
policy keyed by (device kind, model, batch, dtype), which
``make_serving_fn(policy_path=...)`` then serves from. The JAX package's
``+bake`` candidates (constant-baked weights) have no counterpart until
ROADMAP A16 lands. ``autotune_train`` does the same for the training
step's {accum_steps} × {remat} grid, which the training CLI reads through
``apply_train_policy``. A candidate that runs out of device memory is
recorded as failed; any other error raises.

    python -m efficientdepthestimation_tpu_torch.apps.autotune \\
        --encoder efficientnet-b0 --decoder hu2018 --batch 128 --bf16
    python -m efficientdepthestimation_tpu_torch.apps.autotune --train \\
        --encoder efficientnet-b0 --batch 64 --bf16
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time
from typing import List, Optional

import torch
from torch import nn

from efficientdepthestimation_tpu_torch.apps.common import (
    BAKE_NOT_PORTED,
    make_infer_fn,
    make_staged_infer_fn,
    make_tiled_infer_fn,
    resolve_device,
)
from efficientdepthestimation_tpu_torch.models.efficientnet import (
    EfficientNetFeatures,
)
from efficientdepthestimation_tpu_torch.models.hu2018 import HuDepthModel
from efficientdepthestimation_tpu_torch.models.senet import SENetFeatures

__all__ = ["autotune_serving", "autotune_train", "load_policy", "policy_key",
           "train_policy_key", "apply_train_policy", "build_serving_candidate",
           "DEFAULT_POLICY_PATH", "TRAIN_POLICY_PATH", "TILE_BATCH", "main"]

DEFAULT_POLICY_PATH = os.path.join("runs", "serving_policy.json")
TRAIN_POLICY_PATH = os.path.join("runs", "train_policy.json")
TILE_BATCH = 128


def _device_kind(device=None) -> str:
    """The device's name with spaces replaced, e.g.
    ``NVIDIA_H100_80GB_HBM3``, or ``cpu``: the JAX package's device kind."""
    device = resolve_device(device)
    if device.type == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(device).replace(" ", "_")


def _dtype_name(dtype) -> str:
    return "float32" if dtype is None else str(dtype).removeprefix("torch.")


def _encoder(model: nn.Module) -> nn.Module | None:
    """The encoder: ``E`` of a Hu2018 model, ``encoder`` of a MidasNet."""
    enc = getattr(model, "E", None)
    return enc if enc is not None else getattr(model, "encoder", None)


def _model_id(model: nn.Module) -> str:
    """Decoder class and encoder variant, as the JAX package writes them:
    ``HuDepthModel:efficientnet-b0``. Its registry builds SENet-154 from
    the class alone, with no variant keyword, so that key names the class,
    ``HuDepthModel:SENetFeatures``."""
    enc = _encoder(model)
    name = getattr(enc, "variant", None)
    if name is None or isinstance(enc, SENetFeatures):
        name = type(enc).__name__ if enc is not None else "unknown"
    return f"{type(model).__name__}:{name}"


def policy_key(model: nn.Module, batch: int, dtype, device=None) -> str:
    return (f"{_device_kind(device)}|{_model_id(model)}|b{batch}|"
            f"{_dtype_name(dtype)}")


def load_policy(path: str = DEFAULT_POLICY_PATH) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _write_entry(path: str, key: str, entry: dict) -> None:
    policy = load_policy(path)
    policy[key] = entry
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(policy, f, indent=2)


def _serving_candidates(model: nn.Module, batch: int, int8: bool = False):
    """(name, spec) of every form × depthwise mode valid for this model, in
    the JAX package's order, without its ``+bake`` variants; ``int8``
    adds the int8 variant of each "xla" candidate."""
    dws = ["xla"]
    if isinstance(_encoder(model), EfficientNetFeatures):
        dws += ["shift", "pallas"]
    is_hu = isinstance(model, HuDepthModel)
    cands = []
    for dw in dws:
        cands.append((f"monolithic/{dw}", dict(path="monolithic", dw_impl=dw)))
        if is_hu:
            cands.append((f"staged/{dw}", dict(path="staged", dw_impl=dw)))
        if batch > TILE_BATCH:
            cands.append((f"tiled/{dw}", dict(path="tiled", dw_impl=dw)))
            if is_hu:
                cands.append((f"tiled-staged/{dw}",
                              dict(path="tiled-staged", dw_impl=dw)))
    if int8:
        for name, spec in list(cands):
            if spec["dw_impl"] == "xla":
                cands.append((f"{name}+int8", dict(spec, int8=True)))
    return cands


def build_serving_candidate(model: nn.Module, spec: dict, *,
                            upsample_to=None, dtype=None,
                            preprocess: bool = False, device=None):
    """The serving fn of ``spec``: {"path", "dw_impl", and optionally
    "int8", "mff_merge" (staged paths), "tile_batch" (tiled paths),
    "bake_weights" (raises: ROADMAP A16)}. The fn carries ``spec`` as
    its attribute ``spec``."""
    fn = _build_form(model, spec, upsample_to=upsample_to, dtype=dtype,
                     preprocess=preprocess, device=device)
    fn.spec = dict(spec)
    return fn


def _build_form(model, spec, *, upsample_to, dtype, preprocess, device):
    if spec.get("bake_weights"):
        raise NotImplementedError(BAKE_NOT_PORTED)
    path = spec["path"]
    kw = dict(upsample_to=upsample_to, dtype=dtype, preprocess=preprocess,
              device=device, dw_impl=spec["dw_impl"],
              int8=bool(spec.get("int8", False)))
    merge = {"mff_merge": spec.get("mff_merge", "module")}
    if path == "monolithic":
        return make_infer_fn(model, **kw)
    if path == "staged":
        return make_staged_infer_fn(model, **merge, **kw)
    if path in ("tiled", "tiled-staged"):
        return make_tiled_infer_fn(
            model, staged=path == "tiled-staged",
            tile_batch=spec.get("tile_batch", TILE_BATCH), **merge, **kw)
    raise ValueError(f"unknown serving path {path!r}")


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_fps(fn, images: torch.Tensor, batch: int, *, warmup: int = 2,
               iters: int = 5) -> float:
    """Frames/s of ``iters`` calls after a first call and ``warmup`` more.
    The window closes on one synchronize after the last call; the outputs'
    finiteness is checked after it, so no extra launch enters the
    window."""
    device = images.device
    out = fn(images)
    for _ in range(warmup):
        out = fn(images)
    _synchronize(device)
    del out
    t0 = time.perf_counter()
    outs = [fn(images) for _ in range(iters)]
    _synchronize(device)
    dt = time.perf_counter() - t0
    checksum = float(torch.stack([o.sum() for o in outs]).sum())
    if not torch.isfinite(torch.tensor(checksum)):
        raise FloatingPointError(f"non-finite serving output ({checksum})")
    return batch * iters / dt


def autotune_serving(model: nn.Module, batch: int, *, crop_hw=(228, 304),
                     upsample_to=None, dtype=None,
                     policy_path: Optional[str] = DEFAULT_POLICY_PATH,
                     warmup: int = 2, iters: int = 5, verbose: bool = True,
                     int8: bool = False, device=None):
    """Time every candidate on ``device`` (the card unless ``"cpu"``),
    write the winner under its key, return (its fn, the entry). The inputs
    are normalized f32 images made on the device, as the JAX package's.
    With ``int8`` each int8 candidate records ``rel_out_err``, the norm of
    its output's difference from the float monolithic "xla" form's over
    that form's norm."""
    device = resolve_device(device)
    h, w = crop_hw
    gen = torch.Generator(device).manual_seed(0)
    images = torch.randn((batch, h, w, 3), generator=gen, device=device)

    def build(spec):
        return build_serving_candidate(model, spec, upsample_to=upsample_to,
                                       dtype=dtype, device=device)

    ref_out = ref_norm = None
    if int8:
        ref_out = build({"path": "monolithic", "dw_impl": "xla"})(images)
        ref_norm = float(torch.linalg.vector_norm(ref_out))

    results = []
    for name, spec in _serving_candidates(model, batch, int8=int8):
        try:
            fn = build(spec)
            fps = _timed_fps(fn, images, batch, warmup=warmup, iters=iters)
        except torch.OutOfMemoryError as exc:
            results.append({"candidate": name, **spec, "fps": None,
                            "error": f"{type(exc).__name__}: {exc}"[:200]})
            if verbose:
                print(f"  {name:>22}: out of memory", flush=True)
            continue
        row = {"candidate": name, **spec, "fps": round(fps, 2)}
        if spec.get("int8") and ref_out is not None:
            delta = float(torch.linalg.vector_norm(fn(images) - ref_out))
            row["rel_out_err"] = round(delta / max(ref_norm, 1e-30), 5)
        results.append(row)
        if verbose:
            extra = (f"  (rel_err {row['rel_out_err']})"
                     if "rel_out_err" in row else "")
            print(f"  {name:>22}: {fps:8.1f} img/s{extra}", flush=True)
        del fn

    ok = [r for r in results if r["fps"]]
    if not ok:
        raise RuntimeError(f"every serving candidate failed: {results}")
    best = max(ok, key=lambda r: r["fps"])
    entry = {"path": best["path"], "dw_impl": best["dw_impl"],
             "int8": bool(best.get("int8", False)), "bake_weights": False,
             "fps": best["fps"], "measured": results}
    if "rel_out_err" in best:
        entry["rel_out_err"] = best["rel_out_err"]
    if policy_path:
        _write_entry(policy_path, policy_key(model, batch, dtype, device),
                     entry)
    return build({"path": best["path"], "dw_impl": best["dw_impl"],
                  "int8": entry["int8"]}), entry


# --------------------------------------------------------------- training

def train_policy_key(encoder: str, decoder: str, batch: int, dtype,
                     device=None) -> str:
    return (f"{_device_kind(device)}|{encoder}-{decoder}|b{batch}|"
            f"{_dtype_name(dtype)}")


def _train_candidates(batch: int):
    """The {accum_steps} × {remat} grid, accum dividing the batch; no remat
    when accum > 1 (one microbatch's activations are already all that is
    live)."""
    cands = []
    for accum in (1, 2, 4, 8):
        if batch % accum or batch // accum < 1:
            continue
        for remat in (None, "dots", "full"):
            if accum > 1 and remat is not None:
                continue
            cands.append({"accum_steps": accum, "remat": remat})
    return cands


def _timed_train_step(step, state, batch: dict, *, warmup: int = 1,
                      iters: int = 4, batch_size: int = 1) -> float:
    """Images/s of ``iters`` steps after one step and ``warmup`` more; the
    window closes on one synchronize, the losses' finiteness is checked
    after it."""
    device = batch["image"].device
    for _ in range(1 + warmup):
        state, _ = step(state, batch, 0)
    _synchronize(device)
    t0 = time.perf_counter()
    losses = []
    for _ in range(iters):
        state, metrics = step(state, batch, 0)
        losses.append(metrics["loss"])
    _synchronize(device)
    dt = time.perf_counter() - t0
    checksum = float(torch.stack(losses).sum())
    if not torch.isfinite(torch.tensor(checksum)):
        raise FloatingPointError(f"non-finite training loss ({checksum})")
    return batch_size * iters / dt


def _build(encoder: str, decoder: str, crop_hw) -> nn.Module:
    from efficientdepthestimation_tpu_torch.models.registry import build_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        if decoder == "lasinger2019":
            h, w = crop_hw
            return build_model(encoder, decoder, input_size=tuple(crop_hw),
                               output_size=(h // 2, w // 2))
        return build_model(encoder, decoder)


def autotune_train(encoder: str, decoder: str, batch: int, *,
                   crop_hw=(228, 304), bf16: bool = True,
                   policy_path: Optional[str] = TRAIN_POLICY_PATH,
                   warmup: int = 1, iters: int = 4, verbose: bool = True,
                   device=None) -> dict:
    """Time the training step's {accum_steps, remat} grid for one family at
    one batch on ``device``, each candidate from the same initial state on
    the same raw uint8 batch (480×640, made on the device); write the
    winner under its key and return the entry."""
    from efficientdepthestimation_tpu_torch.training.train_step import (
        create_train_state,
        make_train_step,
        step_lr,
    )

    device = resolve_device(device)
    base = _build(encoder, decoder, crop_hw).to(device)
    gen = torch.Generator(device).manual_seed(0)
    raw = {"image": torch.randint(0, 256, (batch, 480, 640, 3),
                                  generator=gen, device=device,
                                  dtype=torch.uint8),
           "depth": torch.randint(10, 250, (batch, 480, 640), generator=gen,
                                  device=device, dtype=torch.uint8),
           "num_valid": batch}

    results = []
    for spec in _train_candidates(batch):
        name = f"accum{spec['accum_steps']}/{spec['remat'] or 'no-remat'}"
        try:
            state = create_train_state(copy.deepcopy(base),
                                       step_lr(1e-4, steps_per_epoch=100),
                                       1e-4)
            step = make_train_step(mixed_precision=bf16, crop_hw=crop_hw,
                                   device=device, **spec)
            rate = _timed_train_step(step, state, raw, warmup=warmup,
                                     iters=iters, batch_size=batch)
        except torch.OutOfMemoryError as exc:
            results.append({"candidate": name, **spec, "img_per_s": None,
                            "error": f"{type(exc).__name__}: {exc}"[:200]})
            if verbose:
                print(f"  {name:>18}: out of memory", flush=True)
            continue
        del state, step
        results.append({"candidate": name, **spec,
                        "img_per_s": round(rate, 2)})
        if verbose:
            print(f"  {name:>18}: {rate:8.1f} img/s", flush=True)

    ok = [r for r in results if r["img_per_s"]]
    if not ok:
        raise RuntimeError(f"every training candidate failed: {results}")
    best = max(ok, key=lambda r: r["img_per_s"])
    entry = {"accum_steps": best["accum_steps"], "remat": best["remat"],
             "img_per_s": best["img_per_s"], "measured": results}
    if policy_path:
        _write_entry(policy_path, train_policy_key(
            encoder, decoder, batch, torch.bfloat16 if bf16 else None,
            device), entry)
    return entry


def apply_train_policy(policy_path: Optional[str], encoder: str, decoder: str,
                       batch: int, dtype, accum_steps: Optional[int],
                       remat: Optional[str], device=None):
    """The training CLI's (accum_steps, remat, source), by the JAX
    package's rules: an entry is a pair measured together, so if either
    flag is explicit the policy is ignored whole (source "flags"); with no
    explicit flag the entry of this (device, family, batch, dtype) applies
    (source "policy"); else the defaults, accum 1 and no remat (source
    "defaults"). ``remat`` "auto" or None is not explicit; "none" is, and
    means no remat."""
    explicit_accum = accum_steps is not None
    explicit_remat = remat is not None and remat != "auto"
    accum = accum_steps if explicit_accum else 1
    rem = None if remat in (None, "auto", "none") else remat
    if explicit_accum or explicit_remat:
        return accum, rem, "flags"
    entry = (load_policy(policy_path) if policy_path else {}).get(
        train_policy_key(encoder, decoder, batch, dtype, device))
    if not entry:
        return accum, rem, "defaults"
    return int(entry["accum_steps"]), entry["remat"], "policy"


def main(args: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description="Measure the serving forms (or, with --train, the "
                    "training step's policies) on this device; cache the "
                    "winner")
    parser.add_argument("--encoder", default="efficientnet-b0")
    parser.add_argument("--decoder", default="hu2018",
                        choices=("hu2018", "lasinger2019"))
    parser.add_argument("--batch", default=128, type=int)
    parser.add_argument("--crop-hw", nargs=2, type=int, default=[228, 304])
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--int8", action="store_true",
                        help="also measure the dynamic-int8 variants "
                             "(numerics-changing; the winner records "
                             "rel_out_err)")
    parser.add_argument("--iters", default=5, type=int)
    parser.add_argument("--policy", default=None,
                        help="policy JSON path (default: serving_policy.json "
                             "or train_policy.json under runs/)")
    parser.add_argument("--train", action="store_true",
                        help="tune the training step's {accum_steps, remat} "
                             "grid instead of serving; the training CLI "
                             "reads the policy")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the kernels' plain versions)")
    ns = parser.parse_args(args=args)

    device = resolve_device(ns.device)
    crop = tuple(ns.crop_hw)
    kind = _device_kind(device)
    if ns.train:
        policy = ns.policy or TRAIN_POLICY_PATH
        print(f"autotuning TRAIN {ns.encoder}-{ns.decoder} batch={ns.batch} "
              f"bf16={ns.bf16} on {kind}")
        entry = autotune_train(ns.encoder, ns.decoder, ns.batch,
                               crop_hw=crop, bf16=ns.bf16,
                               policy_path=policy, iters=ns.iters,
                               device=device)
        print(json.dumps({"winner": {k: entry[k] for k in
                                     ("accum_steps", "remat", "img_per_s")},
                          "policy": policy}))
        return entry
    policy = ns.policy or DEFAULT_POLICY_PATH
    model = _build(ns.encoder, ns.decoder, crop)
    dtype = torch.bfloat16 if ns.bf16 else None
    print(f"autotuning {_model_id(model)} batch={ns.batch} on {kind}")
    _, entry = autotune_serving(model, ns.batch, crop_hw=crop, dtype=dtype,
                                policy_path=policy, iters=ns.iters,
                                int8=ns.int8, device=device)
    print(json.dumps({"winner": {k: entry[k] for k in
                                 ("path", "dw_impl", "int8", "bake_weights",
                                  "fps")},
                      "policy": policy}))
    return entry


if __name__ == "__main__":
    main()
