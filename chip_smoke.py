#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card: ENB0-HU serving and training,
and serving of the other released configurations.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one output line each (more for the per-site detail):

  1. build the three hand-written kernel sources with nvcc and print their
     registers, shared memory and spills (``-Xptxas -v``);
  2. print the card's name and power limit (nvidia-smi);
  3. hold each kernel against its plain PyTorch version at every shape the
     ENB0-HU serving path gives it, and at the shapes only ENB4-HU (32
     depthwise and 4 upsample-conv sites) and RN50-HU (D.up4, K larger
     than shared memory) give it, at batch 128, in bf16 and f32 (the
     depthwise SE sums bitwise equal across launches), and the loss kernel
     pair at the training shape (64, 114, 152);
  4. load ``e2e/ENB0-HU-synthetic.ede``, check the f32 forward against the
     JAX reference fixture, then serve 128 uint8 480×640 frames in bf16
     through ``make_serving_fn`` and check shape, finiteness, kernel
     launches (16 depthwise + 4 upsample-conv per forward) and agreement
     with the fixture;
  5. time steady-state frames/s, the card's kernel busy time and idle
     share in a serving call (``torch.profiler``), the stages of the
     forward (CUDA events, and their kernels' busy time), each kernel and
     its plain version per site (the kernel as CUDA events over a loop of
     eager calls, and as a CUDA-graph replay, its device time alone; its
     GB/s or TFLOP/s and the share of its bound; beside the upsample-conv
     kernel, cuDNN's interpolate + conv as a yardstick, and the kernel at
     the four einsum-form sites beside that form), and peak device memory;
  6. train: one f32 step against the JAX training fixture; bf16 steps at
     batch 64 through ``make_train_step`` (launches of one step: 1 loss
     forward, 1 loss backward, 4 upsample-conv, 0 depthwise; a finite loss
     that falls over 10 steps on a fixed batch; weights and BN statistics
     move); then images/s, the device ms of the step's phases, each loss
     kernel beside its bound and plain version, and peak device memory;
  7. ENB0-LR from ``e2e/ENB0-LR-synthetic.ede`` (a MidasNet): the f32
     forward against its JAX fixture, bf16 serving of phase 4's 128 frames
     (shape, finiteness, 16 depthwise + 0 upsample-conv launches,
     agreement with the fixture), then as phase 5: frames/s, busy time and
     idle share, the stages, peak memory;
  8. ENB4-HU, ENB4-LR, RN50-HU and RN50-LR at full width and depth with
     seeded random weights (``models.common.randomize_``): bf16 serving of
     the same frames with each one's exact launches, its bf16 output
     against its f32 forward on the card, frames/s, busy time and idle
     share, the stages, peak memory, and the kernels' times at the shapes
     ENB4-HU and RN50-HU give them.

It prints a JSON line of per-configuration figures, a JSON line of
per-kernel figures, then, as its last line, ``{"ok": true, "device":
{...}}``. Any failure raises, so the script exits non-zero without that
line; so does a machine without a CUDA card.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
    make_infer_fn,
    make_serving_fn,
)
from efficientdepthestimation_tpu_torch.checkpoints.convert import to_jax_leaf
from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
    synthetic_train_set,
)
from efficientdepthestimation_tpu_torch.data.transforms import (
    draw_augmentation,
    eval_preprocess_image_only,
    train_preprocess,
)
from efficientdepthestimation_tpu_torch.models.common import randomize_
from efficientdepthestimation_tpu_torch.models.efficientnet import MBConvBlock
from efficientdepthestimation_tpu_torch.models.hu2018 import (
    HuDepthModel,
    UpProjection,
)
from efficientdepthestimation_tpu_torch.models.registry import build_model
from efficientdepthestimation_tpu_torch.ops.fused import (
    should_fuse,
    upsample_conv_pair,
)
from efficientdepthestimation_tpu_torch.ops.kernels import build
from efficientdepthestimation_tpu_torch.ops.kernels.depthwise import (
    depthwise_bn_swish,
    depthwise_bn_swish_plain,
)
from efficientdepthestimation_tpu_torch.ops.kernels.fused_loss import (
    fused_depth_loss,
    fused_depth_loss_bwd,
    fused_depth_loss_bwd_plain,
    fused_depth_loss_fwd,
    fused_depth_loss_fwd_plain,
    masked_total,
)
from efficientdepthestimation_tpu_torch.ops.kernels.upproj import (
    upsample_conv,
    upsample_conv_plain,
)
from efficientdepthestimation_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
)
from efficientdepthestimation_tpu_torch.training.metrics import (
    depth_metrics_batch,
)
from efficientdepthestimation_tpu_torch.training.train_step import (
    create_train_state,
    make_train_step,
    step_seeds,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "e2e", "ENB0-HU-synthetic.ede")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_enb0_hu.npz")
TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                             "torch_train_enb0_hu.npz")
LR_CHECKPOINT = os.path.join(ROOT, "e2e", "ENB0-LR-synthetic.ede")
LR_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_enb0_lr.npz")
# The configurations phase 8 serves with random weights: (encoder, decoder,
# randomize_ seed, launches of one forward: depthwise, upsample-conv).
RANDOM_CONFIGS = {
    "ENB4-HU": ("efficientnet-b4", "hu2018", 4, (32, 4)),
    "ENB4-LR": ("efficientnet-b4", "lasinger2019", 5, (32, 0)),
    "RN50-HU": ("resnet50", "hu2018", 6, (0, 1)),
    "RN50-LR": ("resnet50", "lasinger2019", 7, (0, 0)),
}
# The configurations that give the kernels shapes ENB0-HU does not
# (ENB4-LR's encoder is ENB4-HU's).
NEW_SHAPE_CONFIGS = ("ENB4-HU", "RN50-HU")
F32_CHECK_FRAMES = 8  # frames of phase 8's f32 reference forward
BATCH = 128
TRAIN_BATCH = 64
TRAIN_FIXTURE_SEEDS = (0, 1)  # tests/make_torch_train_fixture.py
LR = WEIGHT_DECAY = 1e-4
LOSS_HW = (114, 152)  # the decoder's output at the 228×304 crop
FALL_STEPS = 10
FRAME_HW = (480, 640)
INPUT_HW = (228, 304)
DEVICE = "cuda"
WARMUP, ITERS = 3, 10

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and the rate of
# each kernel's arithmetic. The depthwise kernel's multiply-adds are f32 on
# the CUDA cores; the upsample-conv is a convolution the tensor cores could
# run in bf16, so its bound is taken at the bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# Kernel vs plain version on the card (same inputs, sums in another order).
#   f32: y differs by f32 rounding only; the SE sums add up to 17,328
#        terms of O(1), hence their absolute floor.
#   bf16: the f32 results agree as above, so y, rounded once to bf16, may
#        differ by one bf16 step (2^-8 relative); the sums stay f32.
TOL = {
    ("depthwise", torch.float32): dict(y=(1e-4, 1e-4), sums=(1e-4, 1e-2)),
    ("depthwise", torch.bfloat16): dict(y=(1e-2, 1e-3), sums=(1e-4, 1e-2)),
    ("upsample_conv", torch.float32): dict(y=(1e-4, 1e-4)),
    ("upsample_conv", torch.bfloat16): dict(y=(1e-2, 1e-2)),
}
# The port's forward against the JAX f32 reference (metres of depth, values
# 1-7 m). f32: a CPU run of the port matches to ~1e-5; the card's conv
# algorithms reorder sums, TF32 off. bf16: rounding of every activation;
# a CPU run of the port in bf16 shows max 0.21 m, mean 0.015 m.
F32_MODEL_TOL = dict(rtol=1e-3, atol=1e-3)
BF16_MODEL_MAX_ABS, BF16_MODEL_MEAN_ABS = 0.5, 0.05
# ENB0-LR's bf16 serving against its JAX f32 fixture (depths 1.1-3.4 m):
# this script's phase 7 run on the CPU shows max 0.030 m, mean 0.0034 m;
# about 3x that for the card's other summation orders (as
# tests/test_torch_slice_lr.py).
BF16_LR_MAX_ABS, BF16_LR_MEAN_ABS = 0.1, 0.01
# Phase 8's bf16 serving against the f32 forward of the same random model,
# relative to the f32 output's largest |value| (the random weights set the
# output's scale, 0.5-10 here): this script's phase 8 run on the CPU
# shows max 0.011-0.035 and mean 0.0022-0.0101; about 3x that for the
# card.
BF16_RANDOM_MAX_REL, BF16_RANDOM_MEAN_REL = 0.15, 0.03
# Loss kernel pair vs its plain versions, same inputs on the card.
#   sums: per-image sums of 17,328 O(1) terms, added in another order
#         (tiles, warps) than the plain reduction, and the normal term's
#         norm as sqrt(a·b) (the Pallas kernel's form) against the plain
#         sqrt(a)·sqrt(b): rtol 1e-5, atol 1e-2; the masked mean then
#         agrees to 1e-5.
#   dp f32: the same formula with other FMA contractions; 1e-4 relative
#         and 1e-5 of the largest |dp| absolute (terms cancel).
#   dp bf16: one bf16 rounding of that: 1e-2 relative and of the largest.
LOSS_TOL = {"sums": (1e-5, 1e-2), "loss": (1e-5, 1e-6),
            ("dp", torch.float32): 1e-4, ("dp", torch.bfloat16): 1e-2}
# The f32 training step on the card against the JAX step on the CPU (the
# fixture), TF32 off: the loss and metric sums to 1e-4 (cuDNN sums in
# another order); gradients to 1e-2 of their leaf's largest value (2.4e-3
# between the port and JAX on the CPU); BN statistics to 1e-4; Adam's first
# update is ±lr per element, so at most 1 element in 100 whose gradient is
# within float noise of 0 may step the other way (2·lr apart).
STEP_TOL = dict(metrics=1e-4, grad=1e-2, stats=1e-4, flips=0.01)
# Operations a pixel, f32 on the CUDA cores (67 TFLOP/s): the forward's
# two Sobel pairs and four terms (3 logs, a sqrt, a divide) ~60, the
# backward's Sobel pairs, A/B factors (2 sqrts, 6 divides) and the two
# correlations ~120. Each is below its bytes time, so bytes bound both.
LOSS_FWD_OPS_PER_PX, LOSS_BWD_OPS_PER_PX = 60, 120


def fixture_frames() -> np.ndarray:
    """The 4 uint8 frames of the JAX fixture (tests/make_torch_port_fixture)."""
    return np.random.default_rng(0).integers(0, 256, (4, *FRAME_HW, 3),
                                             dtype=np.uint8)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` calls, warmed up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def main_path_sites(model) -> tuple[list[dict], list[dict], list[dict]]:
    """The shapes the serving forward gives each kernel, read off one
    forward at batch 1 on the card, with the module's own weights; and the
    UpProjection sites that take the einsum form instead of the kernel."""
    dw_sites, up_sites, einsum_sites = [], [], []
    names = {m: n for n, m in model.named_modules()}

    def on_block(block, args):
        (x,) = args
        _, h, w, cin = x.shape
        dw_sites.append(dict(
            name=names[block], hw=(h, w), c=cin * block.expand,
            k=block._depthwise_conv.weight.shape[-1], stride=block.stride,
            pad=block.pad, block=block))

    def on_up(module, args):
        x, size = args
        fused = should_fuse(tuple(x.shape[1:3]), tuple(size), x.shape[-1],
                            module.features)
        (einsum_sites if fused else up_sites).append(dict(
            module=module, hw=tuple(x.shape[1:3]), c=x.shape[-1],
            size=tuple(size), o=2 * module.features))

    hooks = [m.register_forward_pre_hook(on_block) for m in model.modules()
             if isinstance(m, MBConvBlock)]
    hooks += [m.register_forward_pre_hook(on_up) for m in model.modules()
              if isinstance(m, UpProjection)]
    with torch.inference_mode():
        model(torch.zeros(1, *INPUT_HW, 3, device=DEVICE))
    for h in hooks:
        h.remove()
    for s in up_sites + einsum_sites:
        s["name"] = names[s.pop("module")]
    return dw_sites, up_sites, einsum_sites


def dw_inputs(site: dict, dtype, gen) -> tuple:
    block = site["block"]
    h, w = site["hw"]
    x = torch.randn(BATCH, h, w, site["c"], generator=gen, device=DEVICE)
    taps = block._depthwise_conv.weight[:, 0].permute(1, 2, 0)
    scale, bias = block._bn1.folded()
    return (x.to(dtype), taps.to(dtype).contiguous(), scale.contiguous(),
            bias.contiguous())


def up_inputs(site: dict, model, dtype, gen) -> tuple:
    up = model.get_submodule(site["name"])
    h, w = site["hw"]
    x = torch.randn(BATCH, h, w, site["c"], generator=gen, device=DEVICE)
    k = torch.cat([up.conv1.weight, up.conv2.weight], 0).permute(2, 3, 1, 0)
    return x.to(dtype), k.to(dtype).contiguous()


def dw_out_hw(site: dict) -> tuple[int, int]:
    (pt, pb), (pl, pr) = site["pad"]
    h, w = site["hw"]
    k, s = site["k"], site["stride"]
    return (h + pt + pb - k) // s + 1, (w + pl + pr - k) // s + 1


def dw_bound(site: dict) -> tuple[float, float]:
    """(bytes time, operations time) in ms of one bf16 launch at BATCH."""
    h, w = site["hw"]
    oh, ow = dw_out_hw(site)
    c, k = site["c"], site["k"]
    nbytes = (BATCH * h * w * c * 2 + k * k * c * 2 + 2 * c * 4
              + BATCH * oh * ow * c * 2 + BATCH * c * 4)
    ops = BATCH * oh * ow * c * (2 * k * k + 2)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S


def up_bound(site: dict) -> tuple[float, float]:
    h, w = site["hw"]
    hh, ww = site["size"]
    c, o = site["c"], site["o"]
    nbytes = BATCH * h * w * c * 2 + 25 * c * o * 2 + BATCH * hh * ww * o * 2
    ops = 2 * BATCH * hh * ww * 25 * c * o
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / BF16_OPS_PER_S


def check_close(name, actual, expected, tol) -> float:
    rtol, atol = tol
    torch.testing.assert_close(actual.float(), expected.float(), rtol=rtol,
                               atol=atol, msg=lambda m: f"{name}: {m}")
    return max_abs(actual, expected)


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = build.build(["depthwise_bn_swish", "upsample_conv",
                        "fused_depth_loss"])
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("1 build", f"{name}: {line.strip()}")
    log("1 build", f"ok: the three kernel sources built for sm_90a in "
                   f"{time.perf_counter() - t0:.1f} s")


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log("2 card", out)
    return out


def phase_kernels(model, dw_sites, up_sites, label: str = "ENB0-HU") -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    errs = {"depthwise": 0.0, "upsample_conv": 0.0}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL[("depthwise", dtype)]
            for s in dw_sites:
                args = dw_inputs(s, dtype, gen)
                kw = dict(stride=s["stride"], padding=s["pad"])
                y, sums = depthwise_bn_swish(*args, **kw)
                y_ref, sums_ref = depthwise_bn_swish_plain(*args, **kw)
                torch.cuda.synchronize()
                e = check_close(s["name"], y, y_ref, tol["y"])
                es = check_close(s["name"] + " sums", sums, sums_ref,
                                 tol["sums"])
                if not torch.equal(sums, depthwise_bn_swish(*args, **kw)[1]):
                    raise RuntimeError(f"{s['name']}: depthwise sums differ "
                                       "between launches")
                if dtype == torch.bfloat16:
                    errs["depthwise"] = max(errs["depthwise"], e)
                log("3 kernels", f"{label} depthwise {s['name']} {dtype} "
                    f"x=({BATCH},{s['hw'][0]},{s['hw'][1]},{s['c']}) "
                    f"k{s['k']} s{s['stride']}: max|y-plain|={e:.3g} "
                    f"max|sums-plain|={es:.3g}")
            tol = TOL[("upsample_conv", dtype)]
            for s in up_sites:
                x, k = up_inputs(s, model, dtype, gen)
                y = upsample_conv(x, k, s["size"])
                y_ref = upsample_conv_plain(x, k, s["size"])
                torch.cuda.synchronize()
                e = check_close(s["name"], y, y_ref, tol["y"])
                if dtype == torch.bfloat16:
                    errs["upsample_conv"] = max(errs["upsample_conv"], e)
                log("3 kernels", f"{label} upsample_conv {s['name']} "
                    f"{dtype} x=({BATCH},{s['hw'][0]},{s['hw'][1]},"
                    f"{s['c']}) -> {s['size']}x{s['o']}: "
                    f"max|y-plain|={e:.3g}")
    log("3 kernels", f"ok: {label}'s {len(dw_sites)} depthwise and "
                     f"{len(up_sites)} upsample_conv sites agree with the "
                     "plain versions in f32 and bf16, depthwise sums bitwise "
                     f"equal across launches; (rtol, atol): {TOL}")
    return errs


def loss_inputs(dtype, gen) -> tuple[torch.Tensor, torch.Tensor]:
    """(pred, target) at the training shape: image 0 flat in both, image 1
    with pred == target, the rest uniform in 1-9 m."""
    shape = (TRAIN_BATCH, *LOSS_HW)
    target = torch.rand(shape, generator=gen, device=DEVICE) * 8 + 1
    pred = torch.rand(shape, generator=gen, device=DEVICE) * 8 + 1
    pred[0] = target[0] = 3.0
    pred[1] = target[1]
    return pred.to(dtype).contiguous(), target


def phase_loss_kernels() -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    hw = LOSS_HW[0] * LOSS_HW[1]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        pred, target = loss_inputs(dtype, gen)
        sums = fused_depth_loss_fwd(pred, target)
        ref = fused_depth_loss_fwd_plain(pred, target)
        torch.cuda.synchronize()
        e_sums = check_close("fused_depth_loss sums", sums, ref,
                             LOSS_TOL["sums"])
        if not torch.equal(sums, fused_depth_loss_fwd(pred, target)):
            raise RuntimeError("fused_depth_loss sums differ between runs")
        e_dp = 0.0
        for num_valid in (TRAIN_BATCH, 50):
            mask = (torch.arange(TRAIN_BATCH, device=DEVICE)
                    < num_valid).float()
            e_loss = check_close(
                f"fused_depth_loss value nv={num_valid}",
                masked_total(sums, mask, hw), masked_total(ref, mask, hw),
                LOSS_TOL["loss"])
            coef = torch.full((1,), 1.0 / (num_valid * hw), device=DEVICE)
            dp = fused_depth_loss_bwd(pred, target, mask, coef)
            dp_ref = fused_depth_loss_bwd_plain(pred, target, mask, coef)
            torch.cuda.synchronize()
            tol = LOSS_TOL[("dp", dtype)]
            scale = dp_ref.float().abs().max().item()
            e = check_close(f"fused_depth_loss dp nv={num_valid}", dp, dp_ref,
                            (tol, max(tol, 1e-5) * scale))
            e_dp = max(e_dp, e)
            if dp[0].any() or dp[num_valid:].any():
                raise RuntimeError("fused_depth_loss_bwd: a flat or masked "
                                   "image got a gradient")
            log("3 kernels", f"fused_depth_loss {dtype} ({TRAIN_BATCH},"
                f"{LOSS_HW[0]},{LOSS_HW[1]}) num_valid={num_valid}: "
                f"max|sums-plain|={e_sums:.3g}, |loss-plain|={e_loss:.3g}, "
                f"max|dp-plain|={e:.3g} (max|dp| {scale:.3g}); flat and "
                "masked images exactly 0")
        if dtype == torch.bfloat16:
            errs = {"fused_depth_loss": e_sums, "fused_depth_loss_bwd": e_dp}
    log("3 kernels", f"ok: the loss kernel pair agrees with its plain "
        f"versions in f32 and bf16; (rtol, atol) {LOSS_TOL} (dp atol "
        "relative to the largest |dp|), reasons at LOSS_TOL")
    return errs


def serve_counted(serve, frames, name: str, expected: tuple[int, int]
                  ) -> tuple[torch.Tensor, dict]:
    """One serving call with the serving kernels' counts set to 0 just
    before it and read just after; the call must launch each kernel
    exactly ``expected`` = (depthwise, upsample-conv) times and give finite
    depth at frame size."""
    counters = {"depthwise_bn_swish": depthwise_bn_swish,
                "upsample_conv": upsample_conv}
    for c in counters.values():
        c.launches = 0
    out = serve(frames)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    if tuple(launches.values()) != expected:
        raise RuntimeError(f"{name} serving launches {launches}, expected "
                           f"{expected[0]} + {expected[1]}")
    if tuple(out.shape) != (frames.shape[0], *FRAME_HW, 1):
        raise RuntimeError(f"{name} output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"non-finite depth in {name}'s bf16 serving "
                           "output")
    return out, launches


def phase_serve(model) -> tuple:
    fx = np.load(FIXTURE)
    frames4 = fixture_frames()
    if int(frames4.sum(dtype=np.int64)) != int(fx["frames_sum"]):
        raise RuntimeError("fixture frames differ from the recipe")
    ref = torch.from_numpy(fx["depth"]).to(DEVICE)

    f32_fn = make_infer_fn(model, preprocess=True, device=DEVICE)
    out32 = f32_fn(torch.from_numpy(frames4))[..., 0]
    torch.testing.assert_close(out32, ref, **F32_MODEL_TOL)
    log("4 serve", f"f32 forward vs JAX fixture: max abs "
                   f"{max_abs(out32, ref):.3g} m (rtol/atol "
                   f"{F32_MODEL_TOL['rtol']}/{F32_MODEL_TOL['atol']})")

    rest = np.random.default_rng(1).integers(
        0, 256, (BATCH - 4, *FRAME_HW, 3), dtype=np.uint8)
    frames = torch.from_numpy(np.concatenate([frames4, rest])).to(DEVICE)
    serve = make_serving_fn(model, device=DEVICE)
    out, launches = serve_counted(serve, frames, "ENB0-HU", (16, 4))
    ref_up = resize_bilinear_align_corners(ref[..., None], FRAME_HW)
    err = (out[:4] - ref_up).abs()
    e_max, e_mean = err.max().item(), err.mean().item()
    if e_max > BF16_MODEL_MAX_ABS or e_mean > BF16_MODEL_MEAN_ABS:
        raise RuntimeError(f"bf16 serving vs fixture: max {e_max} mean "
                           f"{e_mean} m")
    log("4 serve", f"bf16 serving of {BATCH} frames {FRAME_HW}: shape "
                   f"{tuple(out.shape)} finite, launches {launches}, vs "
                   f"fixture max abs {e_max:.3g} m (<= {BF16_MODEL_MAX_ABS}) "
                   f"mean abs {e_mean:.3g} m (<= {BF16_MODEL_MEAN_ABS})")
    return serve, frames, launches


def composition(x: torch.Tensor, k: torch.Tensor, size) -> torch.Tensor:
    """The upsample-conv as two cuDNN-era PyTorch calls, channels-last: a
    yardstick for the kernel's time only (the port never calls it)."""
    xc = x.permute(0, 3, 1, 2)  # NHWC memory, channels-last NCHW view
    up = F.interpolate(xc, size=size, mode="bilinear", align_corners=True)
    w = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return F.conv2d(up, w, padding=2)


def serving_rate(serve, frames, card, phase: str, label: str) -> dict:
    """frames/s and ms per batch on the host clock over ITERS calls after
    WARMUP, the peak device memory of those calls, and the card's kernel
    busy time in one call with the idle share of the batch time it
    leaves."""
    for _ in range(WARMUP):
        serve(frames)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        serve(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = dict(frames_per_s=BATCH * ITERS / dt, ms_per_batch=1e3 * dt / ITERS,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    with torch.inference_mode():
        busy, records, top = kernel_busy(lambda: serve(frames))
    rate.update(busy_ms=busy, idle_share=1 - busy / rate["ms_per_batch"])
    log(phase, f"{card}: {label} serving {BATCH}x{FRAME_HW} bf16: "
        f"{rate['frames_per_s']:.1f} frames/s ({rate['ms_per_batch']:.2f} ms "
        f"per batch, host clock), peak memory {rate['peak_gib']:.2f} GiB; "
        f"kernels busy {busy:.2f} ms per batch (torch.profiler, "
        f"{records:.0f} kernel and copy records a call): device idle share "
        f"{rate['idle_share']:.3f}; most device ms per batch: "
        + ", ".join(f"{k} {v:.2f}" for k, v in top[:5]))
    return rate


def stage_times(model, frames, card, phase: str, label: str) -> dict:
    """Each stage of the bf16 serving forward as a call of its own on its
    own inputs: CUDA events over 5 eager calls (``ms``; host time included
    where the host launches the stage slower than the card runs it) and the
    kernel busy time per call (``busy_ms``, the device time alone)."""
    mb = copy.deepcopy(model).to(torch.bfloat16)
    with torch.inference_mode():
        x = eval_preprocess_image_only(frames).to(torch.bfloat16)
        if isinstance(mb, HuDepthModel):
            taps = mb.E(x)
            x_d = mb.D(taps)
            size = tuple(x_d.shape[1:3])
            x_r = torch.cat([x_d, mb.MFF(taps, size)], dim=-1)
            out = mb.R(x_r).float()
            fns = {"E": lambda: mb.E(x), "D": lambda: mb.D(taps),
                   "MFF": lambda: mb.MFF(taps, size),
                   "R": lambda: mb.R(x_r)}
        else:
            taps = mb.encoder(x)
            feats = mb.decoder.decode(taps)
            out = mb.decoder.head(feats, mb.output_size).float()
            fns = {"encoder": lambda: mb.encoder(x),
                   "decoder blocks": lambda: mb.decoder.decode(taps),
                   "head": lambda: mb.decoder.head(feats, mb.output_size)}
        fns = {"preprocess": lambda: eval_preprocess_image_only(frames),
               **fns,
               "upsample": lambda: resize_bilinear_align_corners(
                   out, FRAME_HW)}
        parts = {k: dict(ms=cuda_ms(fn, 5), busy_ms=kernel_busy(fn)[0])
                 for k, fn in fns.items()}
    log(phase, f"{card}: {label} stages at batch {BATCH}, device ms by "
        "CUDA events over eager calls [kernel busy ms, torch.profiler]: "
        + ", ".join(f"{k} {v['ms']:.2f} [{v['busy_ms']:.2f}]"
                    for k, v in parts.items())
        + f"; sums {sum(v['ms'] for v in parts.values()):.2f} "
        f"[{sum(v['busy_ms'] for v in parts.values()):.2f}]")
    return parts


def time_sites(model, card, dw_sites, up_sites, phase: str,
               label: str) -> dict:
    """Each kernel at each site of a model, bf16 at BATCH: its ms (CUDA
    events over a loop of eager wrapper calls, as the first versions of
    these kernels were timed: what a serving forward pays, host included
    where the host is slower than the kernel), its CUDA-graph replay (the
    device time alone), its plain version, bound and yardstick; summed per
    forward."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    res = {"depthwise": dict(ms=0.0, graph_ms=0.0, plain_ms=0.0, bytes=0.0,
                             ops=0.0, grouped_ms=0.0),
           "upsample_conv": dict(ms=0.0, graph_ms=0.0, plain_ms=0.0,
                                 bytes=0.0, ops=0.0, composition_ms=0.0)}
    with torch.inference_mode():
        for s in dw_sites:
            args = dw_inputs(s, torch.bfloat16, gen)
            kw = dict(stride=s["stride"], padding=s["pad"])
            ms = cuda_ms(lambda: depthwise_bn_swish(*args, **kw))
            graph = graph_ms(lambda: depthwise_bn_swish(*args, **kw))
            plain = cuda_ms(lambda: depthwise_bn_swish_plain(*args, **kw))
            (pt, pb), (pl, pr) = s["pad"]
            xp = F.pad(args[0], (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
            wk = args[1].permute(2, 0, 1).unsqueeze(1).contiguous()
            grouped = cuda_ms(lambda: F.conv2d(xp, wk, stride=s["stride"],
                                               groups=s["c"]))
            tb, to = dw_bound(s)
            r = res["depthwise"]
            r["ms"] += ms
            r["graph_ms"] += graph
            r["plain_ms"] += plain
            r["bytes"] += tb
            r["ops"] += to
            r["grouped_ms"] += grouped
            gbs = tb * HBM_BYTES_PER_S / 1e9 / ms
            log(phase, f"{card}: {label} depthwise {s['name']} ({BATCH},"
                f"{s['hw'][0]},{s['hw'][1]},{s['c']}) k{s['k']} "
                f"s{s['stride']}: kernel {ms:.4f} ms ({gbs:.0f} GB/s; "
                f"CUDA graph {graph:.4f} ms), plain "
                f"{plain:.4f} ms, bound {max(tb, to):.4f} ms "
                f"({'bytes' if tb >= to else 'operations'}; share of bound "
                f"reached {max(tb, to) / ms:.3f}), cuDNN grouped conv alone "
                f"(partial yardstick) {grouped:.4f} ms")
        for s in up_sites:
            x, k = up_inputs(s, model, torch.bfloat16, gen)
            ms = cuda_ms(lambda: upsample_conv(x, k, s["size"]))
            graph = graph_ms(lambda: upsample_conv(x, k, s["size"]))
            plain = cuda_ms(lambda: upsample_conv_plain(x, k, s["size"]))
            comp = cuda_ms(lambda: composition(x, k, s["size"]))
            tb, to = up_bound(s)
            r = res["upsample_conv"]
            r["ms"] += ms
            r["graph_ms"] += graph
            r["plain_ms"] += plain
            r["bytes"] += tb
            r["ops"] += to
            r["composition_ms"] += comp
            log(phase, f"{card}: {label} upsample_conv {s['name']} ({BATCH},"
                f"{s['hw'][0]},{s['hw'][1]},{s['c']}) -> {s['size']}x"
                f"{s['o']}: kernel {ms:.4f} ms "
                f"({to * BF16_OPS_PER_S / ms / 1e12:.1f} TFLOP/s; CUDA "
                f"graph {graph:.4f} ms), composition_ms {comp:.4f} "
                "(F.interpolate + cuDNN conv2d, channels-last bf16; "
                f"yardstick), plain {plain:.4f} ms, "
                f"bound {max(tb, to):.4f} ms ("
                f"{'bytes' if tb >= to else 'operations'}; share of bound "
                f"reached {max(tb, to) / ms:.3f})")
    for name, r in res.items():
        if not r["ms"]:
            continue
        bound = max(r["bytes"], r["ops"])
        log(phase, f"{card}: {label} {name} per forward: kernel "
            f"{r['ms']:.3f} ms (CUDA events over eager calls; CUDA-graph "
            f"replay {r['graph_ms']:.3f}), plain {r['plain_ms']:.3f} ms, "
            f"bound {bound:.3f} ms, share of bound reached "
            f"{bound / r['ms']:.3f}")
    return res


def phase_time(model, serve, frames, card, dw_sites, up_sites,
               einsum_sites) -> tuple[dict, dict]:
    rate = serving_rate(serve, frames, card, "5 time", "ENB0-HU")
    rate["stage_ms"] = stage_times(model, frames, card, "5 time", "ENB0-HU")
    res = time_sites(model, card, dw_sites, up_sites, "5 time", "ENB0-HU")
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    with torch.inference_mode():
        # ROADMAP A15: the kernel where should_fuse picks the einsum form.
        for s in einsum_sites:
            x, k = up_inputs(s, model, torch.bfloat16, gen)
            f = s["o"] // 2
            k1, k2 = k[..., :f].contiguous(), k[..., f:].contiguous()
            ms = graph_ms(lambda: upsample_conv(x, k, s["size"]))
            einsum = graph_ms(lambda: upsample_conv_pair(x, k1, k2,
                                                         s["size"]))
            _, to = up_bound(s)
            log("5 time", f"{card}: einsum site {s['name']} ({BATCH},"
                f"{s['hw'][0]},{s['hw'][1]},{s['c']}) -> {s['size']}x"
                f"{s['o']}: upsample_conv kernel {ms:.4f} ms "
                f"({to * BF16_OPS_PER_S / ms / 1e12:.1f} TFLOP/s), einsum "
                f"form (the model's route) {einsum:.4f} ms (both CUDA-graph "
                "replay)")
    log("5 time", f"{card}: cuDNN grouped conv alone over the depthwise "
        f"sites (partial yardstick): {res['depthwise']['grouped_ms']:.3f} ms")
    log("5 time", f"{card}: F.interpolate + cuDNN conv2d over the "
        f"upsample_conv sites (yardstick): composition_ms "
        f"{res['upsample_conv']['composition_ms']:.3f}")
    return res, rate


def phase_lr(frames, card) -> dict:
    """7: ENB0-LR, a MidasNet, from its .ede against its JAX fixture."""
    fx = np.load(LR_FIXTURE)
    if int(frames[:4].sum()) != int(fx["frames_sum"]):
        raise RuntimeError("ENB0-LR fixture frames differ from the recipe")
    ref = torch.from_numpy(fx["depth"]).to(DEVICE)
    model = load_any_checkpoint(LR_CHECKPOINT, device=DEVICE)
    out32 = make_infer_fn(model, preprocess=True, device=DEVICE)(
        frames[:4])[..., 0]
    torch.testing.assert_close(out32, ref, **F32_MODEL_TOL)
    log("7 ENB0-LR", f"f32 forward vs JAX fixture: max abs "
        f"{max_abs(out32, ref):.3g} m (rtol/atol {F32_MODEL_TOL['rtol']}/"
        f"{F32_MODEL_TOL['atol']})")

    serve = make_serving_fn(model, device=DEVICE)
    out, launches = serve_counted(serve, frames, "ENB0-LR", (16, 0))
    ref_up = resize_bilinear_align_corners(ref[..., None], FRAME_HW)
    err = (out[:4] - ref_up).abs()
    e_max, e_mean = err.max().item(), err.mean().item()
    if e_max > BF16_LR_MAX_ABS or e_mean > BF16_LR_MEAN_ABS:
        raise RuntimeError(f"ENB0-LR bf16 serving vs fixture: max {e_max} "
                           f"mean {e_mean} m")
    log("7 ENB0-LR", f"bf16 serving of {BATCH} frames {FRAME_HW}: shape "
        f"{tuple(out.shape)} finite, launches {launches}, vs fixture max abs "
        f"{e_max:.3g} m (<= {BF16_LR_MAX_ABS}) mean abs {e_mean:.3g} m "
        f"(<= {BF16_LR_MEAN_ABS})")
    del out

    rate = serving_rate(serve, frames, card, "7 ENB0-LR", "ENB0-LR")
    rate["stage_ms"] = stage_times(model, frames, card, "7 ENB0-LR",
                                   "ENB0-LR")
    return dict(name="ENB0-LR", launches=launches, bf16_max_abs_m=e_max,
                bf16_mean_abs_m=e_mean, **rate)


def random_model(name: str) -> torch.nn.Module:
    """A released configuration at full width and depth with the seeded
    random weights of ``randomize_``, on the card."""
    encoder, decoder, seed, _ = RANDOM_CONFIGS[name]
    return randomize_(build_model(encoder, decoder), seed).to(DEVICE)


def phase_random(name: str, frames, card) -> dict:
    """8: one configuration with random weights: bf16 serving with its
    exact launches, against its own f32 forward; frames/s, peak memory and,
    where it gives the kernels shapes of their own, their times."""
    expected = RANDOM_CONFIGS[name][3]
    model = random_model(name)
    serve = make_serving_fn(model, device=DEVICE)
    out, launches = serve_counted(serve, frames, name, expected)
    n = F32_CHECK_FRAMES
    ref = make_infer_fn(model, preprocess=True, upsample_to=FRAME_HW,
                        device=DEVICE)(frames[:n])
    scale = ref.abs().max().item()
    err = (out[:n] - ref).abs()
    rel_max, rel_mean = err.max().item() / scale, err.mean().item() / scale
    if not (scale > 0 and rel_max <= BF16_RANDOM_MAX_REL
            and rel_mean <= BF16_RANDOM_MEAN_REL):
        raise RuntimeError(f"{name} bf16 vs f32: max {rel_max} mean "
                           f"{rel_mean} of max|f32| {scale}")
    log("8 configs", f"{name} bf16 serving of {BATCH} frames {FRAME_HW}: "
        f"shape {tuple(out.shape)} finite, launches {launches}; vs its f32 "
        f"forward on {n} frames, of max|f32| {scale:.4g}: max "
        f"{rel_max:.3g} (<= {BF16_RANDOM_MAX_REL}), mean {rel_mean:.3g} "
        f"(<= {BF16_RANDOM_MEAN_REL})")
    del out, ref, err
    rate = serving_rate(serve, frames, card, "8 configs", name)
    rate["stage_ms"] = stage_times(model, frames, card, "8 configs", name)
    result = dict(name=name, launches=launches, bf16_max_rel=rel_max,
                  bf16_mean_rel=rel_mean, **rate)
    if name in NEW_SHAPE_CONFIGS:
        dw_sites, up_sites, _ = main_path_sites(model)
        res = time_sites(model, card, dw_sites, up_sites, "8 configs", name)
        result["kernels"] = {
            k: dict(ms=r["ms"], graph_ms=r["graph_ms"],
                    plain_ms=r["plain_ms"],
                    bound_ms=max(r["bytes"], r["ops"]))
            for k, r in res.items() if r["ms"]}
    return result


def train_batch(seeds) -> dict:
    """uint8 ``render_scene`` frames and ×25.5 depths, on the card."""
    pairs = synthetic_train_set(seeds)
    return {"image": torch.from_numpy(np.stack([p[0] for p in pairs])
                                      ).to(DEVICE),
            "depth": torch.from_numpy(np.stack([p[1] for p in pairs])
                                      ).to(DEVICE),
            "num_valid": len(pairs)}


def jax_keyed(model, grads: bool) -> dict[str, np.ndarray]:
    """Gradients, or parameters and statistics, keyed as in the fixture."""
    items = (((n, p.grad) for n, p in model.named_parameters()) if grads
             else model.state_dict().items())
    out = {}
    for name, value in items:
        collection, path, arr = to_jax_leaf(name, value)
        out[f"{collection}/{path}"] = arr
    return out


def phase_train_fixture() -> dict:
    """(a) One f32 step against the JAX package's, recorded in the fixture
    (drop-connect off, the fixture's augmentation draws, TF32 off)."""
    fx = dict(np.load(TRAIN_FIXTURE))
    batch = train_batch(TRAIN_FIXTURE_SEEDS)
    if (int(batch["image"].sum()) != int(fx["frames_sum"])
            or int(batch["depth"].sum()) != int(fx["depths_sum"])):
        raise RuntimeError("training fixture frames differ from the recipe")
    model = load_any_checkpoint(CHECKPOINT, device=DEVICE)
    model.E.drop_connect_rate = 0.0
    state = create_train_state(model, LR, WEIGHT_DECAY)
    step = make_train_step(device=DEVICE)
    draws = {k[len("draw_"):]: torch.from_numpy(v) for k, v in fx.items()
             if k.startswith("draw_")}
    state, metrics = step(state, batch, 0, draws=draws)
    errs = {}
    for name, value in metrics.items():
        ref = float(fx[f"metric/{name}"])
        errs[name] = abs(float(value) - ref) / max(abs(ref), 1e-12)
    grads = jax_keyed(model, grads=True)
    for key in (k for k in fx if k.startswith("grad/")):
        ref = fx[key]
        got = grads["params/" + key[len("grad/"):]]
        errs[key] = float(np.abs(got - ref).max() / np.abs(ref).max())
    values = jax_keyed(model, grads=False)
    flips = 0.0
    for key in (k for k in fx if k.startswith(("stat/", "param/"))):
        ref = fx[key]
        col = "batch_stats/" if key.startswith("stat/") else "params/"
        err = np.abs(values[col + key.split("/", 1)[1]] - ref)
        if key.startswith("stat/"):
            errs[key] = float((err / np.maximum(np.abs(ref), 1e-3)).max())
        else:
            if err.max() > 2 * LR * 1.001:
                raise RuntimeError(f"{key}: update differs by {err.max()}")
            flips = max(flips, float((err > 1e-6).mean()))
    worst = {
        "metrics": max(v for k, v in errs.items() if "/" not in k),
        "grad": max(v for k, v in errs.items() if k.startswith("grad/")),
        "stats": max(v for k, v in errs.items() if k.startswith("stat/")),
        "flips": flips}
    for key, value in worst.items():
        if not value <= STEP_TOL[key]:
            raise RuntimeError(f"f32 step vs fixture: {key} {value} > "
                               f"{STEP_TOL[key]} ({errs})")
    log("6 train", f"f32 step vs JAX fixture (batch 2, 228x304): loss "
        f"{float(metrics['loss']):.6f} vs {float(fx['metric/loss']):.6f}; "
        f"worst relative errors {worst} within {STEP_TOL}")
    return worst


def phase_train_steps() -> tuple:
    """(b) The main training path: bf16 steps at batch 64."""
    batch = train_batch(range(TRAIN_BATCH))
    model = load_any_checkpoint(CHECKPOINT, device=DEVICE)
    state = create_train_state(model, LR, WEIGHT_DECAY)
    step = make_train_step(mixed_precision=True, device=DEVICE)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    counters = {"fused_depth_loss": fused_depth_loss_fwd,
                "fused_depth_loss_bwd": fused_depth_loss_bwd,
                "upsample_conv": upsample_conv,
                "depthwise_bn_swish": depthwise_bn_swish}
    for c in counters.values():
        c.launches = 0
    state, metrics = step(state, batch, 0)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    expected = {"fused_depth_loss": 1, "fused_depth_loss_bwd": 1,
                "upsample_conv": 4, "depthwise_bn_swish": 0}
    if launches != expected:
        raise RuntimeError(f"training step launches {launches}, expected "
                           f"{expected}")
    # The same batch and augmentation for FALL_STEPS steps: the loss on it
    # must fall (drop-connect masks still change from step to step).
    draws = draw_augmentation(torch.Generator().manual_seed(1), TRAIN_BATCH)
    losses = [metrics["loss"]]
    for _ in range(FALL_STEPS):
        state, metrics = step(state, batch, 0, draws=draws)
        losses.append(metrics["loss"])
    losses = [float(v) for v in losses]
    first, last = np.mean(losses[1:4]), np.mean(losses[-3:])
    if not (np.isfinite(losses).all() and last < first):
        raise RuntimeError(f"bf16 training loss did not fall: {losses}")
    after = model.state_dict()
    moved = [k for k in ("E._conv_stem.weight", "D.up4.conv1.weight",
                         "R.conv2.weight", "E._bn0.running_mean",
                         "D.up4.bn1.running_var", "R.bn0.running_var")
             if not torch.equal(before[k], after[k])]
    if len(moved) != 6 or after["R.conv2.weight"].dtype != torch.float32:
        raise RuntimeError(f"weights/statistics that moved: {moved}")
    log("6 train", f"bf16 step at batch {TRAIN_BATCH} ({FRAME_HW} uint8 in, "
        f"{INPUT_HW} crop): launches {launches}; loss {losses[0]:.4f}, then "
        f"{FALL_STEPS} steps on one augmented batch "
        + " ".join(f"{v:.4f}" for v in losses[1:])
        + f" (mean of the first 3 {first:.4f} > last 3 {last:.4f}); "
        "f32 weights and BN statistics moved")
    return state, step, batch, launches


def step_phase_ms(state, batch, seed: int, reps: int = 5) -> dict:
    """Device ms between CUDA events around the phases of one bf16 step,
    as ``make_train_step`` runs them, averaged over ``reps`` steps."""
    model = state.model.train()
    names = ("preprocess", "forward", "loss", "backward", "optimizer",
             "metrics")
    totals = dict.fromkeys(names, 0.0)
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        aug_seed, drop_seed = step_seeds(seed, state.step)
        ev[0].record()
        draws = draw_augmentation(torch.Generator().manual_seed(aug_seed),
                                  TRAIN_BATCH)
        images, depths = train_preprocess(batch["image"], batch["depth"],
                                          draws)
        ev[1].record()
        params = {k: v.to(torch.bfloat16)
                  for k, v in model.named_parameters()}
        drop_gen = torch.Generator(device=DEVICE).manual_seed(drop_seed)
        out = torch.func.functional_call(
            model, params, (images.to(torch.bfloat16),),
            {"generator": drop_gen})
        ev[2].record()
        loss = fused_depth_loss(out, depths, batch["num_valid"])
        ev[3].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[4].record()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        ev[5].record()
        with torch.no_grad():
            depth_metrics_batch(out.detach(), depths, batch["num_valid"])
        ev[6].record()
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            totals[name] += ev[i].elapsed_time(ev[i + 1]) / reps
    return totals


def _self_device_us(event) -> float:
    return getattr(event, "self_device_time_total", 0.0)


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device ms of one ``fn()`` call replayed from a CUDA graph of
    ``iters`` calls: the call's kernels (and memsets) without the host's
    launch cost, which a loop of eager calls would time instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


PROFILER_TRIES = 5


def kernel_busy(fn, calls: int = 2) -> tuple:
    """Device busy ms per ``fn()`` call (the union of the kernels' intervals
    in a ``torch.profiler`` trace of ``calls`` calls, after one unprofiled
    call), device records per call, and the operators with the most device
    time per call.

    Every ``fn`` here launches kernels, so a trace without device records
    is the tracer's loss, not the program's: CUPTI now and then returns an
    empty activity buffer for one session among the dozens a run opens.
    Such a trace is taken again, a second later, up to PROFILER_TRIES
    times in all; if none holds a device record, this raises."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILER_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans:
            break
        log("profiler", f"trace {attempt} of {PROFILER_TRIES} holds no "
            "device record; tracing again")
        time.sleep(1.0)
    else:
        raise RuntimeError(f"the profiler saw no kernel on the card in "
                           f"{PROFILER_TRIES} traces")
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    ops = sorted(((e.key, _self_device_us(e) / calls / 1e3)
                  for e in prof.key_averages()
                  if e.key.startswith("aten::") and _self_device_us(e) > 0),
                 key=lambda kv: -kv[1])
    return busy / calls / 1e3, len(spans) / calls, ops[:8]


def loss_bound(ops_per_px: int, bytes_per_px: int) -> tuple[float, float]:
    """(bytes time, operations time) in ms of one launch at the training
    shape: bf16 pred and f32 target read once; the forward also writes
    (N, 4) f32 sums, the backward a bf16 dp (in bytes_per_px)."""
    px = TRAIN_BATCH * LOSS_HW[0] * LOSS_HW[1]
    nbytes = px * bytes_per_px + TRAIN_BATCH * 4 * 4
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * px * ops_per_px / F32_OPS_PER_S


def phase_train_time(card, state, step, batch) -> dict:
    """(c) images/s, the step's phases, the loss kernels, peak memory."""
    for _ in range(WARMUP):
        step(state, batch, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        step(state, batch, 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log("6 train", f"{card}: bf16 training at batch {TRAIN_BATCH}: "
        f"{TRAIN_BATCH * ITERS / dt:.1f} images/s ({1e3 * dt / ITERS:.2f} ms "
        f"per step, host clock, batch already on the card), peak memory "
        f"{peak / 2**30:.2f} GiB")
    parts = step_phase_ms(state, batch, 0)
    log("6 train", f"{card}: step phases, device ms between CUDA events: "
        + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.2f}")
    busy_ms, records, top_ops = kernel_busy(lambda: step(state, batch, 0))
    log("6 train", f"{card}: kernels busy {busy_ms:.2f} ms per step "
        f"(torch.profiler, {records:.0f} kernel and copy records a step); "
        f"against the {1e3 * dt / ITERS:.2f} ms step "
        f"without the profiler, device idle share "
        f"{1 - busy_ms / (1e3 * dt / ITERS):.3f}; most device ms per step: "
        + ", ".join(f"{k} {v:.2f}" for k, v in top_ops))

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    pred, target = loss_inputs(torch.bfloat16, gen)
    mask = torch.ones(TRAIN_BATCH, device=DEVICE)
    coef = torch.full((1,), 1.0 / pred.numel(), device=DEVICE)
    res = {}
    for name, kernel, plain, bound in (
            ("fused_depth_loss",
             lambda: fused_depth_loss_fwd(pred, target),
             lambda: fused_depth_loss_fwd_plain(pred, target),
             loss_bound(LOSS_FWD_OPS_PER_PX, 2 + 4)),
            ("fused_depth_loss_bwd",
             lambda: fused_depth_loss_bwd(pred, target, mask, coef),
             lambda: fused_depth_loss_bwd_plain(pred, target, mask, coef),
             loss_bound(LOSS_BWD_OPS_PER_PX, 2 + 4 + 2))):
        # ms: the kernel's device time, replayed from a CUDA graph; the
        # wrapper's whole call, host included, is what CUDA events over a
        # loop of eager calls see.
        ms = graph_ms(kernel)
        call_ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        tb, to = bound
        res[name] = dict(ms=ms, graph_ms=ms, plain_ms=plain_ms, bytes=tb,
                         ops=to)
        log("6 train", f"{card}: {name} ({TRAIN_BATCH},{LOSS_HW[0]},"
            f"{LOSS_HW[1]}) bf16 pred: kernel {ms:.4f} ms (CUDA graph), "
            f"wrapper call {call_ms:.4f} ms (CUDA events), plain "
            f"{plain_ms:.4f} ms, bound {max(tb, to):.4f} ms "
            f"({'bytes' if tb >= to else 'operations'}, kernel "
            f"{ms / max(tb, to):.1f}x)")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # f32 comparisons mean f32: no TF32 in cuDNN convs or matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase_build()
    card = phase_card()
    model = load_any_checkpoint(CHECKPOINT, device=DEVICE)
    dw_sites, up_sites, einsum_sites = main_path_sites(model)
    if (len(dw_sites), len(up_sites)) != (16, 4):
        raise RuntimeError(f"found {len(dw_sites)} depthwise and "
                           f"{len(up_sites)} direct upsample-conv sites")
    errs = phase_kernels(model, dw_sites, up_sites)
    for name in NEW_SHAPE_CONFIGS:
        other = random_model(name)
        sites = main_path_sites(other)
        counts = (len(sites[0]), len(sites[1]))
        if counts != RANDOM_CONFIGS[name][3]:
            raise RuntimeError(f"found {counts} kernel sites in {name}")
        for key, e in phase_kernels(other, *sites[:2], name).items():
            errs[key] = max(errs[key], e)
        del other, sites
    errs.update(phase_loss_kernels())
    serve, frames, launches = phase_serve(model)
    res, rate = phase_time(model, serve, frames, card, dw_sites, up_sites,
                           einsum_sites)
    configs = [dict(name="ENB0-HU", launches=dict(launches), **rate)]
    del serve, model
    phase_train_fixture()
    state, step, batch, train_launches = phase_train_steps()
    res.update(phase_train_time(card, state, step, batch))
    launches.update({k: train_launches[k] for k in ("fused_depth_loss",
                                                    "fused_depth_loss_bwd")})
    del state, step, batch
    configs.append(phase_lr(frames, card))
    for name in RANDOM_CONFIGS:
        configs.append(phase_random(name, frames, card))
    for c in configs:
        c["card"] = card

    # ms: each kernel timed as its first version was, so that a change of
    # method moves no figure: CUDA events over eager calls for the serving
    # kernels, CUDA-graph replay for the loss pair; graph_ms: the replay,
    # the device time alone, for all four.
    kernels = []
    for name, key, source, replaces in (
            ("depthwise_bn_swish", "depthwise",
             "efficientdepthestimation_tpu_torch/csrc/depthwise_bn_swish.cu",
             "efficientdepthestimation_tpu/ops/pallas/depthwise.py:120"),
            ("upsample_conv", "upsample_conv",
             "efficientdepthestimation_tpu_torch/csrc/upsample_conv.cu",
             "efficientdepthestimation_tpu/ops/pallas/upproj.py:171"),
            ("fused_depth_loss", "fused_depth_loss",
             "efficientdepthestimation_tpu_torch/csrc/fused_depth_loss.cu",
             "efficientdepthestimation_tpu/ops/pallas/fused_loss.py:126"),
            ("fused_depth_loss_bwd", "fused_depth_loss_bwd",
             "efficientdepthestimation_tpu_torch/csrc/fused_depth_loss.cu",
             "efficientdepthestimation_tpu/ops/pallas/fused_loss.py:146")):
        r = res[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[key], "ms": r["ms"],
            "graph_ms": r["graph_ms"], "plain_ms": r["plain_ms"], "bound_ms": max(r["bytes"], r["ops"]),
            "bound_by": "bytes" if r["bytes"] >= r["ops"] else "operations",
            "library_ms": None})
    print(json.dumps({"configs": configs}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
