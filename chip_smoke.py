#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ENB0-HU serving on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one output line each (more for the per-site detail):

  1. build both hand-written kernels with nvcc and print their registers,
     shared memory and spills (``-Xptxas -v``);
  2. print the card's name and power limit (nvidia-smi);
  3. hold each kernel against its plain PyTorch version at every shape the
     ENB0-HU serving path gives it, at batch 128, in bf16 and f32;
  4. load ``e2e/ENB0-HU-synthetic.ede``, check the f32 forward against the
     JAX reference fixture, then serve 128 uint8 480×640 frames in bf16
     through ``make_serving_fn`` and check shape, finiteness, kernel
     launches (16 depthwise + 4 upsample-conv per forward) and agreement
     with the fixture;
  5. time steady-state frames/s, the stages of the forward, each kernel and
     its plain version per site, and peak device memory.

It prints a JSON line of per-kernel figures, then, as its last line,
``{"ok": true, "device": {...}}``. Any failure raises, so the script exits
non-zero without that line; so does a machine without a CUDA card.
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

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
    make_infer_fn,
    make_serving_fn,
)
from efficientdepthestimation_tpu_torch.data.transforms import (
    eval_preprocess_image_only,
)
from efficientdepthestimation_tpu_torch.models.efficientnet import MBConvBlock
from efficientdepthestimation_tpu_torch.models.hu2018 import UpProjection
from efficientdepthestimation_tpu_torch.ops.fused import should_fuse
from efficientdepthestimation_tpu_torch.ops.kernels import build
from efficientdepthestimation_tpu_torch.ops.kernels.depthwise import (
    depthwise_bn_swish,
    depthwise_bn_swish_plain,
)
from efficientdepthestimation_tpu_torch.ops.kernels.upproj import (
    upsample_conv,
    upsample_conv_plain,
)
from efficientdepthestimation_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "e2e", "ENB0-HU-synthetic.ede")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_enb0_hu.npz")
BATCH = 128
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


def main_path_sites(model) -> tuple[list[dict], list[dict]]:
    """The shapes the serving forward gives each kernel, read off one
    forward at batch 1 on the card, with the module's own weights."""
    dw_sites, up_sites = [], []

    def on_block(block, args):
        (x,) = args
        _, h, w, cin = x.shape
        dw_sites.append(dict(
            name=f"E._blocks.{len(dw_sites)}", hw=(h, w), c=cin * block.expand,
            k=block._depthwise_conv.weight.shape[-1], stride=block.stride,
            pad=block.pad, block=block))

    def on_up(module, args):
        x, size = args
        if should_fuse(tuple(x.shape[1:3]), tuple(size), x.shape[-1],
                       module.features):
            return
        up_sites.append(dict(module=module, hw=tuple(x.shape[1:3]),
                             c=x.shape[-1], size=tuple(size),
                             o=2 * module.features))

    names = {m: n for n, m in model.named_modules()}
    hooks = [m.register_forward_pre_hook(on_block) for m in model.modules()
             if isinstance(m, MBConvBlock)]
    hooks += [m.register_forward_pre_hook(on_up) for m in model.modules()
              if isinstance(m, UpProjection)]
    with torch.inference_mode():
        model(torch.zeros(1, *INPUT_HW, 3, device=DEVICE))
    for h in hooks:
        h.remove()
    for s in up_sites:
        s["name"] = names[s.pop("module")]
    return dw_sites, up_sites


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
    logs = build.build(["depthwise_bn_swish", "upsample_conv"])
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("1 build", f"{name}: {line.strip()}")
    log("1 build", f"ok: both kernels built for sm_90a in "
                   f"{time.perf_counter() - t0:.1f} s")


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log("2 card", out)
    return out


def phase_kernels(model, dw_sites, up_sites) -> dict:
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
                if dtype == torch.bfloat16:
                    errs["depthwise"] = max(errs["depthwise"], e)
                log("3 kernels", f"depthwise {s['name']} {dtype} x=({BATCH},"
                    f"{s['hw'][0]},{s['hw'][1]},{s['c']}) k{s['k']} "
                    f"s{s['stride']}: max|y-plain|={e:.3g} "
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
                log("3 kernels", f"upsample_conv {s['name']} {dtype} "
                    f"x=({BATCH},{s['hw'][0]},{s['hw'][1]},{s['c']}) -> "
                    f"{s['size']}x{s['o']}: max|y-plain|={e:.3g}")
    log("3 kernels", f"ok: {len(dw_sites)} depthwise and {len(up_sites)} "
                     "upsample_conv sites agree with the plain versions in "
                     f"f32 and bf16; (rtol, atol): {TOL}")
    return errs


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
    depthwise_bn_swish.launches = 0
    upsample_conv.launches = 0
    out = serve(frames)
    torch.cuda.synchronize()
    launches = {"depthwise_bn_swish": depthwise_bn_swish.launches,
                "upsample_conv": upsample_conv.launches}
    if launches != {"depthwise_bn_swish": 16, "upsample_conv": 4}:
        raise RuntimeError(f"main path launches {launches}, expected 16 + 4")
    if tuple(out.shape) != (BATCH, *FRAME_HW, 1):
        raise RuntimeError(f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("non-finite depth in the bf16 serving output")
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


def phase_time(model, serve, frames, card, dw_sites, up_sites) -> dict:
    for _ in range(WARMUP):
        serve(frames)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        serve(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log("5 time", f"{card}: serving {BATCH}x{FRAME_HW} bf16: "
                  f"{BATCH * ITERS / dt:.1f} frames/s ({1e3 * dt / ITERS:.2f}"
                  f" ms per batch, host clock), peak memory "
                  f"{peak / 2**30:.2f} GiB")

    mb = copy.deepcopy(model).to(torch.bfloat16)
    with torch.inference_mode():
        x = eval_preprocess_image_only(frames).to(torch.bfloat16)
        taps = mb.E(x)
        x_d = mb.D(taps)
        size = tuple(x_d.shape[1:3])
        x_mff = mb.MFF(taps, size)
        x_r = torch.cat([x_d, x_mff], dim=-1)
        out = mb.R(x_r).float()
        stages = {
            "preprocess": lambda: eval_preprocess_image_only(frames),
            "E": lambda: mb.E(x), "D": lambda: mb.D(taps),
            "MFF": lambda: mb.MFF(taps, size), "R": lambda: mb.R(x_r),
            "upsample": lambda: resize_bilinear_align_corners(out, FRAME_HW),
        }
        parts = {k: cuda_ms(fn, 5) for k, fn in stages.items()}
    log("5 time", f"{card}: stage device ms at batch {BATCH}: "
        + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    res = {"depthwise": dict(ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0,
                             grouped_ms=0.0),
           "upsample_conv": dict(ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0)}
    with torch.inference_mode():
        for s in dw_sites:
            args = dw_inputs(s, torch.bfloat16, gen)
            kw = dict(stride=s["stride"], padding=s["pad"])
            ms = cuda_ms(lambda: depthwise_bn_swish(*args, **kw))
            plain = cuda_ms(lambda: depthwise_bn_swish_plain(*args, **kw))
            (pt, pb), (pl, pr) = s["pad"]
            xp = F.pad(args[0], (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
            wk = args[1].permute(2, 0, 1).unsqueeze(1).contiguous()
            grouped = cuda_ms(lambda: F.conv2d(xp, wk, stride=s["stride"],
                                               groups=s["c"]))
            tb, to = dw_bound(s)
            r = res["depthwise"]
            r["ms"] += ms
            r["plain_ms"] += plain
            r["bytes"] += tb
            r["ops"] += to
            r["grouped_ms"] += grouped
            log("5 time", f"depthwise {s['name']} ({BATCH},{s['hw'][0]},"
                f"{s['hw'][1]},{s['c']}) k{s['k']} s{s['stride']}: kernel "
                f"{ms:.4f} ms, plain {plain:.4f} ms, bound {max(tb, to):.4f} "
                f"ms ({'bytes' if tb >= to else 'operations'}, kernel "
                f"{ms / max(tb, to):.1f}x), cuDNN grouped conv alone "
                f"(partial yardstick) {grouped:.4f} ms")
        for s in up_sites:
            x, k = up_inputs(s, model, torch.bfloat16, gen)
            ms = cuda_ms(lambda: upsample_conv(x, k, s["size"]))
            plain = cuda_ms(lambda: upsample_conv_plain(x, k, s["size"]))
            tb, to = up_bound(s)
            r = res["upsample_conv"]
            r["ms"] += ms
            r["plain_ms"] += plain
            r["bytes"] += tb
            r["ops"] += to
            log("5 time", f"upsample_conv {s['name']} ({BATCH},{s['hw'][0]},"
                f"{s['hw'][1]},{s['c']}) -> {s['size']}x{s['o']}: kernel "
                f"{ms:.4f} ms ({to * BF16_OPS_PER_S / ms / 1e12:.1f} TFLOP/s), "
                f"plain {plain:.4f} ms, bound {max(tb, to):.4f} "
                f"ms ({'bytes' if tb >= to else 'operations'})")
    for name, r in res.items():
        log("5 time", f"{card}: {name} per forward: kernel {r['ms']:.3f} ms, "
            f"plain {r['plain_ms']:.3f} ms, bound "
            f"{max(r['bytes'], r['ops']):.3f} ms")
    log("5 time", f"{card}: cuDNN grouped conv alone over the depthwise "
        f"sites (partial yardstick): {res['depthwise']['grouped_ms']:.3f} ms")
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
    dw_sites, up_sites = main_path_sites(model)
    if (len(dw_sites), len(up_sites)) != (16, 4):
        raise RuntimeError(f"found {len(dw_sites)} depthwise and "
                           f"{len(up_sites)} direct upsample-conv sites")
    errs = phase_kernels(model, dw_sites, up_sites)
    serve, frames, launches = phase_serve(model)
    res = phase_time(model, serve, frames, card, dw_sites, up_sites)

    kernels = []
    for name, key, source, replaces in (
            ("depthwise_bn_swish", "depthwise",
             "efficientdepthestimation_tpu_torch/csrc/depthwise_bn_swish.cu",
             "efficientdepthestimation_tpu/ops/pallas/depthwise.py:120"),
            ("upsample_conv", "upsample_conv",
             "efficientdepthestimation_tpu_torch/csrc/upsample_conv.cu",
             "efficientdepthestimation_tpu/ops/pallas/upproj.py:171")):
        r = res[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[key], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(r["bytes"], r["ops"]),
            "bound_by": "bytes" if r["bytes"] >= r["ops"] else "operations",
            "library_ms": None})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
