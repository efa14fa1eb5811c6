#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card: ENB0-HU serving and training,
the route of each Hu2018 decoder site timed both ways, serving of the other
released configurations and of DN161-HU and SN154-HU, evaluation,
reference ``.pth`` checkpoints served and run through the apps, the
training CLI, the user-centred benchmark, the data-parallel mesh, the
serving forms with their policy, the kernels as registered ops,
constant-baked serving and the ahead-of-time serving artifact, and
spatial (row-sharded) serving.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one output line each (more for the per-site detail):

  1. build the three hand-written kernel sources with nvcc and print their
     registers, shared memory and spills (``-Xptxas -v``) and the torch
     version whose ``torch.library`` registers their ops, and the loss
     kernels' f32 and MUFU operations a pixel counted in their SASS, which
     must be the counts ``LOSS_*_PER_PX`` hold; build the native host
     libraries (``native/csrc/*.cpp``: the batch decoder, the PNG, JPEG and
     MJPEG encoders) with g++ and print whether each built, the headers g++
     finds (``png.h``, ``jpeglib.h``) and the compiler's message if one
     did not: with both headers there, a failed build raises;
  2. print the card's name and power limit (nvidia-smi);
  3. hold each kernel against its plain PyTorch version at every shape the
     ENB0-HU serving path gives it, and at the shapes ENB4-HU (32
     depthwise sites), RN50-HU, DN161-HU and SN154-HU give it (every
     Hu2018 decoder site of these four, whichever route ``should_fuse``
     gives it), at batch 128, in bf16 and f32 (the depthwise SE sums
     bitwise equal across launches), and the loss kernel pair at the
     training shape (64, 114, 152); then, at every Hu2018 decoder site of
     ENB0-HU, ENB4-HU, RN50-HU, DN161-HU and SN154-HU, both routes of the
     UpProjection (the kernel and the einsum rewrite) by CUDA-graph
     replay beside the composition, bf16 at batch 128 (ENB0-HU's also
     f32 at batch 8 and 1, bf16 at batch 8, f32 at the video's 456×608,
     and forward plus backward in bf16 at the training batch), and which
     is faster against the route ``should_fuse`` takes;
  4. load ``e2e/ENB0-HU-synthetic.ede``, check the f32 forward against the
     JAX reference fixture, then serve 128 uint8 480×640 frames in bf16
     through ``make_serving_fn`` and check shape, finiteness, kernel
     launches (16 depthwise + 5 upsample-conv per forward) and agreement
     with the fixture;
  5. time steady-state frames/s, the card's kernel busy time and idle
     share in a serving call (``torch.profiler``), the stages of the
     forward (CUDA events, and their kernels' busy time), each kernel and
     its plain version per site (the kernel as CUDA events over a loop of
     eager calls, and as a CUDA-graph replay, its device time alone; its
     GB/s or TFLOP/s and the share of its bound; beside the upsample-conv
     kernel, cuDNN's interpolate + conv as a yardstick), and peak device
     memory;
  6. train: one f32 step against the JAX training fixture; bf16 steps at
     batch 64 through ``make_train_step`` (launches of one step: 1 loss
     forward, 1 loss backward, 5 upsample-conv, 0 depthwise; a finite loss
     that falls over 10 steps on a fixed batch; weights and BN statistics
     move); then images/s, the device ms of the step's phases, the launch
     floor (an empty kernel by CUDA-graph replay) and each loss kernel
     beside its bytes bound, its MUFU floor, that floor and its plain
     version, and peak device memory;
  7. ENB0-LR from ``e2e/ENB0-LR-synthetic.ede`` (a MidasNet): the f32
     forward against its JAX fixture, bf16 serving of phase 4's 128 frames
     (shape, finiteness, 16 depthwise + 0 upsample-conv launches,
     agreement with the fixture), then as phase 5: frames/s, busy time and
     idle share, the stages, peak memory;
  8. ENB4-HU, ENB4-LR, RN50-HU, RN50-LR, DN161-HU and SN154-HU at full
     width and depth with seeded random weights
     (``models.common.randomize_``): bf16 serving of the same frames with
     each one's exact launches, its bf16 output against its f32 forward on
     the card, frames/s, busy time and idle share, the stages, peak
     memory, and the kernels' times at the shapes the Hu2018 ones give
     them;
  9. evaluation: ENB0-HU and ENB0-LR from their ``.ede`` in f32 over the
     first 60 test pairs of ``generate_dataset(seed=0)``, built in memory,
     through ``apps.evaluate.evaluate_dataset`` at batch 8 and 1, each
     against the JAX evaluation fixture (depth metrics, δ, edge
     averages), with exact launches a forward (16 + 2, 16 + 0), batch 1
     against batch 8, eval images/s, busy time, idle share and peak memory
     (and the stretch of the batch-1 pass where the peak arises); each
     model's kernels against their plain versions at batch 8 and 1, f32 at
     the f32 route's sites and bf16 at the bf16 route's; the batch-1
     serving latency of each; ENB0-HU's kernels' f32 batch-1 times;
     ``test_nyu``'s compute at batch 8 against the f32 forward; and
     ``inference_benchmark``'s trials of both checkpoints (bf16, batch 8;
     the first of each with exact launches);
 10. reference ``.pth`` checkpoints and the apps: each configuration of
     phases 4-8 written as the reference released it (HU: a raw
     ``state_dict`` under ``module.``, SN154-HU's SE keys in the released
     ``se_`` form; LR: MidasNet's self-describing dict), ENB0-HU and
     ENB0-LR from their ``.ede``, the others with phase 8's weights,
     loaded onto the card by ``load_any_checkpoint`` (load ms; every
     tensor equal to its source), one bf16 serving call of phase 4's
     frames each with exact launches, bit for bit as its source served
     (ENB0-HU's and ENB0-LR's as loaded from their ``.ede``); then from
     ENB0-HU's ``.pth`` the apps' array
     paths: demo (batch 1, f32, against the CPU; latency), point_clouds (8
     frames, the points against ``unproject_depth`` on the CPU; frames/s),
     depth_video (16 frames at batch 8: the preprocess against the CPU, the
     kernels at its 456×608 sites, exact launches, frames/s, peak memory)
     and inference's ``peak_memory`` at batch 8;
 11. the training CLI (``apps.train.main``): the kernels against their
     plain versions at the shapes its eval epoch (f32, batch 64) and
     training (bf16, batch 64) give them; ``generate_dataset`` written to
     a temp directory (128 train and 16 test 480×640 PNG pairs, timed);
     ENB0-HU from its ``.ede`` (``--init-from``, ``--bf16``, batch 64, one
     epoch) uninterrupted, stopped after one step and resumed, with
     deterministic cuDNN (the final train states bit for bit), and again
     without it; the launches of every training and eval epoch, exact;
     ``log.jsonl``; the best checkpoint and ENB0-LR's through the CLI
     served in bf16 with exact launches; the rolling save and load ms; the
     CLI's images/s with PNG decode and the loader and its peak memory;
     ``load_batch`` (the native decoder) against the PIL decode of every
     pair of both splits, bit for bit; the loader's pairs/s on each decode
     route and the CLI epoch's images/s and device idle share on each, in
     turns (the PIL route by reporting the native decoder unavailable in
     this process); then bf16 ENB0-HU steps under remat none, full and
     dots at batch 64 and ``accum_steps=2`` at 128 (exact launches,
     images/s, peak memory), each held against the plain step in f32 at
     batch 8 (drop-connect on, deterministic cuDNN; accumulation by the
     duplicated-microbatch rule); RN50-HU, RN50-LR, DN161-HU and SN154-HU
     bf16 steps at batch 64 with random weights (exact launches, a falling
     loss, images/s, peak memory);
 12. the user-centred benchmark (``benchmark.harness.main``): the kernels
     against their plain versions at the sites ENB0-HU's and ENB0-LR's f32
     forwards of the benchmark's 224×320 frames give them, at batch 4 and
     at the remainder 654 test pairs leave (2), and ENB0-HU's timed at
     batch 4; 8 test pairs of ``generate_dataset`` written with the NYU
     ``camera.json`` (cut from 654 for time; fps 60, 303 views a sample,
     mesh density 8, supersample 3 uncut); a seeded stand-in for the LPIPS
     weights; ``main`` on the card with ENB0-HU, ENB0-LR and the flat
     baseline: each model's depth-map launches exact, every output file
     there, a second ``main`` hitting every cache with the same table; the
     ``.raw`` depths against the port's CPU forward, the card's renders of
     one sample against the CPU's (all three engines) and against the
     golden rasterizer's floors, SSIM, PSNR and LPIPS against the CPU;
     each engine's ms a view, views/s, busy time, idle share and peak
     memory over a sweep, the phases' seconds and each model's
     ``frame_time`` and peak memory; ``create_rendered_images`` of every
     sample on the native encode route (MJPEG AVI, libpng stills) and on
     the cv2/PIL route, each's ``render_time``, the stills equal on both,
     the AVI read back by cv2 with every view and within ENCODE_MEAN_ABS
     of the rendered frames. Without matplotlib on the machine,
     ``visualise_results`` is left out, and the phase says so;
 13. parallelism (``parallel``): an NCCL process group of one rank (its
     ``all_reduce`` checked), and on its mesh ENB0-HU from its ``.ede``:
     a bf16 step at batch 64 with exact launches, images/s and device idle
     share beside the mesh-less step's (in turns); an f32 step at batch 8
     with deterministic cuDNN and drop-connect on, bit for bit the
     mesh-less step; three ZeRO-1 steps whose Adam moments equal plain
     Adam's bit for bit; a ZeRO-1 train state saved, loaded into a plain
     state, and the next step of each bit for bit; mesh serving of phase
     4's frames, bit for bit the mesh-less call with 16 + 5 launches. Then
     two processes share the card over gloo with CUDA tensors (NCCL refuses
     two ranks on one device), each launched as ``chip_smoke.py
     --parallel-rank R`` with a ``file://`` store: an f32 step at batch 8
     (4 a rank, drop-connect on) against the one-process step on the whole
     batch, within ``PARALLEL_TOL``; then bf16 at batch 64 (32 a rank),
     images/s of the global batch and the milliseconds each kind of
     collective takes (BN statistics, gradient buckets, metrics), and the
     training CLI's epoch loop (``apps.train.run_train_epoch``: its
     loader, prefetch, metrics read one step behind and the stop flag
     reduced on the host at every step boundary) a step beside the bare
     step's, with the flag's reduction alone.
 14. serving forms (``apps.common``, ``apps.autotune``): a configuration
     of each encoder and decoder family (FORMS_CONFIGS: ENB0-HU and ENB0-LR
     from their ``.ede``, RN50-HU, DN161-HU and SN154-HU with phase 8's
     weights) serve phase 4's frames in bf16 in each form:
     monolithic, staged under each MFF merge (Hu2018), and the depthwise
     modes "xla" and "shift" (EfficientNet encoders), each with exact
     launches, within phase 5's bf16 tolerances of the monolithic output
     (ENB0-HU's also of the JAX fixture), its frames/s, idle share and
     peak memory; ENB0-HU at batches 256, 512 and 1024 in one call and in
     tiles of half (256 also tiled-staged), frames/s and peak; that
     ``make_serving_fn`` serves its rule's form; int8 at RN50-HU,
     SN154-HU, DN161-HU and ENB0-HU: each quantized conv's int8 time
     against cuDNN's bf16 conv by graph replay, then the int8 forward's
     launches, frames/s and ``rel_out_err`` against the float output (at
     most ``INT8_REL_MAX``); ``autotune_serving`` for ENB0-HU
     at batch 128 into a policy that ``make_serving_fn`` must then follow,
     and ``autotune_train`` for ENB0-HU at batch 64, whose winner the
     training CLI's ``--train-policy`` must resolve to; the phase's
     seconds.
 15. the kernels as registered ops, constant-baked serving and the serving
     artifact: ``torch.library.opcheck`` of the ``ede::`` ops on the card
     at every distinct shape ENB0-HU's serving path gives the depthwise
     and upsample-conv ops (batch 128, bf16 and f32) and at the loss
     pair's training shape; phase 14's configurations served unbaked and
     baked (``bake_weights``) in bf16 at batch 128, each with exact
     launches, each within phase 5's bf16 tolerances of the model's own
     f32 forward, the baked f32 forward within FOLD_REL_MAX of the
     unbaked one, the baked bf16 output within twice phase 5's bf16
     tolerances of the unbaked one (and within them of the JAX fixture
     for ENB0-HU and ENB0-LR), and for both frames/s, busy ms, idle share, element-wise kernel ms and peak
     memory; ENB0-HU exported baked at batch 128 in bf16
     (``checkpoints.export``: export seconds, bytes), loaded and served in
     a fresh ``python3`` that imports no model, app or checkpoint-reader
     module (load seconds, 16 + 5 launches, frames/s beside the live
     baked ``make_serving_fn``'s, the maximum difference from it), a
     dynamic-batch artifact at batch 1 and 128, and an arg-weight artifact
     rebound to a second random tree against the live fn on that tree;
     then the ops' own dispatch cost (ENB0-HU's batch-1 f32 kernel
     launches through the ops against their CUDA implementations called
     as plain functions, host clock), the ENB0-HU batch-1 f32 latency,
     batch-128 bf16 frames/s and bf16 training images/s
     (``dispatch_ab.py``), and with
     ``--parent-tree DIR`` the same of the tree in DIR (a ``git archive``
     of another commit), parent, this, this, parent, each in a process of
     its own.
 16. spatial serving (``make_serving_fn(mesh=..., spatial=True)``,
     ``parallel.spatial``): the upsample-conv kernel's row window at every
     band two ranks own of ENB0-HU's kernel sites (batch 4, bf16 and f32)
     against its plain version and the whole-image kernel's rows, with
     ``opcheck`` of ``ede::upsample_conv_window``, each rank's windows
     timed beside their bound; then two processes share the card over
     gloo (``chip_smoke.py --spatial-rank R``, as phase 13's): ENB0-HU and
     ENB0-LR from their ``.ede`` serve the fixture's frames row-sharded at
     batch 1 and 4 in f32 and bf16, each rank with exact launches, the
     gathered depth against the one-rank fn's (f32 within
     SPATIAL_F32_ATOL m, bf16 within phase 5's limits), each rank's
     batch-1 latency and its all-reduces beside one rank's latency.
 17. the end-to-end rehearsal: ``scripts/run_e2e_torch.py`` in a
     subprocess at a reduced size (E2E_ARGS; the dataset, ENB0-HU and
     ENB0-LR each trained to a real SIGTERM and resumed, the LR fine-tune,
     evaluate, test_nyu, inference_benchmark, the benchmark harness with
     five entrants, the study materials); its outcomes read back (each
     preempted run and its resumed best checkpoint, the staged HU and LR
     checkpoints loaded, evaluate at batch 1 against batch 4, finite
     benchmark rows, the study files); then from its staged HU
     checkpoint, counted from 0, one f32 training step on its data (0 + 2
     + 1 + 1 launches) and one f32 eval batch (16 + 2); the wall seconds
     of each of its phases.

It prints a JSON line of each phase's wall seconds, a JSON line of phase
17's figures, a JSON line of phase 16's
figures, a JSON line of phase 15's
figures, a JSON line of the serving
forms, a JSON line of the native
libraries' build, a JSON line of the parallelism figures, a JSON line of
the routes' times, a JSON line of the evaluation figures, a JSON line of
the ``.pth`` and app figures, a JSON line of the training CLI's figures, a
JSON line of the benchmark's figures, a JSON line of per-configuration
figures, the card's name and power limit, a JSON line of per-kernel
figures, then, as its last line, ``{"ok": true, "device":
{...}}``. Any failure raises, so the script exits non-zero without that
line; so does a machine without a CUDA card.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import datetime
import functools
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from efficientdepthestimation_tpu_torch import (
    MIDAS_CHECKPOINT_VERSION,
    native,
)
from efficientdepthestimation_tpu_torch.apps import train as train_app
from efficientdepthestimation_tpu_torch.apps.autotune import (
    autotune_serving,
    autotune_train,
    build_serving_candidate,
)
from efficientdepthestimation_tpu_torch.apps.common import (
    MFF_MERGES,
    load_any_checkpoint,
    make_infer_fn,
    make_serving_fn,
    serving_form,
)
from efficientdepthestimation_tpu_torch.apps.demo import depth_of
from efficientdepthestimation_tpu_torch.apps.depth_video import (
    CROP_HW as VIDEO_INPUT_HW,
    HEIGHT as VIDEO_HEIGHT,
    WIDTH as VIDEO_WIDTH,
    depth_frames,
    preprocess as video_preprocess,
)
from efficientdepthestimation_tpu_torch.apps.evaluate import (
    EDGE_KEYS,
    evaluate_dataset,
)
from efficientdepthestimation_tpu_torch.apps.inference_benchmark import (
    SUMMARY_COLUMNS,
    benchmark_row,
    summarize,
)
from efficientdepthestimation_tpu_torch.apps.test_nyu import (
    MAX_DEPTH_M,
    depth_maps_mm,
)
from efficientdepthestimation_tpu_torch.apps.point_clouds import (
    INPUT_HW as PC_INPUT_HW,
    cloud_of,
)
from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    to_jax_leaf,
    to_jax_variables,
)
from efficientdepthestimation_tpu_torch.checkpoints.export import (
    load_serving_artifact,
    save_serving_artifact,
)
from efficientdepthestimation_tpu_torch.checkpoints.pth_import import (
    reference_state_dict,
)
from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
    load_checkpoint,
    load_train_state,
    read_ede,
    save_train_state,
)
from efficientdepthestimation_tpu_torch.data.datasets import (
    DepthPairDataset,
    batch_iterator,
)
from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
    TEST_SEED_OFFSET,
    eval_pair,
    generate_dataset,
    synthetic_train_set,
)
from efficientdepthestimation_tpu_torch.data.transforms import (
    demo_preprocess,
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
from efficientdepthestimation_tpu_torch.models.midas import MidasNet
from efficientdepthestimation_tpu_torch.models.registry import build_model
from efficientdepthestimation_tpu_torch.models.senet import SENetFeatures
from efficientdepthestimation_tpu_torch.native import build as native_build
from efficientdepthestimation_tpu_torch.native import (
    encoder as native_encoder,
)
from efficientdepthestimation_tpu_torch.ops import quant
from efficientdepthestimation_tpu_torch.ops.conv import conv2d
from efficientdepthestimation_tpu_torch.ops.fused import (
    should_fuse,
    upsample_conv_pair,
)
from efficientdepthestimation_tpu_torch.ops.kernels import (
    build,
    depthwise,
    upproj,
)
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
    upsample_conv_window,
    upsample_conv_window_plain,
)
from efficientdepthestimation_tpu_torch.ops.quant import (
    quantized_convs,
    should_quantize,
)
from efficientdepthestimation_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
)
from efficientdepthestimation_tpu_torch.parallel import (
    create_mesh,
    gather_rows,
    maybe_initialize_distributed,
    process_local_rows,
    spatial_sharding,
)
from efficientdepthestimation_tpu_torch.parallel.mesh import any_rank
from efficientdepthestimation_tpu_torch.parallel.spatial import (
    owned_rows,
    upsample_conv_rows,
)
from efficientdepthestimation_tpu_torch.training.metrics import (
    depth_metrics_batch,
)
from efficientdepthestimation_tpu_torch.training.train_step import (
    create_train_state,
    make_train_step,
    step_lr,
    step_seeds,
)
from efficientdepthestimation_tpu_torch.utils.pointcloud import (
    NYU_V2_INTRINSICS_HALF,
    unproject_depth,
)
from efficientdepthestimation_tpu_torch.utils.profiling import peak_memory

import dispatch_ab

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "e2e", "ENB0-HU-synthetic.ede")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_enb0_hu.npz")
TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                             "torch_train_enb0_hu.npz")
LR_CHECKPOINT = os.path.join(ROOT, "e2e", "ENB0-LR-synthetic.ede")
LR_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_enb0_lr.npz")
EVAL_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_eval_enb0.npz")
# Launches of one ENB0-HU forward (depthwise, upsample-conv) under
# should_fuse's routes: in bf16 (serving, training) the kernel takes D.up2-4
# and MFF.up1-2, in f32 (evaluation, the apps, also at the video's 456×608)
# D.up4 and MFF.up1.
ENB0_HU_LAUNCHES, ENB0_HU_F32_LAUNCHES = (16, 5), (16, 2)
# Phase 9 evaluates each checkpoint (fixture prefix, launches of one
# forward: depthwise, upsample-conv) on the first EVAL_PAIRS test pairs of
# generate_dataset(seed=0) at each of EVAL_BATCHES, in f32, as
# tests/make_torch_eval_fixture.py does in the JAX package.
EVAL_CONFIGS = {"ENB0-HU": (CHECKPOINT, "hu", ENB0_HU_F32_LAUNCHES),
                "ENB0-LR": (LR_CHECKPOINT, "lr", (16, 0))}
EVAL_PAIRS, EVAL_BATCHES = 60, (8, 1)
EVAL_SUM_KEYS = ("mae", "mse", "abs_rel", "log10", "delta1", "delta2",
                 "delta3", "batch_size")
EVAL_TRACKER_KEYS = ("mae", "mse", "abs_rel", "log10", "delta1", "delta2",
                     "delta3", "rmse")
LATENCY_CALLS = 20  # batch-1 serving calls timed one by one
PEAK_STAGES = 4  # stretches of the largest peak memory printed
BENCH_TRIALS = 2
# The configurations phase 8 serves with random weights: (encoder, decoder,
# randomize_ seed, launches of one forward: depthwise, upsample-conv).
RANDOM_CONFIGS = {
    "ENB4-HU": ("efficientnet-b4", "hu2018", 4, (32, 5)),
    "ENB4-LR": ("efficientnet-b4", "lasinger2019", 5, (32, 0)),
    "RN50-HU": ("resnet50", "hu2018", 6, (0, 1)),
    "RN50-LR": ("resnet50", "lasinger2019", 7, (0, 0)),
    "DN161-HU": ("densenet161", "hu2018", 8, (0, 0)),
    "SN154-HU": ("senet154", "hu2018", 9, (0, 1)),
}
# The configurations that give the kernels shapes ENB0-HU does not
# (ENB4-LR's encoder is ENB4-HU's).
NEW_SHAPE_CONFIGS = ("ENB4-HU", "RN50-HU", "DN161-HU", "SN154-HU")
F32_CHECK_FRAMES = 8  # frames of phase 8's f32 reference forward
# Phase 10 writes each released configuration as a reference .pth (the
# two with an .ede from it, the others with phase 8's random weights) and
# serves it; the apps run from ENB0-HU's: demo on one frame, point_clouds
# on APP_FRAMES, depth_video on VIDEO_FRAMES at VIDEO_BATCH (the app's
# default batch), inference's peak memory at VIDEO_BATCH.
PTH_CONFIGS = {"ENB0-HU": ("efficientnet-b0", "hu2018", None,
                           ENB0_HU_LAUNCHES),
               "ENB0-LR": ("efficientnet-b0", "lasinger2019", None, (16, 0)),
               **RANDOM_CONFIGS}
APP_FRAMES = 8
VIDEO_FRAMES, VIDEO_BATCH = 16, 8
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
# CUDA-graph replay of each route at each Hu2018 decoder site: calls
# captured in the graph, and replays timed.
ROUTE_ITERS, ROUTE_REPLAYS = 5, 2

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
# Phase 9's evaluation in f32 on the card against the JAX package's on the
# CPU (tests/fixtures/torch_eval_enb0.npz), TF32 off. A CPU run of the port
# over the same 60 pairs (both models, batch 8 and 1) shows the depth
# metrics (MAE, MSE, REL, LOG10, RMSE) within 4.6e-7 relative, δ1-δ3
# within 2.4e-7 and the edge averages within 2.8e-6 absolute; the card's
# convolutions sum in other orders, so depth metrics to 1e-4 relative, and
# δ and edge averages, which count pixels on either side of a threshold (one
# pixel is 1/69,312 of an image), to 2e-3 (~140 pixels an image). LOG10 is
# compared at the same batch size only: the reference does not scale it by
# the batch (util.py:68). Batch 1 against batch 8 on the card: the same.
EVAL_DEPTH_RTOL, EVAL_COUNT_ATOL = 1e-4, 2e-3
# Phase 10. Points: unproject_depth on the card against the CPU on the same
# depth, f32 element-wise products and quotients whose divisor PyTorch's
# CUDA kernel may apply as a product with its reciprocal (1 ulp, 6e-8):
# 1e-6 relative. depth_video's preprocess: a value within rounding of .5
# that rounded to the other uint8 level would move 1/255 of the range
# before the two divisions by the std and 255, so at most
# 1/(255·0.224·255) = 6.9e-5; the port against JAX on the CPU (16 frames,
# 480x640 and 300x500) differs by 2.8e-9 at most, with no level flipped.
POINT_RTOL = 1e-6
PREPROCESS_ATOL = 7e-5
# The preprocess is checked on the fixture's 480x640 frames, where its
# Scale to 640x480 is the identity, and on the same frames resized on the
# host to a 1080p video's 1080x1920 and to 300x500, which go through it
# as downsamples, and to 200x300 and 96x128, which go through it as
# upsamples: each pass ops.resize._pil_pass's elementwise sums in XLA's
# CPU order, the same bits on the card as on the CPU.
PREPROCESS_HWS = ((480, 640), (1080, 1920), (300, 500), (200, 300),
                  (96, 128))
# Loss kernel pair vs its plain versions, same inputs on the card.
#   sums: per-image sums of 17,328 O(1) terms, added in another order
#         (threads, warps, a cluster's blocks) than the plain reduction,
#         the logs and the normal term's 1/sqrt(a·b) (the Pallas kernel's
#         form) by the approximate MUFU functions (absolute error below
#         2^-22 a term) against the plain log and sqrt(a)·sqrt(b): rtol
#         1e-5, atol 1e-2; the masked mean then agrees to 1e-5.
#   dp f32: the same formula with other FMA contractions and the MUFU
#         reciprocals (1-2 ulp); 1e-4 relative and 1e-5 of the largest
#         |dp| absolute (terms cancel).
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
# Operations a pixel of the loss pair, counted in the SASS of each
# kernel's per-quad loop (``cuobjdump -sass`` of the built library; phase 1
# counts them in this run's build and fails if they differ from these): f32
# operations on the CUDA cores
# (67 TFLOP/s; an FFMA counts 2) and MUFU operations (lg2, rsq, rcp) on the
# special-function units, 16 a clock an SM (132 SMs at 1.98 GHz). The
# backward's per-pixel counts include its A/B loop.
LOSS_FWD_OPS_PER_PX, LOSS_BWD_OPS_PER_PX = 45, 66
LOSS_FWD_MUFU_PER_PX, LOSS_BWD_MUFU_PER_PX = 4, 5
MUFU_OPS_PER_S = 132 * 16 * 1.98e9

# Phase 11: the training CLI on generate_dataset's PNGs (192 train and 16
# test pairs would take 19-23 s to write at the 0.090-0.110 s a pair this
# phase measures on the card's host, more than the ~20 s it can spare, so
# 128 train pairs), at the main path's batch. Launches
# (depthwise, upsample-conv, loss forward, loss backward) of one bf16
# ENB0-HU step under each policy: the recompute runs the upsample-conv
# kernel again (its output is no aten operation a policy could keep), each
# microbatch runs the forward and the loss (tests/test_torch_gpu.py and
# tests/test_torch_train_accum_remat.py count the same); RN50-HU's and
# SN154-HU's D.up4 is their one kernel site, RN50-LR and DN161-HU have none.
CLI_TRAIN_PAIRS, CLI_TEST_PAIRS, CLI_BATCH = 128, 16, 64
# The loader alone is timed LOADER_REPEATS times on each route, in turns.
LOADER_REPEATS = 2
KERNEL_COUNTERS = {"depthwise_bn_swish": depthwise_bn_swish,
                   "upsample_conv": upsample_conv,
                   "fused_depth_loss": fused_depth_loss_fwd,
                   "fused_depth_loss_bwd": fused_depth_loss_bwd}
TRAIN_STEP_LAUNCHES = {"none": (0, 5, 1, 1), "full": (0, 10, 1, 1),
                       "dots": (0, 10, 1, 1), "accum2": (0, 10, 2, 2)}
RANDOM_STEP_LAUNCHES = {"RN50-HU": (0, 1, 1, 1), "RN50-LR": (0, 0, 1, 1),
                        "DN161-HU": (0, 0, 1, 1), "SN154-HU": (0, 1, 1, 1)}
POLICY_WARMUP, POLICY_ITERS = 2, 5
FALL_STEPS_RANDOM = 5
# Remat and accumulation against the plain step in f32 at CHECK_BATCH with
# deterministic cuDNN: the recompute repeats the forward's operations, so
# the loss and BN statistics are compared bit for bit and the gradients,
# which the backward sums in another grouping where a recompute feeds it,
# to REMAT_TOL of each leaf's largest value.
CHECK_BATCH, REMAT_TOL = 8, 1e-5


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


def main_path_sites(model, input_hw: tuple[int, int] = INPUT_HW,
                    dtype=torch.bfloat16
                    ) -> tuple[list[dict], list[dict], list[dict]]:
    """The shapes a forward of ``input_hw`` images gives each kernel, read
    off one forward at batch 1 on the card, with the module's own weights;
    and the UpProjection sites where ``should_fuse`` takes the einsum route
    instead of the kernel in a ``dtype`` forward."""
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
                            module.features, dtype)
        (einsum_sites if fused else up_sites).append(dict(
            module=module, hw=tuple(x.shape[1:3]), c=x.shape[-1],
            size=tuple(size), o=2 * module.features))

    hooks = [m.register_forward_pre_hook(on_block) for m in model.modules()
             if isinstance(m, MBConvBlock)]
    hooks += [m.register_forward_pre_hook(on_up) for m in model.modules()
              if isinstance(m, UpProjection)]
    with torch.inference_mode():
        model(torch.zeros(1, *input_hw, 3, device=DEVICE))
    for h in hooks:
        h.remove()
    for s in up_sites + einsum_sites:
        s["name"] = names[s.pop("module")]
    return dw_sites, up_sites, einsum_sites


def dw_inputs(site: dict, dtype, gen, batch: int = BATCH) -> tuple:
    block = site["block"]
    h, w = site["hw"]
    x = torch.randn(batch, h, w, site["c"], generator=gen, device=DEVICE)
    taps = block._depthwise_conv.weight[:, 0].permute(1, 2, 0)
    scale, bias = block._bn1.folded()
    return (x.to(dtype), taps.to(dtype).contiguous(), scale.contiguous(),
            bias.contiguous())


def up_inputs(site: dict, model, dtype, gen, batch: int = BATCH) -> tuple:
    up = model.get_submodule(site["name"])
    h, w = site["hw"]
    x = torch.randn(batch, h, w, site["c"], generator=gen, device=DEVICE)
    k = torch.cat([up.conv1.weight, up.conv2.weight], 0).permute(2, 3, 1, 0)
    return x.to(dtype), k.to(dtype).contiguous()


def dw_out_hw(site: dict) -> tuple[int, int]:
    (pt, pb), (pl, pr) = site["pad"]
    h, w = site["hw"]
    k, s = site["k"], site["stride"]
    return (h + pt + pb - k) // s + 1, (w + pl + pr - k) // s + 1


def dw_bound(site: dict, batch: int = BATCH, itemsize: int = 2
             ) -> tuple[float, float]:
    """(bytes time, operations time) in ms of one launch at ``batch`` with
    x, taps and y of ``itemsize`` bytes (2: bf16, 4: f32)."""
    h, w = site["hw"]
    oh, ow = dw_out_hw(site)
    c, k = site["c"], site["k"]
    nbytes = ((batch * h * w * c + k * k * c + batch * oh * ow * c)
              * itemsize + 2 * c * 4 + batch * c * 4)
    ops = batch * oh * ow * c * (2 * k * k + 2)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S


def up_ops(site: dict, batch: int = BATCH) -> int:
    """Operations of the conv5×5 at the upsampled size (2 a multiply-add)."""
    hh, ww = site["size"]
    return 2 * batch * hh * ww * 25 * site["c"] * site["o"]


def up_bound(site: dict, batch: int = BATCH, itemsize: int = 2
             ) -> tuple[float, float]:
    """As ``dw_bound``; the operations at the peak of their type: bf16 on
    the tensor cores, f32 on the CUDA cores."""
    h, w = site["hw"]
    hh, ww = site["size"]
    c, o = site["c"], site["o"]
    nbytes = (batch * h * w * c + 25 * c * o + batch * hh * ww * o) * itemsize
    ops = up_ops(site, batch)
    rate = BF16_OPS_PER_S if itemsize == 2 else F32_OPS_PER_S
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / rate


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
                   f"{time.perf_counter() - t0:.1f} s; torch "
                   f"{torch.__version__} (CUDA {torch.version.cuda}), the "
                   "kernels registered as torch.library.custom_op ops "
                   "(ede::)")
    counts = loss_sass_counts()
    expected = {"fwd": (LOSS_FWD_OPS_PER_PX, LOSS_FWD_MUFU_PER_PX),
                "bwd": (LOSS_BWD_OPS_PER_PX, LOSS_BWD_MUFU_PER_PX)}
    for kind, c in counts.items():
        log("1 build", f"fused_depth_loss {kind} SASS (bf16, 16-byte path; "
            f"{c['loops']:.0f} innermost loop(s) with MUFU): {c['f32']:g} f32 "
            f"operations and {c['mufu']:g} MUFU operations a pixel")
        if (c["f32"], c["mufu"]) != expected[kind]:
            raise RuntimeError(
                f"fused_depth_loss {kind}: the SASS holds {c['f32']:g} f32 and "
                f"{c['mufu']:g} MUFU operations a pixel, LOSS_*_PER_PX "
                f"{expected[kind]}: recount and update them")


def phase_native_build() -> dict:
    """1b: the native host libraries (``native/csrc/*.cpp``) built with g++
    into ``_build/`` and loaded; the headers the build needs, as g++ finds
    them. A failed build with both headers present raises; without them
    the PIL and cv2 routes run, as in the JAX package, and this says so."""
    found = native_build.headers()
    out = {"headers": found}
    for name, mod in (("batch_loader", native), ("encode", native_encoder)):
        t0 = time.perf_counter()
        path = mod.build_library()
        seconds = time.perf_counter() - t0
        ok = path is not None and mod.is_available()
        out[name] = dict(built=ok, seconds=seconds, error=mod.build_error())
        if not ok and all(found.values()):
            raise RuntimeError(f"native {name}: png.h and jpeglib.h are "
                               f"found but the build failed: "
                               f"{mod.build_error()}")
    out["available"] = out["batch_loader"]["built"] and \
        out["encode"]["built"]
    log("1 build", "native host libraries: headers found by g++ "
        + ", ".join(f"{h} {'yes' if v else 'NO'}" for h, v in found.items())
        + "; " + "; ".join(
            f"{name} " + (f"built and loaded in {r['seconds']:.1f} s"
                          if r["built"] else
                          f"NOT built (the PIL/cv2 route runs): {r['error']}")
            for name, r in out.items() if name in ("batch_loader", "encode")))
    return out


@contextlib.contextmanager
def native_off():
    """The native decoder and encoder reported unavailable in this process
    for the block, so that every caller takes its PIL or cv2 route."""
    saved = native.is_available, native_encoder.is_available
    native.is_available = native_encoder.is_available = lambda: False
    try:
        yield
    finally:
        native.is_available, native_encoder.is_available = saved


def sass_loops(sass: str, kernel: str) -> dict[str, float]:
    """Operations a pixel in the SASS of ``kernel``'s bf16 vector-path
    instance: the instructions of each innermost loop that holds MUFU
    operations (a pass of ``slide`` takes 3 rows of a 4-pixel quad), over
    12. ``mufu`` counts MUFU instructions, ``f32`` FADD and FMUL as 1 and
    FFMA as 2."""
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        if kernel in name and "__nv_bfloat16" in name and "Lb1E" in name:
            break
    else:
        raise RuntimeError(f"no bf16 vector {kernel} in the SASS")
    insts = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in (
        re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                 r"(.*)", line) for line in body.splitlines()) if m]
    ops = [op for _, op, _ in insts]
    start = {addr: i for i, (addr, _, _) in enumerate(insts)}
    loops = []  # (first, last) instruction of each backward branch's loop
    for i, (addr, op, rest) in enumerate(insts):
        m = re.match(r"\s*(0x[0-9a-f]+)", rest)
        if op == "BRA" and m and int(m.group(1), 16) <= addr:
            loops.append((start[int(m.group(1), 16)], i))
    mufu_loops = [(a, b) for a, b in loops
                  if any(op.startswith("MUFU") for op in ops[a:b + 1])]
    inner = [(a, b) for a, b in mufu_loops
             if not any((c, d) != (a, b) and a <= c and d <= b
                        for c, d in mufu_loops)]
    counts = {"mufu": 0.0, "f32": 0.0}
    for a, b in inner:
        for op in ops[a:b + 1]:
            counts["mufu"] += op.startswith("MUFU")
            counts["f32"] += (2 if op.startswith("FFMA") else
                              op.startswith(("FADD", "FMUL")))
    return {k: v / 12 for k, v in counts.items()} | {"loops": len(inner)}


def loss_sass_counts() -> dict[str, dict[str, float]]:
    """The loss kernels' operations a pixel, from ``cuobjdump -sass`` of
    this run's build (the counts LOSS_*_PER_PX hold)."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build._target(
        "fused_depth_loss"))], capture_output=True, text=True, check=True,
        timeout=120).stdout
    return {"fwd": sass_loops(sass, "loss_fwd_kernel"),
            "bwd": sass_loops(sass, "loss_bwd_kernel")}


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log("2 card", out)
    return out


def phase_kernels(model, dw_sites, up_sites, label: str = "ENB0-HU",
                  batch: int = BATCH, phase: str = "3 kernels",
                  dtypes=(torch.float32, torch.bfloat16)) -> dict:
    """Each kernel against its plain version at every site of ``model`` at
    ``batch``, in each of ``dtypes``; returns each dtype's worst error a
    kernel, ``{dtype: {"depthwise": e, "upsample_conv": e}}``."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    errs = {dtype: {"depthwise": 0.0, "upsample_conv": 0.0}
            for dtype in dtypes}
    with torch.inference_mode():
        for dtype in dtypes:
            tol = TOL[("depthwise", dtype)]
            for s in dw_sites:
                args = dw_inputs(s, dtype, gen, batch)
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
                errs[dtype]["depthwise"] = max(errs[dtype]["depthwise"], e)
                log(phase, f"{label} depthwise {s['name']} {dtype} "
                    f"x=({batch},{s['hw'][0]},{s['hw'][1]},{s['c']}) "
                    f"k{s['k']} s{s['stride']}: max|y-plain|={e:.3g} "
                    f"max|sums-plain|={es:.3g}")
            tol = TOL[("upsample_conv", dtype)]
            for s in up_sites:
                x, k = up_inputs(s, model, dtype, gen, batch)
                y = upsample_conv(x, k, s["size"])
                y_ref = upsample_conv_plain(x, k, s["size"])
                torch.cuda.synchronize()
                e = check_close(s["name"], y, y_ref, tol["y"])
                errs[dtype]["upsample_conv"] = max(
                    errs[dtype]["upsample_conv"], e)
                log(phase, f"{label} upsample_conv {s['name']} "
                    f"{dtype} x=({batch},{s['hw'][0]},{s['hw'][1]},"
                    f"{s['c']}) -> {s['size']}x{s['o']}: "
                    f"max|y-plain|={e:.3g}")
    names = " and ".join(str(d).removeprefix("torch.") for d in dtypes)
    log(phase, f"ok: {label}'s {len(dw_sites)} depthwise and "
               f"{len(up_sites)} upsample_conv sites at batch {batch} agree "
               f"with the plain versions in {names}, depthwise sums "
               f"bitwise equal across launches; (rtol, atol): {TOL}")
    return errs


def loss_inputs(dtype, gen) -> tuple[torch.Tensor, torch.Tensor]:
    """(pred, target) at the training shape: image 0 flat in both, image 1
    with pred == target, the rest uniform in 1-9 m on a grid of 2^-8 m
    (``loss_grid``)."""
    shape = (TRAIN_BATCH, *LOSS_HW)
    target = loss_grid(torch.rand(shape, generator=gen, device=DEVICE))
    pred = loss_grid(torch.rand(shape, generator=gen, device=DEVICE))
    pred[0] = target[0] = 3.0
    pred[1] = target[1]
    return pred.to(dtype).contiguous(), target


def loss_grid(u: torch.Tensor) -> torch.Tensor:
    """Uniform ``u`` in [0, 1) to 1-9 m on a grid of 2^-8 m. There every
    Sobel sum is exact in f32, in any order of addition, so the kernels
    and the plain versions see the same zero differences, where the
    gradient of |e| jumps from -2 to 2 (on continuous data a difference
    within rounding of 0 can fall on either side in the two). The values
    keep up to 12 significant bits, which a kernel that staged f32 at
    bf16's 8 would lose."""
    return torch.round((u * 8 + 1) * 256) / 256


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


def counted(fn, expected: tuple[int, int], what: str) -> tuple:
    """``fn()`` with the serving kernels' counts set to 0 just before it
    and read just after: it must launch each kernel exactly ``expected`` =
    (depthwise, upsample-conv) times. Returns its result and the
    launches."""
    counters = {"depthwise_bn_swish": depthwise_bn_swish,
                "upsample_conv": upsample_conv}
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    if tuple(launches.values()) != tuple(expected):
        raise RuntimeError(f"{what}: launches {launches}, expected "
                           f"{expected[0]} + {expected[1]}")
    return out, launches


def serve_counted(serve, frames, name: str, expected: tuple[int, int]
                  ) -> tuple[torch.Tensor, dict]:
    """One serving call, ``counted``: exactly ``expected`` launches, and
    finite depth at frame size."""
    out, launches = counted(lambda: serve(frames), expected,
                            f"{name} serving")
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
    serve = make_serving_fn(model, upsample_to=FRAME_HW,
                            dtype=torch.bfloat16, preprocess=True,
                            device=DEVICE)
    out, launches = serve_counted(serve, frames, "ENB0-HU",
                                  ENB0_HU_LAUNCHES)
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
    yardstick for the kernel's time only (the port never calls it). The
    batch goes through in slices whose upsampled tensor stays below 2^31
    elements, the most ``F.interpolate`` takes."""
    xc = x.permute(0, 3, 1, 2)  # NHWC memory, channels-last NCHW view
    w = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    step = max(1, (2**31 - 1) // (x.shape[-1] * size[0] * size[1]))
    ys = [F.conv2d(F.interpolate(xc[i:i + step], size=size, mode="bilinear",
                                 align_corners=True), w, padding=2)
          for i in range(0, x.shape[0], step)]
    return ys[0] if len(ys) == 1 else torch.cat(ys)


def serving_rate(serve, frames, card, phase: str, label: str,
                 top_ops: bool = True) -> dict:
    """frames/s and ms per batch on the host clock over ITERS calls after
    WARMUP, the peak device memory of those calls, the card's kernel busy
    time and idle share in two traced calls (``idle_share``) and, with
    ``top_ops``, the operators with the most device time
    (``kernel_busy``)."""
    for _ in range(WARMUP):
        serve(frames)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    for _ in range(ITERS):
        serve(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = dict(frames_per_s=BATCH * ITERS / dt, ms_per_batch=1e3 * dt / ITERS,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                held_gib=held)
    with torch.inference_mode():
        idle, busy, traced, records = idle_share(lambda: serve(frames))
        rate.update(busy_ms=busy, idle_share=idle, traced_ms=traced)
        top = kernel_busy(lambda: serve(frames))[2] if top_ops else []
    log(phase, f"{card}: {label} serving {BATCH}x{FRAME_HW} bf16: "
        f"{rate['frames_per_s']:.1f} frames/s ({rate['ms_per_batch']:.2f} ms "
        f"per batch, host clock), peak memory {rate['peak_gib']:.2f} GiB "
        f"({held:.2f} GiB held before the calls); kernels busy {busy:.2f} "
        f"ms of a traced {traced:.2f} ms per batch (torch.profiler, "
        f"{records:.0f} kernel and copy records a call, device records "
        f"alone): device idle share {idle:.3f}"
        + ("; most device ms per batch: "
           + ", ".join(f"{k} {v:.2f}" for k, v in top[:5]) if top_ops
           else ""))
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
               label: str, dtype=torch.bfloat16, batch: int = BATCH) -> dict:
    """Each kernel at each site of a model, ``dtype`` at ``batch`` (by
    default bf16 at BATCH): its ms (CUDA
    events over a loop of eager wrapper calls, as the first versions of
    these kernels were timed: what a serving forward pays, host included
    where the host is slower than the kernel), its CUDA-graph replay (the
    device time alone), its plain version, bound and yardstick; summed per
    forward."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    itemsize = torch.finfo(dtype).bits // 8
    res = {"depthwise": dict(ms=0.0, graph_ms=0.0, plain_ms=0.0, bytes=0.0,
                             ops=0.0, grouped_ms=0.0),
           "upsample_conv": dict(ms=0.0, graph_ms=0.0, plain_ms=0.0,
                                 bytes=0.0, ops=0.0, composition_ms=0.0)}
    with torch.inference_mode():
        for s in dw_sites:
            args = dw_inputs(s, dtype, gen, batch)
            kw = dict(stride=s["stride"], padding=s["pad"])
            ms = cuda_ms(lambda: depthwise_bn_swish(*args, **kw))
            graph = graph_ms(lambda: depthwise_bn_swish(*args, **kw))
            plain = cuda_ms(lambda: depthwise_bn_swish_plain(*args, **kw))
            (pt, pb), (pl, pr) = s["pad"]
            xp = F.pad(args[0], (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
            wk = args[1].permute(2, 0, 1).unsqueeze(1).contiguous()
            grouped = cuda_ms(lambda: F.conv2d(xp, wk, stride=s["stride"],
                                               groups=s["c"]))
            tb, to = dw_bound(s, batch, itemsize)
            r = res["depthwise"]
            r["ms"] += ms
            r["graph_ms"] += graph
            r["plain_ms"] += plain
            r["bytes"] += tb
            r["ops"] += to
            r["grouped_ms"] += grouped
            gbs = tb * HBM_BYTES_PER_S / 1e9 / ms
            log(phase, f"{card}: {label} depthwise {s['name']} ({batch},"
                f"{s['hw'][0]},{s['hw'][1]},{s['c']}) k{s['k']} "
                f"s{s['stride']}: kernel {ms:.4f} ms ({gbs:.0f} GB/s; "
                f"CUDA graph {graph:.4f} ms), plain "
                f"{plain:.4f} ms, bound {max(tb, to):.4f} ms "
                f"({'bytes' if tb >= to else 'operations'}; share of bound "
                f"reached {max(tb, to) / ms:.3f}), cuDNN grouped conv alone "
                f"(partial yardstick) {grouped:.4f} ms")
        for s in up_sites:
            x, k = up_inputs(s, model, dtype, gen, batch)
            ms = cuda_ms(lambda: upsample_conv(x, k, s["size"]))
            graph = graph_ms(lambda: upsample_conv(x, k, s["size"]))
            plain = cuda_ms(lambda: upsample_conv_plain(x, k, s["size"]))
            comp = cuda_ms(lambda: composition(x, k, s["size"]))
            tb, to = up_bound(s, batch, itemsize)
            r = res["upsample_conv"]
            r["ms"] += ms
            r["graph_ms"] += graph
            r["plain_ms"] += plain
            r["bytes"] += tb
            r["ops"] += to
            r["composition_ms"] += comp
            log(phase, f"{card}: {label} upsample_conv {s['name']} ({batch},"
                f"{s['hw'][0]},{s['hw'][1]},{s['c']}) -> {s['size']}x"
                f"{s['o']}: kernel {ms:.4f} ms "
                f"({up_ops(s, batch) / ms / 1e9:.2f} TFLOP/s; CUDA "
                f"graph {graph:.4f} ms), composition_ms {comp:.4f} "
                f"(F.interpolate + cuDNN conv2d, channels-last {dtype}; "
                f"yardstick), plain {plain:.4f} ms, "
                f"bound {max(tb, to):.4f} ms ("
                f"{'bytes' if tb >= to else 'operations'}; share of bound "
                f"reached {max(tb, to) / ms:.3f})")
    for name, r in res.items():
        if not r["ms"]:
            continue
        bound = max(r["bytes"], r["ops"])
        yardstick = ("cuDNN grouped conv alone", r["grouped_ms"]) \
            if name == "depthwise" else ("composition_ms", r["composition_ms"])
        log(phase, f"{card}: {label} {name} per forward: kernel "
            f"{r['ms']:.3f} ms (CUDA events over eager calls; CUDA-graph "
            f"replay {r['graph_ms']:.3f}), plain {r['plain_ms']:.3f} ms, "
            f"bound {bound:.3f} ms, share of bound reached "
            f"{bound / r['ms']:.3f}; {yardstick[0]} {yardstick[1]:.3f} ms")
    return res


def phase_time(model, serve, frames, card, dw_sites, up_sites
               ) -> tuple[dict, dict]:
    rate = serving_rate(serve, frames, card, "5 time", "ENB0-HU")
    rate["stage_ms"] = stage_times(model, frames, card, "5 time", "ENB0-HU")
    res = time_sites(model, card, dw_sites, up_sites, "5 time", "ENB0-HU")
    log("5 time", f"{card}: cuDNN grouped conv alone over the depthwise "
        f"sites (partial yardstick): {res['depthwise']['grouped_ms']:.3f} ms")
    log("5 time", f"{card}: F.interpolate + cuDNN conv2d over the "
        f"upsample_conv sites (yardstick): composition_ms "
        f"{res['upsample_conv']['composition_ms']:.3f}")
    return res, rate


def route_calls(s: dict, model, dtype, gen, batch: int, backward: bool
                ) -> dict:
    """The three ways to compute site ``s``'s UpProjection branches at
    ``batch``: the hand-written kernel (both branches in one launch), the
    einsum rewrite (``upsample_conv_pair``) and the composition, each a
    call of no arguments. With ``backward`` each call is a forward and its
    backward to the input and the kernels, as a training step runs them
    (the kernel route's gradient is its VJP, the others' autograd's)."""
    f = s["o"] // 2
    x, k = up_inputs(s, model, dtype, gen, batch)
    x, k = x.detach(), k.detach()
    k1, k2 = k[..., :f].contiguous(), k[..., f:].contiguous()
    calls = {"kernel": lambda: upsample_conv(x, k, s["size"]),
             "einsum": lambda: upsample_conv_pair(x, k1, k2, s["size"]),
             "composition": lambda: composition(x, k, s["size"])}
    if not backward:
        return calls
    for t in (x, k, k1, k2):
        t.requires_grad_()
    g = torch.randn(batch, *s["size"], 2 * f, generator=gen,
                    device=DEVICE).to(dtype)
    g1, g2 = g[..., :f].contiguous(), g[..., f:].contiguous()
    return {"kernel": lambda: torch.autograd.grad(
                calls["kernel"](), (x, k), g),
            "einsum": lambda: torch.autograd.grad(
                calls["einsum"](), (x, k1, k2), (g1, g2)),
            "composition": lambda: torch.autograd.grad(
                calls["composition"](), (x, k), g.permute(0, 3, 1, 2))}


def route_times(name: str, model, card, dtype=torch.bfloat16,
                batch: int = BATCH, seen: set | None = None,
                input_hw: tuple[int, int] = INPUT_HW,
                backward: bool = False) -> list[dict]:
    """At every Hu2018 decoder site of ``model`` (D.up1-4, MFF.up1-4) for
    ``input_hw`` images, both routes of its UpProjection on the same
    inputs, ``dtype`` at ``batch``, by CUDA-graph replay: the hand-written
    kernel and the einsum rewrite, beside the composition ``F.interpolate``
    + cuDNN ``conv2d`` (a yardstick, never a route); the faster route, and
    the route ``should_fuse`` gives the site. With ``backward``, each
    route's forward and backward (``route_calls``) by CUDA events over a
    loop of eager calls, as the training step runs. A site whose shape is
    in ``seen`` (another configuration's) is not timed again."""
    _, kernel_sites, einsum_sites = main_path_sites(model, input_hw, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    timing = "eager forward+backward" if backward else "CUDA-graph replay"
    rows = []
    with torch.inference_mode(not backward):
        for s in sorted(kernel_sites + einsum_sites, key=lambda s: s["name"]):
            f = s["o"] // 2
            key = (s["hw"], s["size"], s["c"], f, str(dtype))
            if seen is not None:
                if key in seen:
                    continue
                seen.add(key)
            calls = route_calls(s, model, dtype, gen, batch, backward)
            times = {r: (cuda_ms(fn, ROUTE_ITERS) if backward
                         else graph_ms(fn, ROUTE_ITERS, ROUTE_REPLAYS))
                     for r, fn in calls.items()}
            faster = min(("kernel", "einsum"), key=times.get)
            chosen = "einsum" if s in einsum_sites else "kernel"
            rows.append(dict(config=name, site=s["name"], in_hw=s["hw"],
                             out_hw=s["size"], cin=s["c"], features=f,
                             dtype=str(dtype).removeprefix("torch."),
                             batch=batch, timing=timing, faster=faster,
                             route=chosen,
                             **{f"{r}_ms": t for r, t in times.items()}))
            log("3 routes", f"{card}: {name} {s['name']} {dtype} x=({batch},"
                f"{s['hw'][0]},{s['hw'][1]},{s['c']}) -> {s['size']}x{2 * f}"
                f": kernel {times['kernel']:.4f} ms, einsum "
                f"{times['einsum']:.4f} ms, composition (yardstick) "
                f"{times['composition']:.4f} ms ({timing}); faster: "
                f"{faster}; should_fuse's route: {chosen}")
            del calls
    return rows


def phase_other_sites(model, card) -> tuple[dict, list[dict]]:
    """3: each kernel against its plain version at the sites of the
    NEW_SHAPE_CONFIGS models (with random weights): their depthwise sites
    and every Hu2018 decoder site, whichever route ``should_fuse`` gives
    it; then ``route_times`` at every Hu2018 decoder site of ENB0-HU
    (``model``) and of those models, bf16 at BATCH, the serving shape,
    each shape once; and ENB0-HU's at the shapes of its other paths: f32
    at batch 8 and 1 (evaluation, demo), bf16 at batch 8
    (``inference_benchmark``), f32 at the video's input at its batch, and
    the training step's bf16 forward and backward at TRAIN_BATCH. Returns
    each kernel's worst bf16 error and the route rows; the models are
    freed on return."""
    errs = {"depthwise": 0.0, "upsample_conv": 0.0}
    models = {"ENB0-HU": model}
    for name in NEW_SHAPE_CONFIGS:
        models[name] = other = random_model(name)
        dw, kernel, einsum = main_path_sites(other)
        counts = (len(dw), len(kernel))
        if counts != RANDOM_CONFIGS[name][3]:
            raise RuntimeError(f"found {counts} kernel sites in {name}")
        for key, e in phase_kernels(other, dw, kernel + einsum,
                                    name)[torch.bfloat16].items():
            errs[key] = max(errs[key], e)
    seen, groups = set(), {}
    groups["bf16 batch 128"] = [
        r for name, other in models.items()
        for r in route_times(name, other, card, seen=seen)]
    for label, kw in (
            ("f32 batch 8", dict(dtype=torch.float32, batch=8)),
            ("f32 batch 1", dict(dtype=torch.float32, batch=1)),
            ("bf16 batch 8", dict(batch=8)),
            (f"f32 video {VIDEO_INPUT_HW} batch {VIDEO_BATCH}",
             dict(dtype=torch.float32, batch=VIDEO_BATCH,
                  input_hw=VIDEO_INPUT_HW)),
            (f"bf16 training batch {TRAIN_BATCH}",
             dict(batch=TRAIN_BATCH, backward=True))):
        groups[label] = route_times("ENB0-HU", model, card, **kw)
    for label, rows in groups.items():
        agree = sum(r["faster"] == r["route"] for r in rows)
        log("3 routes", f"{card}: {label}: should_fuse's route was the "
            f"faster one at {agree} of {len(rows)} sites")
    return errs, [r for rows in groups.values() for r in rows]


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

    serve = make_serving_fn(model, upsample_to=FRAME_HW,
                            dtype=torch.bfloat16, preprocess=True,
                            device=DEVICE)
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
    random weights of ``randomize_``, on the card: a copy of the host model
    ``random_host_model`` drew once."""
    return copy.deepcopy(random_host_model(name)).to(DEVICE)


@functools.lru_cache(maxsize=None)
def random_host_model(name: str) -> torch.nn.Module:
    """``randomize_`` of ``name`` on the host, drawn once a run: phases 3,
    8, 11, 14 and 15 take the same weights, and SN154-HU's draw alone
    takes seconds."""
    encoder, decoder, seed, _ = RANDOM_CONFIGS[name]
    return randomize_(build_model(encoder, decoder), seed)


def phase_random(name: str, frames, card) -> dict:
    """8: one configuration with random weights: bf16 serving with its
    exact launches, against its own f32 forward; frames/s, peak memory and,
    where it gives the kernels shapes of their own, their times."""
    expected = RANDOM_CONFIGS[name][3]
    model = random_model(name)
    serve = make_serving_fn(model, upsample_to=FRAME_HW,
                            dtype=torch.bfloat16, preprocess=True,
                            device=DEVICE)
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
                "upsample_conv": ENB0_HU_LAUNCHES[1],
                "depthwise_bn_swish": 0}
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


@functools.lru_cache(maxsize=None)
def side_stream() -> torch.cuda.Stream:
    """The one stream ``graph_ms`` warms its calls up on: PyTorch keeps a
    cuBLAS workspace for each stream a matmul ran on, for the process's
    life, so a new stream a call would hold more memory each time."""
    return torch.cuda.Stream()


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device ms of one ``fn()`` call replayed from a CUDA graph of
    ``iters`` calls: every device operation the call launches, its
    kernels and any fill or memset its wrapper adds beside them, without the
    host's launch cost, which a loop of eager calls would time instead."""
    side = side_stream()
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


def device_spans(prof) -> list[tuple[float, float]]:
    """The (start, end) µs of every device record of a profiler trace."""
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def union_us(spans: list[tuple[float, float]]) -> float:
    """µs covered by the union of sorted (start, end) intervals."""
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return busy + hi - lo


def _trace(fn, calls: int, activities) -> tuple:
    """A ``torch.profiler`` trace of ``calls`` calls of ``fn`` after one
    untraced call, its device records' sorted (start, end) µs and the
    host-clock seconds from the first traced call to the synchronize after
    the last, a window that holds every traced kernel.

    Every ``fn`` here launches kernels, so a trace without device records
    is the tracer's loss, not the program's: CUPTI now and then returns an
    empty activity buffer for one session among the dozens a run opens.
    Such a trace is taken again, a second later, up to PROFILER_TRIES
    times in all; if none holds a device record, this raises."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILER_TRIES + 1):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        spans = device_spans(prof)
        if spans:
            return prof, spans, window
        log("profiler", f"trace {attempt} of {PROFILER_TRIES} holds no "
            "device record; tracing again")
        time.sleep(1.0)
    raise RuntimeError(f"the profiler saw no kernel on the card in "
                       f"{PROFILER_TRIES} traces")


def kernel_busy(fn, calls: int = 2) -> tuple:
    """Device busy ms per ``fn()`` call (the union of the kernels' intervals
    in a trace of ``calls`` calls, ``_trace``), device records per call,
    and the operators with the most device time per call."""
    prof, spans, _ = _trace(fn, calls, [ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
    ops = sorted(((e.key, _self_device_us(e) / calls / 1e3)
                  for e in prof.key_averages()
                  if e.key.startswith("aten::") and _self_device_us(e) > 0),
                 key=lambda kv: -kv[1])
    return union_us(spans) / calls / 1e3, len(spans) / calls, ops[:8]


def idle_share(fn, calls: int = 2) -> tuple:
    """The device's idle share of ``fn()``'s time, its busy ms, the host
    ms and the device records per call, from one trace of ``calls`` calls
    (``_trace``) that records device activity alone: host-operator records
    would slow the host, and so stretch a host-paced ``fn``'s window. The
    kernels lie in the window, so the share lies in [0, 1)."""
    _, spans, window = _trace(fn, calls, [ProfilerActivity.CUDA])
    busy, host = union_us(spans) / calls / 1e3, 1e3 * window / calls
    if not 0 < busy <= host:
        raise RuntimeError(f"kernels busy {busy} ms in a {host} ms window")
    return 1 - busy / host, busy, host, len(spans) / calls


def loss_bound(ops_per_px: int, mufu_per_px: int, bytes_per_px: int
               ) -> dict:
    """Times in ms of one launch at the training shape: ``bytes``, bf16
    pred and f32 target read once (the forward also writes (N, 4) f32
    sums, the backward a bf16 dp, in bytes_per_px); ``ops``, its f32
    operations at 67 TFLOP/s; ``mufu``, its MUFU operations at
    MUFU_OPS_PER_S."""
    px = TRAIN_BATCH * LOSS_HW[0] * LOSS_HW[1]
    nbytes = px * bytes_per_px + TRAIN_BATCH * 4 * 4
    return {"bytes": 1e3 * nbytes / HBM_BYTES_PER_S,
            "ops": 1e3 * px * ops_per_px / F32_OPS_PER_S,
            "mufu": 1e3 * px * mufu_per_px / MUFU_OPS_PER_S}


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
    # What one launch costs the card: an empty kernel, replayed the same way.
    floor = graph_ms(lambda: torch.cuda._sleep(0))
    log("6 train", f"{card}: launch floor (an empty kernel, CUDA-graph "
        f"replay) {floor:.4f} ms")
    res = {}
    for name, kernel, plain, bound in (
            ("fused_depth_loss",
             lambda: fused_depth_loss_fwd(pred, target),
             lambda: fused_depth_loss_fwd_plain(pred, target),
             loss_bound(LOSS_FWD_OPS_PER_PX, LOSS_FWD_MUFU_PER_PX, 2 + 4)),
            ("fused_depth_loss_bwd",
             lambda: fused_depth_loss_bwd(pred, target, mask, coef),
             lambda: fused_depth_loss_bwd_plain(pred, target, mask, coef),
             loss_bound(LOSS_BWD_OPS_PER_PX, LOSS_BWD_MUFU_PER_PX,
                        2 + 4 + 2))):
        # ms: the call's device time, replayed from a CUDA graph; the
        # wrapper's whole call, host included, is what CUDA events over a
        # loop of eager calls see.
        ms = graph_ms(kernel)
        call_ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        ops = max(bound["ops"], bound["mufu"])
        res[name] = dict(ms=ms, graph_ms=ms, plain_ms=plain_ms,
                         bytes=bound["bytes"], ops=ops, floor_ms=floor)
        log("6 train", f"{card}: {name} ({TRAIN_BATCH},{LOSS_HW[0]},"
            f"{LOSS_HW[1]}) bf16 pred: kernel {ms:.4f} ms (CUDA graph), "
            f"wrapper call {call_ms:.4f} ms (CUDA events), plain "
            f"{plain_ms:.4f} ms; bytes bound {bound['bytes']:.4f} ms, MUFU "
            f"floor {bound['mufu']:.4f} ms, f32 operations "
            f"{bound['ops']:.4f} ms, launch floor {floor:.4f} ms (kernel "
            f"{ms / max(bound['bytes'], ops):.1f}x its bound, "
            f"{ms - floor:.4f} ms above the launch floor)")
    return res


def eval_pairs(fx) -> list[tuple[np.ndarray, np.ndarray]]:
    """The first EVAL_PAIRS test pairs of ``generate_dataset(seed=0)``,
    (uint8 RGB, uint16 mm), built in memory; their sums must be the
    fixture's."""
    pairs = [eval_pair(TEST_SEED_OFFSET + i) for i in range(EVAL_PAIRS)]
    sums = tuple(sum(int(p[k].sum(dtype=np.int64)) for p in pairs)
                 for k in (0, 1))
    if sums != (int(fx["frames_sum"]), int(fx["depths_sum"])):
        raise RuntimeError("evaluation pairs differ from the fixture's")
    return pairs


def quiet_eval(model, pairs, batch: int) -> dict:
    """``evaluate_dataset`` on the card without its progress line: the
    tracker's values and the edge averages in one dict."""
    with contextlib.redirect_stdout(io.StringIO()):
        tracker, edges = evaluate_dataset(model, pairs, batch, device=DEVICE)
    return tracker.to_dict() | edges


def eval_counted(model, pairs, batch: int, per_forward: tuple[int, int]
                 ) -> tuple[dict, dict, float]:
    """One timed evaluation of ``pairs`` at ``batch`` with the serving
    kernels' counts set to 0 just before it and read just after: each
    forward (one a batch, the padded tail's included) must launch exactly
    ``per_forward`` = (depthwise, upsample-conv). Returns the metrics, the
    launches and the host seconds (the loop reads each batch's sums back,
    so its end waits for the card)."""
    def timed():
        t0 = time.perf_counter()
        metrics = quiet_eval(model, pairs, batch)
        return metrics, time.perf_counter() - t0

    forwards = math.ceil(len(pairs) / batch)
    (metrics, dt), launches = counted(
        timed, tuple(forwards * n for n in per_forward),
        f"evaluation at batch {batch} ({forwards} forwards)")
    return metrics, launches, dt


def check_metrics(name: str, ours: dict, ref: dict, skip=()) -> dict:
    """Each metric of ``ref`` against ``ours``: δ and edge averages to
    EVAL_COUNT_ATOL absolute, the others to EVAL_DEPTH_RTOL relative;
    returns the errors, raises on one outside its tolerance."""
    errs = {}
    for k, v in ref.items():
        if k in skip:
            continue
        counted = k.startswith(("delta", "edge"))
        e = abs(ours[k] - v) / (1.0 if counted else abs(v))
        if not e <= (EVAL_COUNT_ATOL if counted else EVAL_DEPTH_RTOL):
            raise RuntimeError(f"{name}: {k} {ours[k]} against {v}")
        errs[k] = e
    return errs


def fixture_metrics(fx, prefix: str, batch: int) -> dict:
    return (dict(zip(EVAL_TRACKER_KEYS, fx[f"{prefix}/b{batch}/tracker"]))
            | dict(zip(EDGE_KEYS, fx[f"{prefix}/b{batch}/edge"])))


def serving_latency(serve, frame) -> dict:
    """ms of one serving call of one frame, each call timed alone on the
    host clock to its ``torch.cuda.synchronize()``, over LATENCY_CALLS
    calls after WARMUP."""
    for _ in range(WARMUP):
        serve(frame)
    torch.cuda.synchronize()
    times = []
    for _ in range(LATENCY_CALLS):
        t0 = time.perf_counter()
        serve(frame)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return dict(median_ms=float(np.median(times)),
                mean_ms=float(np.mean(times)), min_ms=float(np.min(times)))


def peak_by_stage(model, fn) -> list[tuple[str, float]]:
    """Where the card's peak memory in one call of ``fn`` arises: the
    peak above the memory allocated at the call's start, in GiB, in each
    stretch between two consecutive entries or exits of ``model``'s
    modules (read from the allocator's statistics, which it keeps as the
    host issues the work), largest first."""
    names = {m: n or "model" for n, m in model.named_modules()}
    stretches, last = [], ["start"]
    base = torch.cuda.memory_allocated()

    def mark(label: str) -> None:
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        stretches.append((f"{last[0]} .. {label}", peak))
        last[0] = label
        torch.cuda.reset_peak_memory_stats()

    hooks = []
    for m in model.modules():
        hooks.append(m.register_forward_pre_hook(
            lambda mod, args: mark(f"enter {names[mod]}")))
        hooks.append(m.register_forward_hook(
            lambda mod, args, out: mark(f"exit {names[mod]}")))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        fn()
        mark("end")
    finally:
        for h in hooks:
            h.remove()
    return sorted(stretches, key=lambda kv: -kv[1])


def phase_eval_model(name: str, pairs, fx, card) -> dict:
    """9: one checkpoint evaluated in f32 at each of EVAL_BATCHES against
    the JAX fixture, its kernels held against their plain versions at the
    sites of each of those batches (f32 at the f32 route's sites, bf16,
    which ``inference_benchmark`` serves, at the bf16 route's), batch 1
    against batch 8, where its batch-1 peak memory arises, then its
    batch-1 serving latency."""
    path, prefix, per_forward = EVAL_CONFIGS[name]
    model = load_any_checkpoint(path, device=DEVICE)
    dw_sites, up_sites, _ = main_path_sites(model, dtype=torch.float32)
    _, up_bf16, _ = main_path_sites(model)
    for sites, want in ((up_sites, per_forward),
                        (up_bf16, PTH_CONFIGS[name][3])):
        if (len(dw_sites), len(sites)) != want:
            raise RuntimeError(f"{name}: found {len(dw_sites)} depthwise "
                               f"and {len(sites)} upsample-conv sites")
    result = dict(name=name, card=card, kernel_checks={})
    got = {}
    for b in EVAL_BATCHES:
        errs = phase_kernels(model, dw_sites, up_sites, name, batch=b,
                             phase="9 eval", dtypes=(torch.float32,))
        errs |= phase_kernels(model, dw_sites, up_bf16, name, batch=b,
                              phase="9 eval", dtypes=(torch.bfloat16,))
        result["kernel_checks"][f"batch{b}"] = {
            str(dtype).removeprefix("torch."): e for dtype, e in errs.items()}
        quiet_eval(model, pairs[:b], b)  # one-time costs out of the timing
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30  # before the pass
        got[b], launches, dt = eval_counted(model, pairs, b, per_forward)
        peak = torch.cuda.max_memory_allocated() / 2**30
        errs = check_metrics(f"{name} batch {b} vs fixture", got[b],
                             fixture_metrics(fx, prefix, b))
        worst_count = max(v for k, v in errs.items()
                          if k.startswith(("delta", "edge")))
        worst_depth = max(v for k, v in errs.items()
                          if not k.startswith(("delta", "edge")))
        ms = 1e3 * dt / math.ceil(EVAL_PAIRS / b)
        busy, records, top = kernel_busy(
            lambda: quiet_eval(model, pairs[:b], b))
        result[f"batch{b}"] = dict(
            images_per_s=EVAL_PAIRS / dt, ms_per_batch=ms, busy_ms=busy,
            idle_share=1 - busy / ms, peak_gib=peak, held_gib=held,
            launches=launches, metrics=got[b])
        log("9 eval", f"{card}: {name} f32 evaluation of {EVAL_PAIRS} pairs "
            f"at batch {b}: {EVAL_PAIRS / dt:.1f} images/s ({ms:.2f} ms a "
            f"batch, host clock, eval_preprocess + forward + upsample + "
            f"depth and edge sums + one copy back), kernels busy "
            f"{busy:.2f} ms a batch ({records:.0f} records): device idle "
            f"share {1 - busy / ms:.3f}; peak memory {peak:.3f} GiB "
            f"({held:.3f} GiB held before the pass); "
            f"launches {launches}; vs JAX fixture: worst depth metric "
            f"{worst_depth:.3g} relative (<= {EVAL_DEPTH_RTOL}), worst "
            f"δ/edge {worst_count:.3g} (<= {EVAL_COUNT_ATOL}); most device "
            "ms a batch: "
            + ", ".join(f"{k} {v:.3f}" for k, v in top[:4]))
        log("9 eval", f"{name} batch {b} metrics: "
            + " ".join(f"{k} {v:.6f}" for k, v in got[b].items()))
    errs = check_metrics(f"{name} batch 1 vs batch 8", got[1], got[8],
                         skip=("log10",))
    same = all(got[1][k] == got[8][k] for k in errs)
    result["batch1_vs_8"] = dict(bit_identical=same, worst=max(errs.values()))
    log("9 eval", f"{name}: batch 1 against batch 8, every metric but "
        f"LOG10 within tolerance, worst {max(errs.values()):.3g}; "
        f"bit-identical: {same}")

    serve = make_serving_fn(model, upsample_to=FRAME_HW, preprocess=True,
                            device=DEVICE)
    frame = torch.from_numpy(pairs[0][0][None]).to(DEVICE)
    lat = serving_latency(serve, frame)
    busy, records, top = kernel_busy(lambda: serve(frame))
    lat.update(busy_ms=busy, idle_share=1 - busy / lat["median_ms"])
    result["latency_b1"] = lat
    log("9 eval", f"{card}: {name} batch-1 serving latency, f32, a uint8 "
        f"{FRAME_HW} frame in, depth at frame size out: median "
        f"{lat['median_ms']:.2f} ms (mean {lat['mean_ms']:.2f}, min "
        f"{lat['min_ms']:.2f}; {1e3 / lat['median_ms']:.1f} frames/s), "
        f"kernels busy {busy:.3f} ms a call ({records:.0f} records): idle "
        f"share {lat['idle_share']:.3f}; most device ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in top[:4]))
    stages = peak_by_stage(model, lambda: quiet_eval(model, pairs[:1], 1))
    result["peak_by_stage_b1"] = stages[:PEAK_STAGES]
    log("9 eval", f"{name} batch-1 evaluation, peak memory above the "
        "memory held at its start, by the stretch between two module "
        "entries or exits (GiB): "
        + "; ".join(f"{k} {v:.3f}" for k, v in stages[:PEAK_STAGES]))
    if name == "ENB0-HU":
        res = time_sites(model, card, dw_sites, up_sites, "9 eval", name,
                         dtype=torch.float32, batch=1)
        f32_errs = result["kernel_checks"]["batch1"]["float32"]
        result["kernels_b1_f32"] = {
            k: dict(ms=r["ms"], graph_ms=r["graph_ms"],
                    plain_ms=r["plain_ms"],
                    bound_ms=max(r["bytes"], r["ops"]),
                    max_abs_err=f32_errs[k])
            for k, r in res.items()}
        result["test_nyu"] = phase_test_nyu(model, pairs)
    return result


def phase_test_nyu(model, pairs) -> dict:
    """``test_nyu``'s compute at batch 8 (f32 serving at frame size, > 10 m
    to 0, ×1000) against the same arithmetic on this phase's own f32
    forward of the same frames, both truncated to integer mm as the PNG
    writer does."""
    serve = make_serving_fn(model, upsample_to=FRAME_HW, preprocess=True,
                            device=DEVICE)
    forward = make_infer_fn(model, upsample_to=FRAME_HW, preprocess=True,
                            device=DEVICE)
    worst, off, total = 0, 0, 0
    for batch in batch_iterator([p[0] for p in pairs], 8, pad_last=True):
        frames = torch.from_numpy(batch["image"]).to(DEVICE)
        mm = depth_maps_mm(serve, frames).astype(np.uint16).astype(np.int64)
        out = forward(frames)[..., 0].cpu().numpy()
        ref = (np.where(out > MAX_DEPTH_M, 0.0, out) * 1000.0).astype(
            np.uint16).astype(np.int64)
        if mm.shape != (8, *FRAME_HW):
            raise RuntimeError(f"test_nyu maps of shape {mm.shape}")
        diff = np.abs(mm - ref)
        worst = max(worst, int(diff.max()))
        off += int((diff > 0).sum())
        total += diff.size
    if worst > 1:
        raise RuntimeError(f"test_nyu mm maps differ by {worst} mm")
    log("9 eval", f"test_nyu compute (ENB0-HU, batch 8, {EVAL_PAIRS} "
        f"frames): uint16 mm maps against the f32 forward's, max |diff| "
        f"{worst} mm (<= 1), {off} of {total} pixels off by 1")
    return dict(max_mm=worst, pixels_off=off)


def phase_bench(pairs, card) -> dict:
    """``inference_benchmark``'s per-checkpoint trials for both
    checkpoints on the phase's frames, bf16 at batch 8; the memory must be
    the card's live peak. The first trial of each is ``counted``: its
    first call, its forwards over the frames and its peak-memory call each
    launch a bf16 forward's kernels."""
    frames = [p[0] for p in pairs]
    forwards = 2 + math.ceil(len(frames) / 8)
    rows = []
    for name, (path, _, _) in EVAL_CONFIGS.items():
        for trial in range(BENCH_TRIALS):
            def row():
                return benchmark_row(frames, path, trial, 8, bf16=True,
                                     device=DEVICE)
            if trial:
                rows.append(row())
                continue
            out, launches = counted(
                row, tuple(forwards * n for n in PTH_CONFIGS[name][3]),
                f"inference_benchmark {name} ({forwards} forwards)")
            rows.append(out)
            log("9 eval", f"inference_benchmark {name} trial 0: launches "
                f"{launches} in {forwards} bf16 forwards at batch 8")
            if rows[-1]["memory_source"] != "live":
                raise RuntimeError(f"inference_benchmark memory source "
                                   f"{rows[-1]['memory_source']}")
    summary = {model: {f"{f}_{st}": entry[(f, st)]
                       for f, st in SUMMARY_COLUMNS}
               for model, entry in summarize(rows).items()}
    for model, entry in summary.items():
        log("9 eval", f"{card}: inference_benchmark --bf16 -b 8 -n "
            f"{BENCH_TRIALS}, {EVAL_PAIRS} frames: {model} "
            + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in entry.items()))
    return summary


def phase_eval(card) -> dict:
    fx = np.load(EVAL_FIXTURE)
    t0 = time.perf_counter()
    pairs = eval_pairs(fx)
    log("9 eval", f"{EVAL_PAIRS} test pairs of generate_dataset(seed=0) "
        f"built in memory in {time.perf_counter() - t0:.1f} s (host); their "
        "sums are the fixture's")
    models = [phase_eval_model(name, pairs, fx, card) for name in EVAL_CONFIGS]
    return dict(models=models, inference_benchmark=phase_bench(pairs, card))


def reference_pth(model, path: str, encoder: str) -> None:
    """Write ``model`` as the reference released its checkpoints: a Hu2018
    model as a raw ``state_dict`` under DataParallel's ``module.`` prefix,
    a MidasNet as its self-describing dict (lasinger2019.py:372-392, sizes
    WH, schema version MIDAS_CHECKPOINT_VERSION). A SENet's SE keys take
    the released checkpoints' ``se_fc1`` form (reside_model.py:42-43)."""
    weights = reference_state_dict(model)
    if isinstance(model, MidasNet):
        h_out, w_out = model.output_size
        h_in, w_in = model.input_size or model.output_size
        state = {"encoder": {"name": encoder, "freeze_weights": False},
                 "decoder": {"num_features": model.decoder.feature_count,
                             "non_negative": model.decoder.non_negative},
                 "input_size": (w_in, h_in), "output_size": (w_out, h_out),
                 "adversarial_training": False, "weights": weights,
                 "version": MIDAS_CHECKPOINT_VERSION}
    else:
        senet = isinstance(model.E, SENetFeatures)
        state = {f"module.{k}".replace("se_module.", "se_") if senet
                 else f"module.{k}": v for k, v in weights.items()}
    torch.save(state, path)


def timed_load(path: str) -> tuple[torch.nn.Module, float]:
    """``load_any_checkpoint(path)`` onto the card, and its ms on the host
    clock up to the model's weights being there."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = load_any_checkpoint(path)
    torch.cuda.synchronize()
    return model, 1e3 * (time.perf_counter() - t0)


def same_state(model, source, name: str) -> None:
    """The loaded model holds the source's every tensor, bit for bit."""
    ours, ref = model.state_dict(), source.state_dict()
    if list(ours) != list(ref):
        raise RuntimeError(f"{name}: the .pth model's keys differ")
    for key, value in ref.items():
        got = ours[key].cpu()
        if got.dtype != value.dtype or not torch.equal(got, value):
            raise RuntimeError(f"{name}: {key} differs from its source")


LAYOUTS = {False: "raw state_dict, module. prefix",
           True: "self-describing MidasNet"}


def phase_pth(frames, card, tmp: str) -> tuple[dict, torch.nn.Module]:
    """10 (a): each configuration written as a reference ``.pth`` (ENB0-HU
    and ENB0-LR from their ``.ede``, the others with phase 8's random
    weights) and loaded onto the card by ``load_any_checkpoint`` with its
    default device: the same tensors bit for bit, exact launches in one
    bf16 serving call of phase 4's frames, and the same output bit for bit
    as its source served from memory (for the two ``.ede`` checkpoints, as
    loaded from the ``.ede``). Returns the figures and ENB0-HU's ``.pth``
    model."""
    result, enb0_hu = {}, None
    for name, (encoder, decoder, seed, expected) in PTH_CONFIGS.items():
        if seed is None:
            source, _ = load_checkpoint(EVAL_CONFIGS[name][0])
        else:
            source = randomize_(build_model(encoder, decoder), seed)
        path = os.path.join(tmp, f"{name}.pth")
        reference_pth(source, path, encoder)
        model, load_ms = timed_load(path)
        same_state(model, source, name)
        serve = make_serving_fn(model, upsample_to=FRAME_HW,
                                dtype=torch.bfloat16, preprocess=True,
                                device=DEVICE)
        out, launches = serve_counted(serve, frames, f"{name} (.pth)",
                                      expected)
        entry = dict(name=name, pth_mb=os.path.getsize(path) / 2**20,
                     pth_load_ms=load_ms, launches=launches)
        if seed is None:
            twin, entry["ede_load_ms"] = timed_load(EVAL_CONFIGS[name][0])
            what = f".ede load {entry['ede_load_ms']:.1f} ms; the .ede model"
        else:
            twin, what = source.to(DEVICE), "its source in memory"
        del source
        ref, _ = serve_counted(
            make_serving_fn(twin, upsample_to=FRAME_HW, dtype=torch.bfloat16,
                            preprocess=True, device=DEVICE),
            frames, f"{name} (source)", expected)
        if not torch.equal(out, ref):
            raise RuntimeError(f"{name}: the .pth model serves other depth "
                               f"than {what} (max {max_abs(out, ref):.3g})")
        log("10 pth", f"{card}: {name}.pth ({entry['pth_mb']:.1f} MiB, "
            f"{LAYOUTS[isinstance(model, MidasNet)]}) "
            f"loaded onto the card in {load_ms:.1f} ms (host clock), every "
            f"tensor equal to its source; serving {frames.shape[0]} frames "
            f"bf16: launches {launches}, equal bit for bit to {what}")
        result[name] = entry
        if name == "ENB0-HU":
            enb0_hu = model
        del model, serve, out, twin, ref
    return result, enb0_hu


def phase_apps(model, frames, card) -> dict:
    """10 (b): the apps' array paths on the card from ENB0-HU's ``.pth``:
    demo (batch 1, f32) against the same model on the CPU and its latency;
    point_clouds on 8 frames, the points against ``unproject_depth`` on
    the CPU; depth_video's preprocess against its CPU run, its kernels at
    the shapes of its 456×608 input, exact launches, frames/s and peak
    memory; inference's ``peak_memory`` at batch 8."""
    rgb = frames[:APP_FRAMES].cpu().numpy()
    result = {}

    infer = make_infer_fn(model, device=DEVICE)
    cpu_infer = make_infer_fn(model, device="cpu")
    out, _ = counted(lambda: depth_of(infer, rgb[0], DEVICE),
                     ENB0_HU_F32_LAUNCHES, "demo")
    ref = depth_of(cpu_infer, rgb[0], "cpu")
    err = float(np.abs(out - ref).max())
    np.testing.assert_allclose(out, ref, **F32_MODEL_TOL)
    for _ in range(WARMUP):
        depth_of(infer, rgb[0], DEVICE)
    times = []
    for _ in range(LATENCY_CALLS):
        t0 = time.perf_counter()
        depth_of(infer, rgb[0], DEVICE)  # ends in a copy to the host
        times.append(1e3 * (time.perf_counter() - t0))
    result["demo"] = dict(max_abs_m=err, median_ms=float(np.median(times)),
                          min_ms=float(np.min(times)))
    log("10 apps", f"{card}: demo (ENB0-HU .pth, f32, one 480x640 frame to "
        f"its 114x152 depth on the host): vs the same model on the CPU max "
        f"abs {err:.3g} m (rtol/atol {F32_MODEL_TOL['rtol']}/"
        f"{F32_MODEL_TOL['atol']}); latency median {np.median(times):.2f} "
        f"ms, min {np.min(times):.2f} ms over {LATENCY_CALLS} calls after "
        f"{WARMUP} (host clock); launches {ENB0_HU_F32_LAUNCHES}")
    del cpu_infer

    pc_infer = make_infer_fn(model, upsample_to=PC_INPUT_HW, device=DEVICE)
    intrinsics = {k: NYU_V2_INTRINSICS_HALF[k] for k in ("fx", "fy", "cx",
                                                        "cy")}
    worst, n_points = 0.0, 0
    for frame in rgb:
        points, colors = cloud_of(pc_infer, frame, DEVICE)
        images = demo_preprocess(torch.tensor(frame[None], device=DEVICE))
        depth = pc_infer(images)[0, :, :, 0].cpu()
        ref_points, _ = unproject_depth(depth, **intrinsics)
        ref_points = ref_points.numpy()
        if points.shape != ref_points.shape or colors.shape != points.shape:
            raise RuntimeError(f"point_clouds: {points.shape} points, "
                               f"{ref_points.shape} on the CPU")
        np.testing.assert_allclose(points, ref_points, rtol=POINT_RTOL,
                                   atol=0)
        worst = max(worst, float(np.max(np.abs(points - ref_points)
                                        / np.maximum(np.abs(ref_points),
                                                     1e-30))))
        n_points += len(points)
    cloud_of(pc_infer, rgb[0], DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for frame in rgb:
        cloud_of(pc_infer, frame, DEVICE)
    dt = time.perf_counter() - t0
    result["point_clouds"] = dict(frames_per_s=len(rgb) / dt,
                                  worst_rel=worst, points=n_points)
    log("10 apps", f"{card}: point_clouds ({len(rgb)} frames, f32, "
        f"forward + upsample to {PC_INPUT_HW} + unproject on the card + one "
        f"copy back): {len(rgb) / dt:.1f} frames/s (host clock); {n_points} "
        f"points, against unproject_depth on the CPU of the same depth: "
        f"worst relative {worst:.3g} (<= {POINT_RTOL})")
    del pc_infer

    video = frames[:VIDEO_FRAMES]
    pre_errs, pre_off = {}, {}
    for hw in PREPROCESS_HWS:
        clip = video[:VIDEO_BATCH].cpu()
        if hw != tuple(clip.shape[1:3]):  # a video's size, made on the host
            clip = F.interpolate(clip.permute(0, 3, 1, 2).float(), size=hw,
                                 mode="bilinear", align_corners=False)
            clip = clip.round().clamp(0, 255).to(torch.uint8).permute(
                0, 2, 3, 1).contiguous()
        diff = (video_preprocess(clip.to(DEVICE)).cpu()
                - video_preprocess(clip)).abs()
        key = f"{hw[0]}x{hw[1]}"
        pre_errs[key], pre_off[key] = float(diff.max()), int((diff > 1e-8)
                                                            .sum())
        if not pre_errs[key] <= PREPROCESS_ATOL:
            raise RuntimeError(f"depth_video preprocess on the card at {key}: "
                               f"max {pre_errs[key]} from its CPU run")
        del clip, diff
    dw_sites, up_sites, _ = main_path_sites(model, VIDEO_INPUT_HW,
                                            torch.float32)
    if (len(dw_sites), len(up_sites)) != ENB0_HU_F32_LAUNCHES:
        raise RuntimeError(f"depth_video: {len(dw_sites)} depthwise and "
                           f"{len(up_sites)} upsample-conv sites")
    checks = phase_kernels(model, dw_sites, up_sites, "ENB0-HU video",
                           batch=VIDEO_BATCH, phase="10 apps")
    v_infer = make_infer_fn(model, upsample_to=(VIDEO_HEIGHT, VIDEO_WIDTH),
                            device=DEVICE)
    batches = [video[i:i + VIDEO_BATCH]
               for i in range(0, VIDEO_FRAMES, VIDEO_BATCH)]
    counted(lambda: [depth_frames(v_infer, b) for b in batches],
            tuple(n * len(batches) for n in ENB0_HU_F32_LAUNCHES),
            "depth_video")
    depth_frames(v_infer, batches[0]).cpu()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b in batches:
        depth = depth_frames(v_infer, b).cpu().numpy()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if depth.shape != (VIDEO_BATCH, VIDEO_HEIGHT, VIDEO_WIDTH) or \
            not np.isfinite(depth).all():
        raise RuntimeError(f"depth_video depth of shape {depth.shape}")
    result["depth_video"] = dict(
        frames_per_s=VIDEO_FRAMES / dt, peak_gib=peak,
        preprocess_max_abs=pre_errs, preprocess_off=pre_off,
        kernel_checks={str(d).removeprefix("torch."): e
                       for d, e in checks.items()})
    log("10 apps", f"{card}: depth_video ({VIDEO_FRAMES} frames at batch "
        f"{VIDEO_BATCH}, f32, preprocess to {VIDEO_INPUT_HW} + forward + "
        f"upsample to {VIDEO_HEIGHT}x{VIDEO_WIDTH} + copy back): "
        f"{VIDEO_FRAMES / dt:.1f} frames/s (host clock), peak memory "
        f"{peak:.3f} GiB; launches {ENB0_HU_F32_LAUNCHES} a batch; "
        "preprocess vs its CPU "
        f"run (frames of {', '.join(pre_errs)}) max abs "
        f"{', '.join(f'{e:.3g}' for e in pre_errs.values())} (<= "
        f"{PREPROCESS_ATOL}), values off by more than 1e-8: "
        f"{', '.join(map(str, pre_off.values()))}")
    del v_infer, depth

    images = eval_preprocess_image_only(frames[:VIDEO_BATCH])
    peak, source = peak_memory(infer, (images,))
    if source != "live" or peak <= 0:
        raise RuntimeError(f"inference peak memory {peak} ({source})")
    result["inference"] = dict(peak_bytes=peak, source=source)
    log("10 apps", f"{card}: inference (peak_memory, ENB0-HU .pth f32 "
        f"forward at batch {VIDEO_BATCH}): {peak / 2**30:.3f} GiB ({source})")
    return result


def phase_pth_apps(frames, card) -> dict:
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        loads, model = phase_pth(frames, card, tmp)
    apps = phase_apps(model, frames, card)
    seconds = time.perf_counter() - t0
    log("10 apps", f"ok: phase 10 in {seconds:.1f} s")
    return dict(card=card, seconds=seconds, pth=loads, apps=apps)


# ---------------------------------------------------------------- phase 11

def all_launches() -> dict[str, int]:
    """The four kernels' launch counts."""
    return {name: c.launches for name, c in KERNEL_COUNTERS.items()}


def launches_since(before: dict) -> tuple[int, ...]:
    """(depthwise, upsample-conv, loss forward, loss backward) launched
    since ``before``."""
    torch.cuda.synchronize()
    now = all_launches()
    return tuple(now[k] - before[k] for k in KERNEL_COUNTERS)


@contextlib.contextmanager
def epoch_launches(parts: list):
    """Record the launches of each training and eval epoch the CLI runs
    (``(name, launches)`` in ``parts``), by wrapping the two epoch
    functions of ``apps.train`` for the block."""
    saved = train_app.run_train_epoch, train_app.run_eval_epoch

    def counted_epoch(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            before = all_launches()
            out = fn(*args, **kwargs)
            parts.append((name, launches_since(before)))
            return out
        return run

    train_app.run_train_epoch = counted_epoch("train", saved[0])
    train_app.run_eval_epoch = counted_epoch("eval", saved[1])
    try:
        yield
    finally:
        train_app.run_train_epoch, train_app.run_eval_epoch = saved


def run_cli(argv: list[str], workdir: str) -> tuple[str, list, float]:
    """``apps.train.main(argv)`` run from ``workdir`` on the card, its
    progress lines kept back (printed if it raises); returns its path, the
    launches of each epoch and of the whole run (all four counts set to 0
    just before it), and its seconds."""
    parts, printed = [], io.StringIO()
    cwd = os.getcwd()
    os.chdir(workdir)
    for c in KERNEL_COUNTERS.values():
        c.launches = 0
    t0 = time.perf_counter()
    try:
        with epoch_launches(parts), contextlib.redirect_stdout(printed):
            path = train_app.main(argv + ["--device", DEVICE])
    except BaseException:
        print(printed.getvalue()[-4000:], file=sys.stderr)
        raise
    finally:
        os.chdir(cwd)
    seconds = time.perf_counter() - t0
    parts.append(("run", launches_since(dict.fromkeys(KERNEL_COUNTERS, 0))))
    return os.path.join(workdir, path), parts, seconds


def check_parts(name: str, parts: list, expected: list) -> None:
    if parts != expected:
        raise RuntimeError(f"{name}: launches (depthwise, upsample-conv, loss "
                           f"forward, loss backward) {parts}, expected "
                           f"{expected}")


def add(*counts) -> tuple[int, ...]:
    return tuple(map(sum, zip(*counts)))


def scale(n: int, counts) -> tuple[int, ...]:
    return tuple(n * c for c in counts)


def flat_tree(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}"
        if isinstance(value, dict):
            out.update(flat_tree(value, name))
        else:
            out[name] = np.asarray(value)
    return out


def state_diff(path_a: str, path_b: str) -> dict:
    """Largest |a − b| of two train-state files, by collection, and the
    leaf where the largest is; 0 everywhere means bit for bit."""
    (ha, ta), (hb, tb) = read_ede(path_a), read_ede(path_b)
    fa, fb = flat_tree(ta), flat_tree(tb)
    if fa.keys() != fb.keys() or ha["step"] != hb["step"]:
        raise RuntimeError(f"train states differ in layout or step: "
                           f"{ha['step']} vs {hb['step']}")
    worst = {}
    for key in fa:
        col = key.split("/")[1]
        d = float(np.abs(fa[key].astype(np.float64)
                         - fb[key].astype(np.float64)).max(initial=0.0))
        if d >= worst.get(col, (-1.0, ""))[0]:
            worst[col] = (d, key)
    return {col: dict(max_abs=d, leaf=k) for col, (d, k) in worst.items()}


def timed_steps(state, step, batch, draws=None) -> dict:
    """images/s (host clock, POLICY_ITERS steps after POLICY_WARMUP, the
    batch on the card)
    and peak memory of ``step`` on ``batch``."""
    for _ in range(POLICY_WARMUP):
        step(state, batch, 0, draws=draws)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(POLICY_ITERS):
        step(state, batch, 0, draws=draws)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = batch["image"].shape[0]
    return dict(images_per_s=n * POLICY_ITERS / dt,
                step_ms=1e3 * dt / POLICY_ITERS,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def step_grads(model, batch, seed: int, **kw) -> tuple:
    """(loss, gradients, running statistics) of one f32 step of a copy of
    ``model`` on the card."""
    model = copy.deepcopy(model)
    state = create_train_state(model, LR, WEIGHT_DECAY)
    _, metrics = make_train_step(device=DEVICE, **kw)(state, batch, seed)
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    return float(metrics["loss"]), grads, stats


def worst_grad_rel(grads: dict, ref: dict) -> float:
    return max(float((grads[k] - g).abs().max() / g.abs().max().clamp_min(
        1e-30)) for k, g in ref.items())


def read_log(checkpoint: str) -> list[dict]:
    """The records of the ``log.jsonl`` beside a run's checkpoint."""
    with open(os.path.join(os.path.dirname(checkpoint), "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def check_native_decode(csv_path: str, is_test: bool) -> int:
    """``DepthPairDataset.load_batch`` (the native decoder) against the
    PIL decode of every pair of a split, bit for bit, at CLI_BATCH;
    returns the pairs checked."""
    ours = DepthPairDataset(csv_path, is_test=is_test)
    pil = DepthPairDataset(csv_path, is_test=is_test, use_native=False)
    for start in range(0, len(ours), CLI_BATCH):
        indices = np.arange(start, min(start + CLI_BATCH, len(ours)))
        batch = ours.load_batch(indices)
        if batch is None:
            raise RuntimeError(f"load_batch fell back to PIL on {csv_path}")
        for k, i in enumerate(indices):
            for got, want in zip(batch, pil[int(i)]):
                if got[k].dtype != want.dtype or not np.array_equal(got[k],
                                                                    want):
                    raise RuntimeError(
                        f"native decode of pair {i} of {csv_path} differs "
                        f"from PIL's: {got[k].dtype} {want.dtype}")
    return len(ours)


def loader_pairs_per_s(csv_path: str, use_native: bool) -> float:
    """What the CLI's loader alone takes on the train split, host clock:
    ``batch_iterator`` at CLI_BATCH, a batch through the native decoder or
    one PIL decode a sample on 4 threads."""
    t0 = time.perf_counter()
    decoded = sum(int(b["num_valid"]) for b in batch_iterator(
        DepthPairDataset(csv_path, use_native=use_native), CLI_BATCH))
    return decoded / (time.perf_counter() - t0)


def phase_cli_data(tmp: str, card: str) -> tuple[str, str, dict]:
    t0 = time.perf_counter()
    train_csv, test_csv = generate_dataset(tmp, CLI_TRAIN_PAIRS,
                                           CLI_TEST_PAIRS)
    seconds = time.perf_counter() - t0
    log("11 train", f"{card}: generate_dataset wrote {CLI_TRAIN_PAIRS} "
        f"train and {CLI_TEST_PAIRS} test 480x640 PNG pairs in "
        f"{seconds:.2f} s ({seconds / (CLI_TRAIN_PAIRS + CLI_TEST_PAIRS):.3f}"
        f" s a pair, one host thread)")
    out = dict(write_s=seconds, train_pairs=CLI_TRAIN_PAIRS,
               test_pairs=CLI_TEST_PAIRS)
    routes = (True, False) if native.is_available() else (False,)
    if native.is_available():
        checked = [check_native_decode(train_csv, False),
                   check_native_decode(test_csv, True)]
        log("11 train", f"ok: load_batch (native) equals the PIL decode bit "
            f"for bit on all {checked[0]} train pairs (8-bit depths) and "
            f"{checked[1]} test pairs (16-bit depths)")
        out["native_decode_checked_pairs"] = checked
    else:
        log("11 train", "the native decoder is not built here: the loader's "
            "PIL route alone is timed")
    rates = {("native" if r else "pil"): [] for r in routes}
    for _ in range(LOADER_REPEATS):
        for use_native in routes:
            rates["native" if use_native else "pil"].append(
                loader_pairs_per_s(train_csv, use_native))
    log("11 train", f"{card}: batch_iterator decodes the train split at "
        + "; ".join(f"{k} " + ", ".join(f"{v:.1f}" for v in vs)
                    for k, vs in rates.items())
        + f" pairs/s (batch {CLI_BATCH}, host clock; "
        + ("in turns; native: the C++ thread pool, " if len(routes) == 2
           else "") + "PIL: 4 threads)")
    out["decode_pairs_per_s"] = rates
    return train_csv, test_csv, out


@contextlib.contextmanager
def profiled_train_epochs(record: list):
    """Trace each training epoch the CLI runs in the block with
    ``torch.profiler``: its host seconds to a synchronize and the union of
    its device records, appended to ``record``."""
    saved = train_app.run_train_epoch

    def run(*args, **kwargs):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = saved(*args, **kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = device_spans(prof)
        record.append(dict(wall_s=wall, busy_s=union_us(spans) / 1e6
                           if spans else None, records=len(spans)))
        return out

    train_app.run_train_epoch = run
    try:
        yield
    finally:
        train_app.run_train_epoch = saved


def cli_routes(argv: list[str], tmp: str, expected: list) -> dict:
    """The ENB0-HU CLI epoch on each decode route (native, then PIL with
    the native decoder reported unavailable): once for its images/s (the
    CLI's own ``training_frame_time``), once under the profiler for the
    train epoch's device idle share (1 − busy / host time). A trace with
    no device record is the tracer's loss: traced again, up to
    PROFILER_TRIES runs."""
    out = {}
    for route in ("native", "pil") if native.is_available() else ("pil",):
        with contextlib.nullcontext() if route == "native" else native_off():
            path, parts, seconds = run_cli(argv, tmp)
            check_parts(f"CLI run, {route} decode", parts, expected)
            rec = read_log(path)[0]
            for _ in range(PROFILER_TRIES):
                traced = []
                with profiled_train_epochs(traced):
                    run_cli(argv, tmp)
                if traced[0]["busy_s"] is not None:
                    break
                log("profiler", "the CLI epoch's trace holds no device "
                    "record; running it again")
            else:
                raise RuntimeError("the profiler saw no kernel in the CLI's "
                                   f"epoch in {PROFILER_TRIES} runs")
        epoch = traced[0]
        out[route] = dict(
            images_per_s=1.0 / rec["training_frame_time"], seconds=seconds,
            traced_images_per_s=CLI_TRAIN_PAIRS / epoch["wall_s"],
            busy_s=epoch["busy_s"], traced_wall_s=epoch["wall_s"],
            idle_share=1.0 - epoch["busy_s"] / epoch["wall_s"])
    return out


def phase_cli_enb0_hu(tmp, train_csv, test_csv, frames, card) -> dict:
    """11b: ENB0-HU through the CLI, uninterrupted (A), stopped after one
    step (B) and resumed (C), with deterministic cuDNN; again (E) without
    it; the launches of each epoch; the final train states of A and C;
    the log; the best checkpoint served; the rolling save and load."""
    base = ["--encoder", "efficientnet-b0", "--decoder", "hu2018", "--bf16",
            "--per-device-batch", str(CLI_BATCH), "--epochs", "1",
            "--crop-hw", *map(str, INPUT_HW), "--train-csv", train_csv,
            "--test-csv", test_csv]
    init = ["--init-from", CHECKPOINT]
    steps = CLI_TRAIN_PAIRS // CLI_BATCH
    eval_fwd = (*ENB0_HU_F32_LAUNCHES, 0, 0)  # an f32 forward
    rest = add(eval_fwd, TRAIN_STEP_LAUNCHES["none"])  # examples, probe
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, extra in (("A", []), ("B", ["--stop-after-steps", "1"])):
            runs[name] = run_cli(base + init + extra, tmp)
        rolling = runs["B"][0]
        runs["C"] = run_cli(base + ["--resume", rolling], tmp)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    runs["E"] = run_cli(base + init, tmp)
    one = TRAIN_STEP_LAUNCHES["none"]
    full_run = [("train", scale(steps, one)), ("eval", eval_fwd),
                ("run", add(scale(steps, one), eval_fwd, rest))]
    check_parts("CLI run A", runs["A"][1], full_run)
    check_parts("CLI run E", runs["E"][1], full_run)
    check_parts("CLI run B", runs["B"][1], [("train", one), ("run", one)])
    resumed = scale(steps - 1, one)
    check_parts("CLI run C", runs["C"][1],
                [("train", resumed), ("eval", eval_fwd),
                 ("run", add(resumed, eval_fwd, rest))])
    if min(runs["A"][1][-1][1]) == 0:
        raise RuntimeError(f"a kernel did not run in the CLI: {runs['A'][1]}")

    state_of = {k: os.path.join(os.path.dirname(v[0]), "train_state.ede")
                for k, v in runs.items()}
    header_b, _ = read_ede(rolling)
    if (header_b["step"], header_b["epoch"],
            header_b.get("step_in_epoch")) != (1, 0, 1):
        raise RuntimeError(f"the stopped run saved {header_b}")
    resume = state_diff(state_of["A"], state_of["C"])
    exact = all(v["max_abs"] == 0.0 for v in resume.values())
    if not exact:
        raise RuntimeError(f"resume with deterministic cuDNN differs from "
                           f"the uninterrupted run: {resume}")
    nondet = state_diff(state_of["A"], state_of["E"])
    routes = cli_routes(base + init, tmp, full_run)

    records = read_log(runs["A"][0])
    want = {"mae", "mse", "abs_rel", "log10", "delta1", "delta2", "delta3",
            "rmse", "loss", "vram_usage", "vram_source",
            "training_frame_time", "test_frame_time", "inference_time"}
    if len(records) != 1 or not want <= set(records[0]) or \
            records[0]["vram_source"] != "live" or \
            not np.isfinite(records[0]["loss"]):
        raise RuntimeError(f"log.jsonl of the CLI run: {records}")
    rec_e = read_log(runs["E"][0])[0]

    model = load_any_checkpoint(runs["A"][0], device=DEVICE)
    serve = make_serving_fn(model, upsample_to=FRAME_HW,
                            dtype=torch.bfloat16, preprocess=True,
                            device=DEVICE)
    serve_counted(serve, frames[:8], "CLI best checkpoint",
                  ENB0_HU_LAUNCHES)
    del serve

    state = create_train_state(model.to(DEVICE), step_lr(LR, steps),
                               WEIGHT_DECAY)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = load_train_state(state_of["A"], state)
    load_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    save_train_state(os.path.join(tmp, "copy.ede"), state,
                     encoder="efficientnet-b0", decoder="hu2018", epoch=0)
    save_ms = 1e3 * (time.perf_counter() - t0)
    mib = os.path.getsize(state_of["A"]) / 2**20
    del state, model

    result = dict(
        runs={k: dict(seconds=v[2], launches=v[1]) for k, v in runs.items()},
        resume_bit_for_bit=exact, resume_max_abs=resume,
        nondeterministic_max_abs=nondet,
        images_per_s_deterministic=1.0 / records[0]["training_frame_time"],
        images_per_s=1.0 / rec_e["training_frame_time"],
        peak_gib=rec_e["vram_usage"] / 2**30,
        test_frame_s=rec_e["test_frame_time"],
        rolling_save_ms=save_ms, rolling_load_ms=load_ms, rolling_mib=mib,
        decode_routes=routes)
    log("11 train", f"{card}: CLI ENB0-HU bf16 batch {CLI_BATCH}, 1 epoch "
        f"of {steps} steps on {CLI_TRAIN_PAIRS} PNG pairs ({INPUT_HW} crop): "
        f"{result['images_per_s']:.1f} images/s with PNG decode and the "
        f"loader ({result['images_per_s_deterministic']:.1f} with "
        f"deterministic cuDNN), peak memory {result['peak_gib']:.2f} GiB "
        f"(live); runs A/B/C/E "
        + ", ".join(f"{k} {v[2]:.1f} s" for k, v in runs.items())
        + f"; launches (depthwise, upsample-conv, loss fwd, loss bwd) of "
        f"run A: {runs['A'][1]}")
    log("11 train", f"{card}: --stop-after-steps 1 then --resume against the "
        f"uninterrupted run, deterministic cuDNN: "
        f"{'bit for bit' if exact else resume}; uninterrupted runs with and "
        f"without deterministic cuDNN differ by {nondet}")
    log("11 train", f"{card}: CLI ENB0-HU epoch by decode route, in turns "
        "(images/s by the CLI's clock; then under the profiler: images/s, "
        "the train epoch's device busy s and idle share): " + "; ".join(
            f"{k} {v['images_per_s']:.1f} images/s; traced "
            f"{v['traced_images_per_s']:.1f}, busy {v['busy_s']:.3f} of "
            f"{v['traced_wall_s']:.3f} s, idle share {v['idle_share']:.3f}"
            for k, v in routes.items()))
    log("11 train", f"{card}: train_state.ede {mib:.1f} MiB: save "
        f"{save_ms:.1f} ms, load onto the card {load_ms:.1f} ms; the best "
        f"checkpoint serves bf16 with {ENB0_HU_LAUNCHES} launches")
    return result


def phase_cli_enb0_lr(tmp, train_csv, test_csv, frames, card) -> dict:
    """11c: ENB0-LR through the CLI; its self-describing file serves."""
    argv = ["--encoder", "efficientnet-b0", "--decoder", "lasinger2019",
            "--bf16", "--per-device-batch", str(CLI_BATCH), "--epochs", "1",
            "--crop-hw", *map(str, INPUT_HW), "--init-from", LR_CHECKPOINT,
            "--train-csv", train_csv, "--test-csv", test_csv]
    path, parts, seconds = run_cli(argv, tmp)
    steps = CLI_TRAIN_PAIRS // CLI_BATCH
    one, fwd = (0, 0, 1, 1), (16, 0, 0, 0)
    check_parts("CLI ENB0-LR", parts,
                [("train", scale(steps, one)), ("eval", fwd),
                 ("run", add(scale(steps, one), fwd, fwd, one))])
    header, _ = read_ede(path)
    if header["format"] != "midas-self-describing" or \
            header["output_size"] != [INPUT_HW[1] // 2, INPUT_HW[0] // 2]:
        raise RuntimeError(f"ENB0-LR checkpoint header {header}")
    serve = make_serving_fn(load_any_checkpoint(path, device=DEVICE),
                            upsample_to=FRAME_HW,
                            dtype=torch.bfloat16, preprocess=True,
                            device=DEVICE)
    serve_counted(serve, frames[:8], "CLI ENB0-LR checkpoint", (16, 0))
    log("11 train", f"{card}: CLI ENB0-LR bf16 batch {CLI_BATCH}, 1 epoch: "
        f"{seconds:.1f} s, launches {parts}; its midas-self-describing file "
        "reloads and serves bf16 with 16 + 0 launches")
    return dict(seconds=seconds, launches=parts)


def phase_train_policies(card) -> dict:
    """11d: ENB0-HU bf16 steps on one fixed batch: remat none, full, dots
    at batch 64 and accum_steps=2 at 128 (launches, images/s, peak), each
    held against the plain step in f32 at batch 8."""
    out = {}
    for policy, n, kw in (("none", TRAIN_BATCH, {}),
                          ("full", TRAIN_BATCH, {"remat": "full"}),
                          ("dots", TRAIN_BATCH, {"remat": "dots"}),
                          ("accum2", 2 * TRAIN_BATCH, {"accum_steps": 2})):
        batch = train_batch(range(n))
        draws = draw_augmentation(torch.Generator().manual_seed(1), n)
        state = create_train_state(
            load_any_checkpoint(CHECKPOINT, device=DEVICE), LR, WEIGHT_DECAY)
        step = make_train_step(mixed_precision=True, device=DEVICE, **kw)
        before = all_launches()
        _, metrics = step(state, batch, 0, draws=draws)
        launches = launches_since(before)
        if launches != TRAIN_STEP_LAUNCHES[policy]:
            raise RuntimeError(f"{policy} step launches {launches}, expected "
                               f"{TRAIN_STEP_LAUNCHES[policy]}")
        if not np.isfinite(float(metrics["loss"])):
            raise RuntimeError(f"{policy} step loss {float(metrics['loss'])}")
        out[policy] = dict(batch=n, launches=launches,
                           **timed_steps(state, step, batch, draws))
        del state, step, batch
        log("11 train", f"{card}: ENB0-HU bf16 step, {policy} at batch {n}: "
            f"{out[policy]['images_per_s']:.1f} images/s "
            f"({out[policy]['step_ms']:.2f} ms a step), peak memory "
            f"{out[policy]['peak_gib']:.2f} GiB, launches {launches}")

    # f32 at CHECK_BATCH, drop-connect on, the same generators (the step's
    # seed), deterministic cuDNN: each remat policy against none
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model = load_any_checkpoint(CHECKPOINT, device=DEVICE)
        batch = train_batch(range(CHECK_BATCH))
        loss, grads, stats = step_grads(model, batch, 5)
        for policy in ("full", "dots"):
            loss_r, grads_r, stats_r = step_grads(model, batch, 5,
                                                  remat=policy)
            err = worst_grad_rel(grads_r, grads)
            moved = max(float((stats_r[k] - v).abs().max())
                        for k, v in stats.items())
            if loss_r != loss or not err <= REMAT_TOL or moved != 0.0:
                raise RuntimeError(f"remat {policy}: loss {loss_r} vs {loss}, "
                                   f"gradients {err}, statistics {moved}")
            out[policy].update(f32_grad_rel=err, f32_stats_max_abs=moved)
        # the JAX rule: two copies of a microbatch give the step of one
        # (drop-connect off: each microbatch draws its own masks)
        model.E.drop_connect_rate = 0.0
        half = train_batch(range(CHECK_BATCH // 2))
        aug = draw_augmentation(torch.Generator().manual_seed(2),
                                CHECK_BATCH // 2)
        pre = train_preprocess(half["image"], half["depth"], aug)
        single = {"image": pre[0], "depth": pre[1]}
        doubled = {k: torch.cat([v, v]) for k, v in single.items()}
        loss_1, grads_1, _ = step_grads(model, single, 5, preprocess=False)
        loss_2, grads_2, _ = step_grads(model, doubled, 5, preprocess=False,
                                        accum_steps=2)
        err = worst_grad_rel(grads_2, grads_1)
        if abs(loss_2 - loss_1) > 1e-6 * abs(loss_1) or not err <= REMAT_TOL:
            raise RuntimeError(f"accum on a duplicated microbatch: loss "
                               f"{loss_2} vs {loss_1}, gradients {err}")
        out["accum2"].update(f32_grad_rel=err, f32_loss=(loss_2, loss_1))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log("11 train", f"{card}: f32 at batch {CHECK_BATCH}, deterministic "
        "cuDNN: remat full / dots against none with drop-connect on: "
        f"gradients within {out['full']['f32_grad_rel']:.3g} / "
        f"{out['dots']['f32_grad_rel']:.3g} of each leaf's largest value "
        f"(<= {REMAT_TOL}), the loss and BN statistics bit for bit; "
        "accum_steps=2 on a duplicated microbatch against one: gradients "
        f"within {out['accum2']['f32_grad_rel']:.3g}")
    return out


def phase_random_steps(card) -> dict:
    """11e: RN50-HU, RN50-LR, DN161-HU and SN154-HU at full width, random
    weights: bf16 steps at batch 64 with exact launches, a loss that falls
    on a fixed batch, images/s and peak memory."""
    out = {}
    batch = train_batch(range(TRAIN_BATCH))
    draws = draw_augmentation(torch.Generator().manual_seed(1), TRAIN_BATCH)
    for name, expected in RANDOM_STEP_LAUNCHES.items():
        model = random_model(name)
        state = create_train_state(model, LR, WEIGHT_DECAY)
        step = make_train_step(mixed_precision=True, device=DEVICE)
        before = all_launches()
        _, metrics = step(state, batch, 0, draws=draws)
        launches = launches_since(before)
        if launches != expected:
            raise RuntimeError(f"{name} step launches {launches}, expected "
                               f"{expected}")
        losses = [float(metrics["loss"])]
        for _ in range(FALL_STEPS_RANDOM):
            _, metrics = step(state, batch, 0, draws=draws)
            losses.append(float(metrics["loss"]))
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise RuntimeError(f"{name}: the loss did not fall: {losses}")
        if name == "RN50-HU":
            _, up_sites, _ = main_path_sites(model, INPUT_HW)
            phase_kernels(model, [], up_sites, "RN50-HU train",
                          batch=TRAIN_BATCH, phase="11 train",
                          dtypes=(torch.bfloat16,))
        out[name] = dict(launches=launches, losses=losses,
                         **timed_steps(state, step, batch, draws))
        log("11 train", f"{card}: {name} (random weights) bf16 step at "
            f"batch {TRAIN_BATCH}: launches {launches}; loss "
            + " ".join(f"{v:.4f}" for v in losses)
            + f"; {out[name]['images_per_s']:.1f} images/s, peak memory "
            f"{out[name]['peak_gib']:.2f} GiB")
        del model, state, step
    return out


def phase_train_cli(frames, card) -> dict:
    """11: the training CLI on the card, its kernels at the shapes it gives
    them, the remat and accumulation policies, and RN50 training."""
    t0 = time.perf_counter()
    model = load_any_checkpoint(CHECKPOINT, device=DEVICE)
    dw_f32, up_f32, _ = main_path_sites(model, INPUT_HW, torch.float32)
    _, up_bf16, _ = main_path_sites(model, INPUT_HW)
    # the CLI's eval epoch (f32, batch 64) and bf16 training at batch 64
    phase_kernels(model, dw_f32, up_f32, "ENB0-HU CLI eval",
                  batch=CLI_BATCH, phase="11 train", dtypes=(torch.float32,))
    phase_kernels(model, [], up_bf16, "ENB0-HU train", batch=TRAIN_BATCH,
                  phase="11 train", dtypes=(torch.bfloat16,))
    del model
    with tempfile.TemporaryDirectory() as tmp:
        train_csv, test_csv, data = phase_cli_data(tmp, card)
        hu = phase_cli_enb0_hu(tmp, train_csv, test_csv, frames, card)
        lr = phase_cli_enb0_lr(tmp, train_csv, test_csv, frames, card)
    policies = phase_train_policies(card)
    random_steps = phase_random_steps(card)
    seconds = time.perf_counter() - t0
    log("11 train", f"ok: phase 11 in {seconds:.1f} s")
    return dict(card=card, seconds=seconds, data=data, enb0_hu_cli=hu,
                enb0_lr_cli=lr, policies=policies, random_steps=random_steps)


# Phase 12: the user-centred benchmark (``benchmark.harness.main``) on the
# card. BENCH_PAIRS test pairs of generate_dataset (cut from NYU-v2's 654
# for time) at 480x640 with the NYU camera.json; the renderer's settings
# are the benchmark's own and uncut: fps 60 (303 views a sample), mesh
# density 8, supersample 3, displacement 4.0. ENB0-HU and ENB0-LR from
# their .ede and the flat baseline, f32 at batch BENCH_BATCH on the
# nyu_eval_sample(32) frames (224x320); the kernels are held against their
# plain versions there at the batch and at the remainder 654 pairs leave.
BENCH_PAIRS, BENCH_BATCH, BENCH_FPS = 8, 4, 60
BENCH_INPUT_HW = (224, 320)
BENCH_KERNEL_BATCHES = (BENCH_BATCH, 654 % BENCH_BATCH)
NYU_CAMERA = {"width": 640, "height": 480, "fx": 525.0, "fy": 525.0,
              "cx": 320.0, "cy": 240.0}
# model name -> (checkpoint, launches of one f32 forward: depthwise,
# upsample-conv); flat launches none
BENCH_MODELS = {"reside_enb0": (CHECKPOINT, ENB0_HU_F32_LAUNCHES),
                "midas_enb0": (LR_CHECKPOINT, (16, 0)),
                "flat": (None, (0, 0))}
# The card's renders against the CPU's: the share of pixels whose colour
# agrees within RENDER_PIXEL_ATOL, per engine, as tests/test_torch_renderer.py
# holds the port against JAX on the CPU (a winner in a z-buffer tie, a
# sample within an ulp of a pixel edge or a grazing ray may differ).
RENDER_PIXEL_ATOL = 1e-4
RENDER_SHARE = {"mesh": 0.999, "splat": 0.999, "raymarch": 0.99}
# The views checked: the sweep's first 8 and its 5 stills.
RENDER_CHECK_VIEWS = sorted(set(range(8)) | set(range(3, 303, 60)))
# The golden rasterizer's floors, as tests/test_raster_golden.py asserts
# them at 96x128 over 4 views of the reference sweep: (engine, scene seed,
# mesh density) -> least SSIM.
GOLDEN_HW = (96, 128)
GOLDEN_FLOORS = {("mesh", 0, 4): 0.95, ("mesh", 0, 6): 0.95,
                 ("raymarch", 0, 4): 0.97, ("raymarch", 0, 8): 0.97,
                 ("raymarch", 3, 4): 0.97, ("raymarch", 3, 8): 0.97,
                 ("splat", 0, 6): 0.90}
# Visual metrics on the card against the CPU on the same stills: SSIM and
# PSNR are f32 sums of 121 taps and means in another order (1e-5
# absolute); LPIPS adds five convolutions of random weights (1e-4
# relative, as tests/test_torch_benchmark.py holds it against JAX).
VISUAL_ATOL, LPIPS_RTOL = 1e-5, 1e-4
# Depth maps on the card against the port's CPU forward, TF32 off: metres.
BENCH_DEPTH_ATOL = 1e-3
# The native MJPEG sweep (libjpeg, quality 90) read back by cv2 against the
# rendered frames: the JAX package's bound on the mean absolute level
# (tests/test_native_encoder.py); generate_dataset's scenes sit near 1.
ENCODE_MEAN_ABS = 5.0


def lpips_standin(tmp: str) -> str:
    """A seeded random LPIPS-AlexNet in the torchvision and lpips 0.1.4
    layouts, converted to the .npz both packages read (the real weights are
    not in the repository)."""
    from efficientdepthestimation_tpu_torch.checkpoints.lpips_convert import (
        convert,
    )

    g = torch.Generator().manual_seed(0)
    alex, heads = {}, {}
    for i, (idx, (cin, cout, k)) in enumerate(zip(
            (0, 3, 6, 8, 10), ((3, 64, 11), (64, 192, 5), (192, 384, 3),
                               (384, 256, 3), (256, 256, 3)))):
        alex[f"features.{idx}.weight"] = 0.05 * torch.randn(
            cout, cin, k, k, generator=g)
        alex[f"features.{idx}.bias"] = 0.05 * torch.randn(cout, generator=g)
        heads[f"lin{i}.model.1.weight"] = 0.1 * torch.rand(1, cout, 1, 1,
                                                           generator=g)
    paths = [os.path.join(tmp, f) for f in ("alexnet.pth", "lpips.pth",
                                            "lpips_alex.npz")]
    torch.save(alex, paths[0])
    torch.save(heads, paths[1])
    with contextlib.redirect_stdout(io.StringIO()):
        convert(*paths)
    return paths[2]


def bench_kernels(card) -> dict:
    """Each kernel against its plain version at the sites ENB0-HU's and
    ENB0-LR's f32 forwards of 224x320 frames give it, at the benchmark's
    batch and remainder; then ENB0-HU's kernels timed at batch 4 in f32."""
    timed = {}
    for name, (path, per_forward) in BENCH_MODELS.items():
        if path is None:
            continue
        model = load_any_checkpoint(path, device=DEVICE)
        dw, up, _ = main_path_sites(model, BENCH_INPUT_HW, torch.float32)
        if (len(dw), len(up)) != per_forward:
            raise RuntimeError(f"{name}: {len(dw)} depthwise and {len(up)} "
                               f"upsample-conv sites at {BENCH_INPUT_HW}")
        for batch in BENCH_KERNEL_BATCHES:
            phase_kernels(model, dw, up, name, batch=batch,
                          phase="12 benchmark", dtypes=(torch.float32,))
        if name == "reside_enb0":
            timed = time_sites(model, card, dw, up, "12 benchmark", name,
                               dtype=torch.float32, batch=BENCH_BATCH)
    return timed


@contextlib.contextmanager
def harness_phases(record: list, launches: dict, plots: bool):
    """Wrap the phases ``harness.main`` calls, for one block: each call's
    wall seconds go to ``record``; each ``create_depth_maps`` runs with
    the four kernels' counts set to 0 just before it and read just after
    (``launches[model]``); without matplotlib, ``visualise_results`` is
    left out, and says so."""
    from efficientdepthestimation_tpu_torch.benchmark import (
        harness,
        noise,
        renderer,
    )

    targets = [(renderer, "create_rendered_images"),
               (noise, "create_noisy_depth_maps"),
               (harness, "create_depth_maps"), (harness, "run_benchmark"),
               (harness, "images_to_grid"), (harness, "visualise_results")]
    saved = [getattr(mod, name) for mod, name in targets]

    def label(name, args):
        """The phase and what it works on: the last two parts of its
        output directory, the model or the grid's kind."""
        if name == "run_benchmark":
            return f"{name} {args[2]}"
        if name == "images_to_grid":
            return f"{name} {args[1] if len(args) > 1 else 'depth'}"
        if name == "visualise_results":
            return name
        return f"{name} " + "/".join(os.path.normpath(args[0]).split(
            os.sep)[-2:])

    def timed(name, fn):
        def run(*args, **kwargs):
            if name == "visualise_results" and not plots:
                log("12 benchmark", "visualise_results left out: this "
                    "machine has no matplotlib (the plots are held on the "
                    "CPU by tests/test_torch_benchmark_harness.py)")
                return None
            if name == "create_depth_maps":
                torch.cuda.synchronize()
                for c in KERNEL_COUNTERS.values():
                    c.launches = 0
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record.append((label(name, args), time.perf_counter() - t0))
            if name == "create_depth_maps":
                model = os.path.basename(os.path.dirname(args[0]))
                launches[model] = launches_since(
                    dict.fromkeys(KERNEL_COUNTERS, 0))
            return out
        return run

    for (mod, name), fn in zip(targets, saved):
        setattr(mod, name, timed(name, fn))
    try:
        yield
    finally:
        for (mod, name), fn in zip(targets, saved):
            setattr(mod, name, fn)


def run_harness(argv: list[str], plots: bool) -> tuple:
    """``harness.main(argv)`` on the card, its progress lines kept back
    (printed if it raises); returns its results, the phases' seconds, the
    launches of each depth-map pass, its wall seconds and its output."""
    from efficientdepthestimation_tpu_torch.benchmark import harness

    record, launches, printed = [], {}, io.StringIO()
    t0 = time.perf_counter()
    try:
        with harness_phases(record, launches, plots), \
                contextlib.redirect_stdout(printed), \
                contextlib.redirect_stderr(io.StringIO()):
            results = harness.main(argv)
    except BaseException:
        print(printed.getvalue()[-4000:], file=sys.stderr)
        raise
    return (json.loads(json.dumps(results)), record, launches,
            time.perf_counter() - t0, printed.getvalue())


def expected_files(models: list[str], plots: bool) -> list[str]:
    """Every file ``harness.main`` writes for BENCH_PAIRS samples."""
    stills = [f"{k:06d}.png" for k in range(3, int(BENCH_FPS / 0.2) + 3,
                                            BENCH_FPS)]
    files = ["nyu.csv", "nyu.tex", "nyu-relative.csv", "nyu-relative.tex",
             "nyu/nyu-depth.png", "nyu/nyu-rendered_images.png"]
    if plots:
        files += [f"plots/{p}.png" for p in ("frame_time", "memory_usage",
                                             "abs_rel", "delta1", "ssim",
                                             "psnr", "lpips")]
    for name in ["ground_truth", "random", *models]:
        render = "nyu/ground_truth" if name == "ground_truth" else \
            f"nyu/{name}/rendered_images"
        for i in range(BENCH_PAIRS):
            files.append(f"{render}/video/{i:06d}.avi")
            files += [f"{render}/image/{i:06d}/{s}" for s in stills]
        if name == "ground_truth":
            continue
        files += [f"nyu/{name}/depth/png/{i:06d}.png"
                  for i in range(BENCH_PAIRS)]
        files += [f"nyu/{name}/{m}_benchmark_metadata.json"
                  for m in ("standard", "visual")]
        if name != "random":
            files += [f"nyu/{name}/depth/raw/{i:06d}.raw"
                      for i in range(BENCH_PAIRS)]
            files.append(f"nyu/{name}/depth/metadata.json")
    return sorted(files)


def render_share(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a.float().cpu() - b.float()).abs().amax(-1)
                  <= RENDER_PIXEL_ATOL).float().mean())


def engine_times(image, depth01, views, card) -> dict:
    """Each engine over one sample's whole sweep on the card: host seconds
    to the synchronize after one warm-up sweep, ms a view and views/s, the
    kernels' busy time and idle share (torch.profiler), the peak memory
    above what was held, and the chunk of views."""
    from efficientdepthestimation_tpu_torch.benchmark import renderer

    out = {}
    for engine, fn in renderer.RENDERERS.items():
        def sweep():
            return fn(image, depth01, views)

        sweep()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sweep()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        busy, records, top = kernel_busy(sweep, calls=1)
        # splat points (mesh: supersampled 3x a side) or rays a view
        per_view = (9 if engine == "mesh" else 1) * image.shape[0] \
            * image.shape[1]
        chunk = max(1, renderer.CHUNK_ELEMENTS // per_view)
        out[engine] = dict(sweep_s=dt, ms_per_view=1e3 * dt / len(views),
                           views_per_s=len(views) / dt, busy_ms=busy,
                           idle_share=1 - busy / (1e3 * dt),
                           peak_gib=peak, chunk_views=min(chunk, len(views)),
                           points_or_rays_per_view=per_view)
        log("12 benchmark", f"{card}: {engine} engine, one sample's sweep "
            f"of {len(views)} views at {tuple(image.shape[:2])}: "
            f"{dt:.3f} s ({1e3 * dt / len(views):.3f} ms a view, "
            f"{len(views) / dt:.1f} views/s, host clock); kernels busy "
            f"{busy:.1f} ms ({records:.0f} records), device idle share "
            f"{1 - busy / (1e3 * dt):.3f}; peak {peak:.3f} GiB above the "
            f"{held / 2**30:.3f} held, chunks of {min(chunk, len(views))} "
            f"views ({per_view} points or rays a view); most device ms: "
            + ", ".join(f"{k} {v:.2f}" for k, v in top[:4]))
    return out


def bench_renders(data, card) -> dict:
    """Each engine on the card against the port's CPU render of sample 0's
    checked views (RENDER_SHARE), at the golden rasterizer's floors at
    96x128, and timed over the whole sweep."""
    from efficientdepthestimation_tpu_torch.benchmark import renderer
    from efficientdepthestimation_tpu_torch.benchmark.metrics import ssim
    from efficientdepthestimation_tpu_torch.benchmark.raster_reference import (
        rasterize_views,
    )
    from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
        render_scene,
    )

    sample = data[0]
    image = np.asarray(sample["image"], np.float32)
    depth = np.squeeze(np.asarray(sample["depth"], np.float32))
    depth01 = (depth - depth.min()) / (depth.max() - depth.min()
                                       + np.finfo(np.float32).tiny)
    views = torch.from_numpy(renderer.sweep_views(BENCH_FPS))
    checked = views[RENDER_CHECK_VIEWS]
    gpu = (torch.from_numpy(image).to(DEVICE),
           torch.from_numpy(depth01).to(DEVICE))
    shares = {}
    for engine, fn in renderer.RENDERERS.items():
        card_frames = fn(*gpu, checked)
        cpu_frames = fn(torch.from_numpy(image), torch.from_numpy(depth01),
                        checked)
        shares[engine] = render_share(card_frames, cpu_frames)
        if not shares[engine] >= RENDER_SHARE[engine]:
            raise RuntimeError(f"{engine} on the card agrees with the CPU on "
                               f"{shares[engine]:.5f} of the pixels")
    log("12 benchmark", f"renders of {len(RENDER_CHECK_VIEWS)} views of "
        f"sample 0 (the first 8 and the 5 stills) on the card against the "
        "CPU: share of pixels within "
        f"{RENDER_PIXEL_ATOL}: " + ", ".join(
            f"{k} {v:.6f} (floor {RENDER_SHARE[k]})"
            for k, v in shares.items()))

    anim = renderer.reference_camera_animation(2.5)
    gviews = np.stack([anim.transform_at(t) for t in np.linspace(
        0.0, 5.0, 4, endpoint=False)]).astype(np.float32)
    golden = {}
    t0 = time.perf_counter()
    for key, floor in GOLDEN_FLOORS.items():
        engine, seed, density = key
        rgb, dm = render_scene(seed, GOLDEN_HW)
        d = dm.astype(np.float32)
        img = rgb.astype(np.float32) / 255.0
        d01 = (d - d.min()) / (d.max() - d.min())
        ref = rasterize_views(img, d01, gviews, mesh_density=density)
        kw = {} if engine == "splat" else {"mesh_density": density}
        ours = renderer.RENDERERS[engine](
            torch.from_numpy(img).to(DEVICE), torch.from_numpy(d01).to(DEVICE),
            torch.from_numpy(gviews), **kw)
        s = float(ssim(torch.from_numpy(ref).to(DEVICE), ours))
        golden[key] = s
        if not s >= floor:
            raise RuntimeError(f"{engine} scene {seed} density {density}: "
                               f"SSIM against the golden rasterizer {s:.4f} "
                               f"< {floor}")
    log("12 benchmark", f"the card's renders against the golden rasterizer "
        f"at {GOLDEN_HW}, SSIM (floor) by engine, scene, density: "
        + ", ".join(f"{e} {sd} {d} {v:.4f} ({GOLDEN_FLOORS[e, sd, d]})"
                    for (e, sd, d), v in golden.items())
        + f"; {time.perf_counter() - t0:.1f} s with the host rasterizer")
    times = engine_times(*gpu, views, card)
    return dict(card_vs_cpu_share=shares, engines=times, golden_ssim={
        f"{e} scene {sd} density {d}": v for (e, sd, d), v in golden.items()})


def bench_visual(out_dir: str, lpips_path: str) -> dict:
    """SSIM, PSNR and LPIPS (seeded random weights) on the card against
    the CPU on the same stills: the ground truth's and ENB0-HU's renders
    of sample 0, normalized as the tracker does."""
    from efficientdepthestimation_tpu_torch.benchmark.datasets import (
        NestedImageFolderDataset,
    )
    from efficientdepthestimation_tpu_torch.benchmark.metrics import (
        load_lpips_weights,
        lpips_alex,
        psnr,
        ssim,
    )

    def stills(path):
        ds = NestedImageFolderDataset(os.path.join(out_dir, "nyu", path))
        x = np.stack([ds[i] for i in range(5)]).astype(np.float32)
        return (x - x.min()) / max(x.max() - x.min(),
                                   np.finfo(np.float32).tiny)

    a = torch.from_numpy(stills("ground_truth/image"))
    b = torch.from_numpy(stills("reside_enb0/rendered_images/image"))
    errs, values = {}, {}
    for name, fn in (("ssim", ssim), ("psnr", psnr)):
        card_v, cpu_v = float(fn(a.to(DEVICE), b.to(DEVICE))), float(fn(a, b))
        values[name], errs[name] = card_v, abs(card_v - cpu_v)
        if not errs[name] <= VISUAL_ATOL:
            raise RuntimeError(f"{name} on the card {card_v} against the "
                               f"CPU {cpu_v}")
    weights = load_lpips_weights(lpips_path)
    cpu_v = lpips_alex(2 * a - 1, 2 * b - 1, weights)
    card_v = lpips_alex(2 * a.to(DEVICE) - 1, 2 * b.to(DEVICE) - 1,
                        load_lpips_weights(lpips_path, device=DEVICE)).cpu()
    errs["lpips_rel"] = float(((card_v - cpu_v).abs() / cpu_v.abs()).max())
    values["lpips"] = card_v.tolist()
    if not errs["lpips_rel"] <= LPIPS_RTOL:
        raise RuntimeError(f"lpips on the card {card_v} against the CPU "
                           f"{cpu_v}")
    log("12 benchmark", f"visual metrics of 5 stills on the card against "
        f"the CPU: {values}; errors {errs} (SSIM, PSNR absolute, within "
        f"{VISUAL_ATOL}; LPIPS relative, within {LPIPS_RTOL})")
    return dict(values=values, errors=errs)


def bench_depths(out_dir: str, tmp: str, csv_path: str) -> dict:
    """Each model's ``.raw`` depth maps against the port's CPU forward of
    the same frames, upsampled as ``create_depth_maps`` does."""
    from efficientdepthestimation_tpu_torch.benchmark.datasets import (
        DepthDataset,
        ImageFolderDataset,
        nyu_eval_sample,
    )
    from efficientdepthestimation_tpu_torch.benchmark.depth_model import (
        MidasModel,
        ReSIDEModel,
    )

    data = DepthDataset(csv_path, transform=nyu_eval_sample(32))
    images = torch.from_numpy(np.stack([data[i]["image"]
                                        for i in range(len(data))]))
    errs = {}
    for name, (path, _) in BENCH_MODELS.items():
        raw = np.stack(list(ImageFolderDataset(os.path.join(
            out_dir, "nyu", name, "depth", "raw"))))
        if path is None:
            want = np.zeros_like(raw)
        else:
            staged = os.path.join(tmp, os.path.basename(path).replace(
                "-synthetic", ""))
            model = (ReSIDEModel(staged, encoder="efficientnet-b0",
                                 device="cpu") if name.startswith("reside")
                     else MidasModel(staged, device="cpu"))
            want = resize_bilinear_align_corners(
                model(images)[..., None], images.shape[1:3])[..., 0].numpy()
        errs[name] = float(np.abs(raw - want).max())
        if raw.shape != (BENCH_PAIRS, *BENCH_INPUT_HW) or \
                not errs[name] <= BENCH_DEPTH_ATOL:
            raise RuntimeError(f"{name}: depth maps {raw.shape} differ from "
                               f"the CPU forward by {errs[name]}")
    log("12 benchmark", f"the .raw depth maps of the card's f32 forwards "
        f"against the port's CPU forward of the same frames, max |Δ| m: "
        f"{errs} (within {BENCH_DEPTH_ATOL})")
    return errs


def finite_or_none(obj):
    """``obj`` with each NaN or infinite float as None (strict JSON), and
    tuple keys joined."""
    if isinstance(obj, dict):
        return {(" ".join(map(str, k)) if isinstance(k, tuple) else k):
                finite_or_none(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite_or_none(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def read_video(path: str) -> tuple[np.ndarray, str]:
    """Every frame of a video as cv2 reads it, RGB, and its FourCC."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        code = int(cap.get(cv2.CAP_PROP_FOURCC))
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame[:, :, ::-1])
    finally:
        cap.release()
    fourcc = "".join(chr((code >> 8 * i) & 0xFF) for i in range(4))
    return np.stack(frames), fourcc


def bench_encode_routes(data, tmp: str, card: str) -> dict:
    """The renderer's sweep of every sample (``create_rendered_images``,
    mesh, fps BENCH_FPS) on the native encode route and on the cv2/PIL
    route (the native encoder reported unavailable), each's
    ``render_time``; the stills equal on both, the MJPEG AVI of sample 0
    read by cv2 with every view, within ENCODE_MEAN_ABS of the frames
    rendered on the card."""
    from efficientdepthestimation_tpu_torch.benchmark import renderer

    samples = [data[i] for i in range(len(data))]
    routes = ("native", "pil") if native_encoder.is_available() else ("pil",)
    dirs, times = {}, {}
    for route in routes:
        dirs[route] = os.path.join(tmp, f"sweep-{route}")
        with contextlib.nullcontext() if route == "native" else native_off(), \
                contextlib.redirect_stdout(io.StringIO()):
            times[route] = renderer.create_rendered_images(
                dirs[route], samples, fps=BENCH_FPS,
                device=DEVICE).total_seconds()
    out = dict(render_time_s=times, samples=len(samples))
    if "native" in routes:
        stills = 0
        for i in range(len(samples)):
            names = sorted(os.listdir(os.path.join(dirs["pil"], "image",
                                                   f"{i:06d}")))
            for name in names:
                a, b = (read_image(os.path.join(dirs[r], "image", f"{i:06d}",
                                                name)) for r in routes)
                if not np.array_equal(a, b):
                    raise RuntimeError(f"still {i}/{name} differs between "
                                       "the native and the PIL route")
            stills += len(names)
        image, depth01 = renderer.sweep_inputs(samples[0])
        views = torch.from_numpy(renderer.sweep_views(BENCH_FPS))
        frames = renderer.render_novel_views_mesh(
            torch.from_numpy(image).to(DEVICE),
            torch.from_numpy(depth01).to(DEVICE), views, fov_y_deg=18.0,
            displacement_factor=4.0, mesh_density=8)
        frames = (torch.clamp(frames, 0.0, 1.0) * 255.0).to(torch.uint8)
        frames = frames.cpu().numpy()
        read, fourcc = read_video(os.path.join(dirs["native"], "video",
                                               "000000.avi"))
        if read.shape != frames.shape or fourcc != "MJPG":
            raise RuntimeError(f"the native sweep video reads as {fourcc} "
                               f"{read.shape}, rendered {frames.shape}")
        mae = float(np.abs(read.astype(np.int16) - frames).mean())
        if not mae < ENCODE_MEAN_ABS:
            raise RuntimeError(f"the MJPEG sweep is {mae:.3f} levels from "
                               f"the rendered frames (< {ENCODE_MEAN_ABS})")
        out.update(stills_equal=stills, mjpeg_frames=len(read),
                   mjpeg_mean_abs=mae, fourcc=fourcc)
        log("12 benchmark", f"ok: the native route's {stills} PNG stills "
            f"equal the PIL route's; sample 0's MJPEG AVI ({fourcc}) reads "
            f"back in cv2 as {len(read)} views, {mae:.3f} levels from the "
            f"rendered frames on average (< {ENCODE_MEAN_ABS})")
    log("12 benchmark", f"{card}: create_rendered_images of {len(samples)} "
        f"samples x {len(renderer.sweep_views(BENCH_FPS))} views, "
        "render_time by encode route, in turns: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in times.items())
        + ("" if "native" in routes else
           " (the native encoder is not built here)"))
    return out


def read_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img)


def phase_benchmark(card) -> dict:
    """12: the user-centred benchmark on the card through
    ``benchmark.harness.main``, checked against the CPU and the golden
    rasterizer, and timed."""
    import importlib.util
    import shutil

    from efficientdepthestimation_tpu_torch.benchmark.datasets import (
        DepthDataset,
        nyu_eval_sample,
    )

    t0 = time.perf_counter()
    timed = bench_kernels(card)
    plots = importlib.util.find_spec("matplotlib") is not None
    host = {m: importlib.util.find_spec(m) is not None
            for m in ("pandas", "matplotlib", "cv2", "PIL")}
    log("12 benchmark", f"host packages on this machine: {host}")
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        _, csv_path = generate_dataset(os.path.join(tmp, "nyu"), n_train=0,
                                       n_test=BENCH_PAIRS)
        with open(os.path.join(tmp, "nyu", "camera.json"), "w") as f:
            json.dump(NYU_CAMERA, f)
        log("12 benchmark", f"{BENCH_PAIRS} test pairs of generate_dataset "
            f"at {FRAME_HW} written in {time.perf_counter() - t1:.1f} s "
            f"(cut from NYU-v2's 654 test pairs for time; fps {BENCH_FPS}, "
            "mesh density 8, supersample 3, displacement 4.0 uncut)")
        staged = {}
        for name, (path, _) in BENCH_MODELS.items():
            if path is not None:
                staged[name] = os.path.join(tmp, os.path.basename(
                    path).replace("-synthetic", ""))
                shutil.copy(path, staged[name])
        lpips_path = lpips_standin(tmp)
        os.environ["LPIPS_ALEX_WEIGHTS"] = lpips_path
        out_dir = os.path.join(tmp, "out")
        argv = ["--csv-path", csv_path, "--output-path", out_dir,
                "--batch-size", str(BENCH_BATCH), "--renderer-fps",
                str(BENCH_FPS), "--baseline-model", "reside_enb0",
                "--models"] + [f"{k}={v}" for k, v in staged.items()]
        results, record, launches, wall, _ = run_harness(argv, plots)

        forwards = math.ceil(BENCH_PAIRS / BENCH_BATCH) + 1  # + peak probe
        for name, (_, per_forward) in BENCH_MODELS.items():
            want = (forwards * per_forward[0], forwards * per_forward[1], 0, 0)
            if launches.get(name) != want:
                raise RuntimeError(f"{name}: depth maps launched "
                                   f"{launches.get(name)}, expected {want}")
        log("12 benchmark", f"harness.main on the card in {wall:.1f} s; "
            f"launches (depthwise, upsample-conv, loss forward, loss "
            f"backward) of each model's depth maps, {forwards} f32 "
            f"forwards ({forwards - 1} batches of {BENCH_BATCH} and the "
            f"peak-memory call): {launches}")
        files = sorted(os.path.relpath(os.path.join(d, f), out_dir)
                       for d, _, fs in os.walk(out_dir) for f in fs)
        missing = sorted(set(expected_files(list(BENCH_MODELS), plots))
                         - set(files))
        if missing:
            raise RuntimeError(f"harness outputs missing: {missing[:10]}")
        rows = results["nyu"]
        for name, row in rows.items():
            # LOG10 of the flat baseline's 0 m is NaN, as in the JAX
            # package; MIFD is NaN where SIFT matches nothing
            bad = [k for k, v in row.items() if k not in ("log10", "mifd")
                   and not math.isfinite(v)]
            if bad:
                raise RuntimeError(f"{name}: non-finite {bad}")
        for name in BENCH_MODELS:
            src = json.load(open(os.path.join(out_dir, "nyu", name, "depth",
                                              "metadata.json")))
            if src["peak_memory_source"] != "live":
                raise RuntimeError(f"{name}: memory {src}")

        again, _, launches2, wall2, text2 = run_harness(argv, plots)
        hits = text2.count("Found cached results")
        # the ground truth's and the noisy maps' renders, the noisy maps,
        # their two benchmarks; each model's depth maps, render and two
        # benchmarks
        expected_hits = 5 + 4 * len(BENCH_MODELS)
        retimed = ("standard_benchmark_time", "visual_benchmark_time",
                   "render_time")
        same = all(again["nyu"][m][k] == v or v != v and again["nyu"][m][k]
                   != again["nyu"][m][k] for m, row in rows.items()
                   for k, v in row.items() if k not in retimed)
        if hits != expected_hits or not same or any(
                sum(v) for v in launches2.values()):
            raise RuntimeError(f"second harness.main: {hits} cache hits "
                               f"(expected {expected_hits}), same table "
                               f"{same}, launches {launches2}")
        log("12 benchmark", f"a second harness.main hit all {hits} caches "
            f"in {wall2:.1f} s and returned the same table, 0 launches")

        depth_errs = bench_depths(out_dir, tmp, csv_path)
        visual = bench_visual(out_dir, lpips_path)
        data = DepthDataset(csv_path, transform=nyu_eval_sample(1))
        renders = bench_renders(data, card)
        encode = bench_encode_routes(data, tmp, card)
        del os.environ["LPIPS_ALEX_WEIGHTS"]

    phases = {}
    for label, seconds in record:
        phases[label] = phases.get(label, 0.0) + seconds
    per_model = {m: {k: rows[m][k] for k in (
        "frame_time", "peak_memory_usage", "render_time", "inference_time",
        "inference_time_no_io")} for m in BENCH_MODELS}
    seconds = time.perf_counter() - t0
    log("12 benchmark", f"{card}: harness.main {wall:.1f} s by phase: "
        + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()))
    log("12 benchmark", f"{card}: per model (frame_time s, peak GB, "
        f"render_time s): " + "; ".join(
            f"{m} " + ", ".join(f"{k}={v:.6g}" for k, v in r.items())
            for m, r in per_model.items()))
    log("12 benchmark", f"ok: phase 12 in {seconds:.1f} s")
    return dict(card=card, seconds=seconds, pairs=BENCH_PAIRS,
                fps=BENCH_FPS, views_per_sample=int(BENCH_FPS / 0.2) + 3,
                main_s=wall, cached_main_s=wall2, phases_s=phases,
                launches={k: list(v) for k, v in launches.items()},
                per_model=per_model, table={m: {
                    k: v for k, v in r.items()} for m, r in rows.items()},
                depth_max_abs_m=depth_errs, visual=visual,
                renders=renders, encode_routes=encode,
                kernels_f32_batch4=timed,
                host_packages=host, plots=plots)


# Phase 13: parallelism. Two ranks share the card over gloo (NCCL refuses
# two ranks on one device); their f32 step at CHECK_BATCH is held against
# the one-process step on the whole batch: the loss and metrics to rtol
# ``metrics``, the gradients to ``grad`` of their norm, the BN statistics
# to ``stats`` relative (floor 1e-3), each weight within Adam's largest
# update difference (2·LR) of the other. The gradients differ by 2.2e-5
# of their norm on the CPU (tests/test_torch_multiprocess.py) and by
# 6.9e-4 on the card, where cuDNN's deterministic algorithms for 4 images
# and for 8 sum in other orders.
PARALLEL_TOL = dict(metrics=1e-5, grad=1e-3, stats=1e-4)
PARALLEL_WORLD, PARALLEL_TIMEOUT_S = 2, 300


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def state_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(v, b[k])
                                        for k, v in a.items())


def f32_step(mesh, model, batch, **kw) -> dict:
    """One f32 step of ``model`` (in place) on ``batch`` (the rank's rows
    under a mesh of several): metrics, gradients and the model's state."""
    state = create_train_state(model, LR, WEIGHT_DECAY, mesh=mesh, **kw)
    step = make_train_step(device=DEVICE, mesh=mesh)
    state, metrics = step(state, batch, 5)
    return dict(state=state, metrics={k: float(v) for k, v in
                                      metrics.items()},
                grads={n: p.grad.clone() for n, p in
                       model.named_parameters()},
                weights={k: v.clone() for k, v in model.state_dict().items()})


def parallel_step_rate(mesh, card) -> dict:
    """13a: the bf16 step at TRAIN_BATCH on the mesh of one rank: exact
    launches, and images/s beside the mesh-less step's, in turns (plain,
    mesh, mesh, plain); the mesh step's device idle share."""
    batch = train_batch(range(TRAIN_BATCH))
    draws = draw_augmentation(torch.Generator().manual_seed(1), TRAIN_BATCH)
    runs = {}
    for label, m in (("plain", None), ("mesh", mesh)):
        model = load_any_checkpoint(CHECKPOINT, device=DEVICE)
        runs[label] = (create_train_state(model, LR, WEIGHT_DECAY, mesh=m),
                       make_train_step(mixed_precision=True, device=DEVICE,
                                       mesh=m))
    state, step = runs["mesh"]
    for c in KERNEL_COUNTERS.values():
        c.launches = 0
    step(state, batch, 0, draws=draws)
    launches = launches_since(dict.fromkeys(KERNEL_COUNTERS, 0))
    if launches != TRAIN_STEP_LAUNCHES["none"]:
        raise RuntimeError(f"mesh step launches {launches}, expected "
                           f"{TRAIN_STEP_LAUNCHES['none']}")
    rates = {"plain": [], "mesh": []}
    for label in ("plain", "mesh", "mesh", "plain"):
        rates[label].append(timed_steps(*runs[label], batch,
                                        draws)["images_per_s"])
    busy_ms, _, _ = kernel_busy(lambda: step(state, batch, 0, draws=draws))
    step_ms = 1e3 * TRAIN_BATCH / float(np.mean(rates["mesh"]))
    out = dict(launches=launches, images_per_s=rates,
               busy_ms=busy_ms, step_ms=step_ms,
               idle_share=1 - busy_ms / step_ms)
    log("13 parallel", f"{card}: mesh (1 rank, NCCL) bf16 step at batch "
        f"{TRAIN_BATCH}: launches {launches}; images/s mesh "
        + ", ".join(f"{v:.1f}" for v in rates["mesh"]) + " against plain "
        + ", ".join(f"{v:.1f}" for v in rates["plain"])
        + f" (plain, mesh, mesh, plain); kernels busy {busy_ms:.2f} of "
        f"{step_ms:.2f} ms, idle share {out['idle_share']:.3f}")
    return out


def parallel_exact(mesh, card) -> dict:
    """13b-d: f32 at CHECK_BATCH with deterministic cuDNN and drop-connect
    on: the mesh step bit for bit the plain one; three ZeRO-1 steps with
    plain Adam's moments; a ZeRO-1 train state loaded into a plain state,
    the next step of each bit for bit."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        batch = train_batch(range(CHECK_BATCH))
        models = [load_any_checkpoint(CHECKPOINT, device=DEVICE)
                  for _ in range(2)]
        if not models[0].E.drop_connect_rate > 0:
            raise RuntimeError("drop-connect is off")
        plain, meshed = (f32_step(m, model, batch) for m, model in
                         ((None, models[0]), (mesh, models[1])))
        if not (plain["metrics"] == meshed["metrics"]
                and state_equal(plain["grads"], meshed["grads"])
                and state_equal(plain["weights"], meshed["weights"])):
            raise RuntimeError("the mesh f32 step differs from the plain "
                               "one")
        # ZeRO-1 (every moment on rank 0 in a world of one) against plain
        # Adam, three steps each
        states = {}
        for label, kw in (("plain", {}), ("zero1", {"zero1": True})):
            model = load_any_checkpoint(CHECKPOINT, device=DEVICE)
            state = create_train_state(model, LR, WEIGHT_DECAY, mesh=mesh,
                                       **kw)
            step = make_train_step(device=DEVICE, mesh=mesh)
            for _ in range(3):
                state, _ = step(state, batch, 5)
            states[label] = (state, step)
        moments = 0
        for (_, p), (_, q) in zip(states["plain"][0].trained(),
                                  states["zero1"][0].trained()):
            a = states["plain"][0].optimizer.state[p]
            b = states["zero1"][0].optimizer.state[q]
            for key in ("step", "exp_avg", "exp_avg_sq"):
                if not torch.equal(a[key], b[key]):
                    raise RuntimeError(f"ZeRO-1 Adam {key} differs")
            moments += 2
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "zero1.ede")
            save_train_state(path, states["zero1"][0],
                             encoder="efficientnet-b0", decoder="hu2018",
                             epoch=0, step_in_epoch=3)
            loaded, _ = load_train_state(path, create_train_state(
                load_any_checkpoint(CHECKPOINT, device=DEVICE), LR,
                WEIGHT_DECAY))
        nxt = {}
        for label, (state, step) in (("zero1", states["zero1"]),
                                     ("loaded", (loaded, make_train_step(
                                         device=DEVICE)))):
            state, _ = step(state, batch, 5)
            nxt[label] = state.model.state_dict()
        if not state_equal(nxt["zero1"], nxt["loaded"]):
            raise RuntimeError("the ZeRO-1 state's next step differs once "
                               "loaded into a plain state")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log("13 parallel", f"{card}: f32 at batch {CHECK_BATCH}, deterministic "
        "cuDNN, drop-connect on: the mesh step bit for bit the plain one "
        f"(loss {plain['metrics']['loss']:.6f}); 3 ZeRO-1 steps: all "
        f"{moments} Adam moments and the counts bit for bit plain Adam's; "
        "the ZeRO-1 train state loaded into a plain state takes the next "
        "step bit for bit")
    return dict(f32_loss=plain["metrics"]["loss"], zero1_moments=moments)


def parallel_serve(mesh, frames, card) -> dict:
    """13e: mesh serving of phase 4's frames: 16 + 5 launches, bit for bit
    the mesh-less call."""
    model = load_any_checkpoint(CHECKPOINT, device=DEVICE)
    kw = dict(upsample_to=FRAME_HW, dtype=torch.bfloat16, preprocess=True)
    ref = make_serving_fn(model, device=DEVICE, **kw)(frames)
    out, launches = serve_counted(make_serving_fn(model, mesh=mesh, **kw),
                                  frames, "ENB0-HU mesh", ENB0_HU_LAUNCHES)
    if not torch.equal(out, ref):
        raise RuntimeError("mesh serving differs from the mesh-less call")
    log("13 parallel", f"mesh serving of {frames.shape[0]} frames: launches "
        f"{launches}, bit for bit the mesh-less call")
    return dict(launches=launches)


def training_collective(n: int) -> str:
    """A training step's collective of ``n`` elements: gradient buckets (at
    least 2^16 elements), metric sums (10) and BN statistics (the rest)."""
    return ("gradients" if n >= 1 << 16 else "metrics" if n == 10
            else "batchnorm")


def collective_ms(fn, kind_of=training_collective) -> dict:
    """One ``fn()`` with every ``all_reduce`` and ``broadcast`` timed on the
    host clock between two synchronizes, by ``kind_of`` its element
    count."""
    spent = {}
    saved = dist.all_reduce, dist.broadcast

    def timed(collective):
        def call(tensor, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = collective(tensor, *args, **kwargs)
            torch.cuda.synchronize()
            entry = spent.setdefault(kind_of(tensor.numel()),
                                     {"calls": 0, "ms": 0.0})
            entry["calls"] += 1
            entry["ms"] += 1e3 * (time.perf_counter() - t0)
            return result
        return call

    dist.all_reduce, dist.broadcast = timed(saved[0]), timed(saved[1])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        spent["step_ms"] = 1e3 * (time.perf_counter() - t0)
    finally:
        dist.all_reduce, dist.broadcast = saved
    return spent


def parallel_rank(argv: list[str]) -> None:
    """One of two processes sharing the card over gloo (13f): an f32 step
    at CHECK_BATCH, then bf16 steps at TRAIN_BATCH, on its rows; results to
    the directory ``argv[1]``."""
    rank, tmp = int(argv[0]), argv[1]
    if not maybe_initialize_distributed(device=DEVICE, backend="gloo"):
        raise RuntimeError("no process group from the environment")
    mesh = create_mesh(device=f"{DEVICE}:0", backend="gloo")

    def local_batch(n: int) -> dict:
        """This rank's rows of ``train_batch(range(n))``, rendering only
        those (row i is scene i), with the global batch's ``num_valid``."""
        rows = process_local_rows(mesh, n)
        return {**train_batch(rows.tolist()), "num_valid": n}

    torch.backends.cudnn.deterministic = True
    got = f32_step(mesh, load_any_checkpoint(CHECKPOINT, device=DEVICE),
                   local_batch(CHECK_BATCH))
    if rank == 0:
        torch.save({k: got[k] if k == "metrics" else
                    {n: v.cpu() for n, v in got[k].items()}
                    for k in ("metrics", "grads", "weights")},
                   os.path.join(tmp, "f32.pt"))
    torch.backends.cudnn.deterministic = False

    batch = local_batch(TRAIN_BATCH)
    draws = draw_augmentation(torch.Generator().manual_seed(1), TRAIN_BATCH)
    state = create_train_state(load_any_checkpoint(CHECKPOINT, device=DEVICE),
                               LR, WEIGHT_DECAY, mesh=mesh)
    step = make_train_step(mixed_precision=True, device=DEVICE, mesh=mesh)
    before = all_launches()
    step(state, batch, 0, draws=draws)
    launches = launches_since(before)
    for _ in range(POLICY_WARMUP):
        step(state, batch, 0, draws=draws)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(POLICY_ITERS):
        step(state, batch, 0, draws=draws)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    collectives = collective_ms(lambda: step(state, batch, 0, draws=draws))
    epoch = cli_epoch(mesh, state, step, batch)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(dict(launches=launches, seconds=dt, steps=POLICY_ITERS,
                       collectives=collectives, epoch=epoch,
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30),
                  f)
    dist.destroy_process_group()


class HeldRows:
    """A rank's rows of a batch held on the host as a dataset of
    ``length`` rows: global row i is held row i mod n, and ``load_batch``
    is a gather standing in for the decode."""

    def __init__(self, batch: dict, length: int):
        self.image = batch["image"].cpu().numpy()
        self.depth = batch["depth"].cpu().numpy()
        self.length = length

    def __len__(self):
        return self.length

    def load_batch(self, indices):
        at = np.asarray(indices) % len(self.image)
        return self.image[at], self.depth[at]


def cli_epoch(mesh, state, step, batch) -> dict:
    """The training CLI's epoch loop (``run_train_epoch``) over
    POLICY_ITERS global batches of TRAIN_BATCH from the rank's rows held on
    the host, ms a step; and ``any_rank`` (the stop flag's reduction at
    each step boundary) alone, ms a call."""
    data = HeldRows(batch, TRAIN_BATCH * POLICY_ITERS)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train_app.run_train_epoch(state, step, data, TRAIN_BATCH, 0, 0,
                                  device=DEVICE, mesh=mesh)
    torch.cuda.synchronize()
    epoch_ms = 1e3 * (time.perf_counter() - t0) / POLICY_ITERS
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(100):
        any_rank(False, mesh)
    return dict(epoch_step_ms=epoch_ms,
                any_rank_ms=10 * (time.perf_counter() - t0))


def launch_ranks(tmp: str, flag: str = "--parallel-rank") -> None:
    """``chip_smoke.py FLAG R`` for each rank, joined by a ``file://``
    store in ``tmp``; a rank that fails ends the others, and each rank's
    log tail is printed before this raises."""
    env = dict(os.environ, EDE_COORDINATOR_ADDRESS=f"file://{tmp}/store",
               EDE_NUM_PROCESSES=str(PARALLEL_WORLD), EDE_DIST_TIMEOUT="120")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(key, None)
    logs = [open(os.path.join(tmp, f"log{r}.txt"), "w")
            for r in range(PARALLEL_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r), tmp],
        env={**env, "EDE_PROCESS_ID": str(r)},
        stdout=logs[r], stderr=subprocess.STDOUT, cwd=ROOT)
        for r in range(PARALLEL_WORLD)]
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.returncode
                                                  for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for f in logs:
            f.close()
    if any(p.returncode for p in procs):
        for r in range(PARALLEL_WORLD):
            with open(os.path.join(tmp, f"log{r}.txt")) as f:
                print(f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                      + f.read()[-4000:], file=sys.stderr)
        raise RuntimeError("two ranks on one card over gloo failed: "
                           + ", ".join(f"rank {r} exit {p.returncode}"
                                       for r, p in enumerate(procs)))


def parallel_two_ranks(card) -> dict:
    """13f: two processes on the one card over gloo with CUDA tensors."""
    with tempfile.TemporaryDirectory() as tmp:
        launch_ranks(tmp)
        got = torch.load(os.path.join(tmp, "f32.pt"), weights_only=False)
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                 for r in range(PARALLEL_WORLD)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = f32_step(None, load_any_checkpoint(CHECKPOINT, device=DEVICE),
                       train_batch(range(CHECK_BATCH)))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    metrics = max(abs(got["metrics"][k] - v) / max(abs(v), 1e-12)
                  for k, v in ref["metrics"].items() if v == v)
    num = sum(float((got["grads"][k].to(DEVICE) - g).double().square()
                    .sum()) for k, g in ref["grads"].items())
    den = sum(float(g.double().square().sum())
              for g in ref["grads"].values())
    grad = (num / den) ** 0.5
    stats = weights = 0.0
    for key, value in ref["weights"].items():
        diff = (got["weights"][key].to(DEVICE) - value).abs()
        if "running" in key:
            stats = max(stats, float((diff / value.abs().clamp(min=1e-3))
                                     .max()))
        else:
            weights = max(weights, float(diff.max()))
    errs = dict(metrics=metrics, grad=grad, stats=stats)
    if any(not errs[k] <= PARALLEL_TOL[k] for k in errs) or \
            not weights <= 2 * LR * 1.001:
        raise RuntimeError(f"two ranks' f32 step vs one process: {errs}, "
                           f"weights {weights} (tolerances {PARALLEL_TOL}, "
                           f"2·LR)")
    for r in ranks:
        if tuple(r["launches"]) != TRAIN_STEP_LAUNCHES["none"]:
            raise RuntimeError(f"a rank's step launched {r['launches']}")
    slowest = max(r["seconds"] for r in ranks)
    rate = TRAIN_BATCH * POLICY_ITERS / slowest
    log("13 parallel", f"{card}: 2 ranks over gloo on one card, f32 at "
        f"batch {CHECK_BATCH} ({CHECK_BATCH // 2} a rank) against one "
        f"process: worst relative errors {errs} within {PARALLEL_TOL}, "
        f"weights within {weights:.3g} (<= 2·LR); bf16 at batch "
        f"{TRAIN_BATCH}: {rate:.1f} images/s of the global batch (slowest "
        f"rank, {1e3 * slowest / POLICY_ITERS:.1f} ms a step), launches a "
        f"rank {ranks[0]['launches']}; collectives of one step, ms (calls): "
        + "; ".join(f"rank {i} " + ", ".join(
            f"{k} {v['ms']:.1f} ({v['calls']})" for k, v in
            r["collectives"].items() if k != "step_ms")
            + f" of {r['collectives']['step_ms']:.1f}"
            for i, r in enumerate(ranks))
        + "; the CLI's epoch loop, ms a step (bare step; any_rank ms): "
        + "; ".join(f"rank {i} {r['epoch']['epoch_step_ms']:.1f} "
                    f"({1e3 * r['seconds'] / r['steps']:.1f}; "
                    f"{r['epoch']['any_rank_ms']:.3f})"
                    for i, r in enumerate(ranks)))
    return dict(f32=errs, f32_weights_max_abs=weights,
                images_per_s=rate, ranks=ranks)


def phase_parallel(frames, card) -> dict:
    """13: the data-parallel mesh (see the module docstring)."""
    t0 = time.perf_counter()
    os.environ["MASTER_ADDR"] = "127.0.0.1"
    os.environ["MASTER_PORT"] = str(free_port())
    dist.init_process_group("nccl", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = create_mesh(backend="nccl")
        t = torch.arange(4.0, device=DEVICE)
        dist.all_reduce(t)
        if mesh.distributed or not torch.equal(
                t, torch.arange(4.0, device=DEVICE)):
            raise RuntimeError(f"NCCL world of one: {mesh}, all_reduce {t}")
        log("13 parallel", f"NCCL process group of one rank: mesh "
            f"{mesh.shape} on {mesh.device}, all_reduce checked")
        out = dict(step=parallel_step_rate(mesh, card),
                   exact=parallel_exact(mesh, card),
                   serve=parallel_serve(mesh, frames, card))
    finally:
        dist.destroy_process_group()
        for key in ("MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(key)
    out["two_ranks"] = parallel_two_ranks(card)
    out["seconds"] = time.perf_counter() - t0
    out["card"] = card
    log("13 parallel", f"ok: phase 13 in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 14

# Phase 14 serves every configuration of FORMS_CONFIGS in each serving form
# (apps.common) at BATCH, bf16, on phase 4's frames: monolithic, staged
# under each MFF merge (Hu2018), the depthwise modes "xla" and "shift"
# (EfficientNet encoders); at each of BIG_BATCHES (phase 4's frames
# repeated) the monolithic form in one call and, below the last, in tiles
# of half the batch (at the first also tiled-staged), BIG_ITERS timed calls
# after the counted one, a run out of device memory recorded as such; the
# int8 sites and forwards of INT8_CONFIGS; and the autotuner on
# TUNE_CONFIGS and on the ENB0-HU training step.
# A configuration of each encoder and decoder family: ENB4-HU, ENB4-LR and
# RN50-LR take the code paths of ENB0-HU, ENB0-LR and RN50-HU at other
# widths and are left out here and in phase 15, to keep the whole script
# inside its time limit beside phase 17 (their forms and baked forms were
# last run at commit 0e6bf95); phase 8 still serves them and phase 11
# trains them. Batches above BATCH are served by ENB0-HU alone
# (BIG_CONFIGS).
FORMS_CONFIGS = ("ENB0-HU", "ENB0-LR", "RN50-HU", "DN161-HU", "SN154-HU")
BIG_CONFIGS = ("ENB0-HU",)
BIG_BATCHES = (2 * BATCH, 4 * BATCH, 8 * BATCH)
# Two timed calls after the counted one, so that a refit of TILE_ABOVE
# reads more than one call (on an H100 at 700 W phase 14 took 192 s so,
# 185 s with one).
BIG_ITERS = 2
INT8_CONFIGS = ("RN50-HU", "SN154-HU", "DN161-HU", "ENB0-HU")
# rel_out_err of an int8 forward against the float form of the same model
# (the norm of the difference over the float output's): the JAX package's
# ceiling for its int8 conv tower (tests/test_quant.py). A CPU run of the
# port in f32 at 228x304 on two frames shows 0.022 (RN50-HU), 0.016
# (SN154-HU) and 0.0003 (DN161-HU).
INT8_REL_MAX = 0.03
INT8_GRAPH_ITERS, INT8_GRAPH_REPLAYS = 3, 2
INT8_WARMUP, INT8_ITERS = 1, 3
TUNE_CONFIGS = ("ENB0-HU",)
# The autotuners' calls a candidate (after one untimed call): serving,
# then training steps.
TUNE_WARMUP, TUNE_ITERS = 1, 3
TRAIN_TUNE_WARMUP, TRAIN_TUNE_ITERS = 0, 2


def forms_model(name: str) -> tuple[torch.nn.Module, tuple[int, int]]:
    """A configuration on the card as phases 4, 7 and 8 build it, and the
    launches of its forward (depthwise, upsample-conv)."""
    if name == "ENB0-HU":
        return load_any_checkpoint(CHECKPOINT, device=DEVICE), ENB0_HU_LAUNCHES
    if name == "ENB0-LR":
        return load_any_checkpoint(LR_CHECKPOINT, device=DEVICE), (16, 0)
    return random_model(name), RANDOM_CONFIGS[name][3]


def form_specs(name: str, model) -> list[tuple[str, dict]]:
    specs = [("monolithic", dict(path="monolithic", dw_impl="pallas"))]
    if isinstance(model, HuDepthModel):
        specs += [(f"staged/{m}", dict(path="staged", dw_impl="pallas",
                                       mff_merge=m)) for m in MFF_MERGES]
    if name.startswith("ENB"):
        specs += [(f"monolithic/{dw}", dict(path="monolithic", dw_impl=dw))
                  for dw in ("xla", "shift")]
    return specs


def form_error(name: str, out: torch.Tensor, ref: torch.Tensor,
               what: str, factor: float = 1.0) -> tuple[float, float]:
    """Max and mean |out - ref| within phase 5's bf16 tolerances (times
    ``factor``): in metres for the two trained models, relative to
    max|ref| for the random ones."""
    err = (out - ref).abs()
    e_max, e_mean = err.max().item(), err.mean().item()
    if name == "ENB0-HU":
        limit = BF16_MODEL_MAX_ABS, BF16_MODEL_MEAN_ABS
    elif name == "ENB0-LR":
        limit = BF16_LR_MAX_ABS, BF16_LR_MEAN_ABS
    else:
        scale = ref.abs().max().item()
        e_max, e_mean = e_max / scale, e_mean / scale
        limit = BF16_RANDOM_MAX_REL, BF16_RANDOM_MEAN_REL
    limit = (factor * limit[0], factor * limit[1])
    if not (e_max <= limit[0] and e_mean <= limit[1]):
        raise RuntimeError(f"{name} {what}: max {e_max} mean {e_mean}, "
                           f"limits {limit}")
    return e_max, e_mean


def batch_rate(serve, frames, warmup: int, iters: int) -> dict:
    """frames/s on the host clock over ``iters`` calls after ``warmup``,
    and the peak device memory of those calls."""
    for _ in range(warmup):
        serve(frames)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        serve(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return dict(frames_per_s=frames.shape[0] * iters / dt,
                ms_per_batch=1e3 * dt / iters,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def serving_form_fn(model, spec: dict):
    return build_serving_candidate(model, spec, upsample_to=FRAME_HW,
                                   dtype=torch.bfloat16, preprocess=True,
                                   device=DEVICE)


def int8_sites(model) -> list[dict]:
    """The convs an int8 bf16 forward of one INPUT_HW image quantizes
    (every call of ``ops.quant.quant_conv2d``, recorded), one a shape."""
    sites, saved = {}, quant.quant_conv2d

    def record(x, weight, *, stride=(1, 1), padding=((0, 0), (0, 0)),
               bias=None, amax=None):
        key = (tuple(x.shape[1:]), tuple(weight.shape), tuple(stride),
               tuple(map(tuple, padding)))
        site = sites.setdefault(key, dict(
            hw=tuple(x.shape[1:3]), cin=x.shape[-1], weight=weight,
            stride=tuple(stride), padding=padding, bias=bias, count=0))
        site["count"] += 1
        return saved(x, weight, stride=stride, padding=padding, bias=bias,
                     amax=amax)

    quant.quant_conv2d = record
    try:
        make_infer_fn(model, dtype=torch.bfloat16, int8=True, device=DEVICE)(
            torch.zeros(1, *INPUT_HW, 3, device=DEVICE))
    finally:
        quant.quant_conv2d = saved
    return list(sites.values())


def int8_site_times(name: str, model, card) -> list[dict]:
    """Each int8 site at BATCH: the int8 conv (quantize, one _int_mm a tap,
    dequantize) against the bf16 cuDNN conv on the same input and weight,
    each by CUDA-graph replay."""
    gen = torch.Generator(DEVICE).manual_seed(14)
    rows = []
    for s in int8_sites(model):
        h, w = s["hw"]
        x = torch.randn(BATCH, h, w, s["cin"], generator=gen,
                        device=DEVICE).to(torch.bfloat16)
        kw = dict(stride=s["stride"], padding=s["padding"], bias=s["bias"])
        with torch.inference_mode():
            q_ms = graph_ms(lambda: quant.quant_conv2d(x, s["weight"], **kw),
                            INT8_GRAPH_ITERS, INT8_GRAPH_REPLAYS)
            f_ms = graph_ms(lambda: conv2d(x, s["weight"], **kw),
                            INT8_GRAPH_ITERS, INT8_GRAPH_REPLAYS)
        co, ci, kh, kwd = s["weight"].shape
        rows.append(dict(x=(BATCH, h, w, ci), weight=(co, ci, kh, kwd),
                         stride=s["stride"], count=s["count"],
                         int8_ms=q_ms, bf16_ms=f_ms))
        log("14 forms", f"{card}: {name} int8 site x {rows[-1]['x']} "
            f"weight {rows[-1]['weight']} stride {s['stride']} "
            f"(x{s['count']} a forward): int8 {q_ms:.3f} ms, bf16 cuDNN "
            f"{f_ms:.3f} ms (graph replay), speed-up {f_ms / q_ms:.2f}")
        del x
    return rows


def forms_int8(name: str, model, expected, frames, ref, card) -> dict:
    """int8 sites' times, then the int8 forward: launches (a kernel site
    the gate quantizes runs the resize and the int8 conv instead of the
    kernel), frames/s, rel_out_err against the float monolithic output."""
    sites = int8_site_times(name, model, card)
    _, up_sites, _ = main_path_sites(model)
    with quantized_convs():
        up_int8 = sum(should_quantize((5, 5, s["c"], s["o"]), 1, (1, 1))
                      for s in up_sites)
    serve = make_infer_fn(model, upsample_to=FRAME_HW, dtype=torch.bfloat16,
                          preprocess=True, device=DEVICE, int8=True)
    out, launches = serve_counted(serve, frames, f"{name} int8",
                                  (expected[0], expected[1] - up_int8))
    rel = float(torch.linalg.vector_norm(out - ref)
                / torch.linalg.vector_norm(ref))
    del out
    if not rel <= INT8_REL_MAX:
        raise RuntimeError(f"{name} int8 rel_out_err {rel} > {INT8_REL_MAX}")
    rate = batch_rate(serve, frames, INT8_WARMUP, INT8_ITERS)
    log("14 forms", f"{card}: {name} int8 serving {BATCH}x{FRAME_HW} bf16: "
        f"{rate['frames_per_s']:.1f} frames/s ({rate['ms_per_batch']:.2f} ms "
        f"a batch, {INT8_ITERS} calls after {INT8_WARMUP}), peak "
        f"{rate['peak_gib']:.2f} GiB")
    log("14 forms", f"{name} int8: {len(sites)} site shapes, "
        f"{sum(s['count'] for s in sites)} convs a forward "
        f"({up_int8} of them kernel sites); launches {launches}; "
        f"rel_out_err {rel:.4g} (<= {INT8_REL_MAX})")
    return dict(sites=sites, launches=launches, rel_out_err=rel, **rate)


def forms_config(name: str, frames, fx_up, card) -> dict:
    """Every form of one configuration at BATCH, then at BIG_BATCHES, the
    serving rule, its int8 form where it is one of INT8_CONFIGS and the
    autotuner where it is one of TUNE_CONFIGS."""
    model, expected = forms_model(name)
    out, ref = {}, None
    for label, spec in form_specs(name, model):
        serve = serving_form_fn(model, spec)
        exp = expected if spec["dw_impl"] == "pallas" else (0, expected[1])
        y, launches = serve_counted(serve, frames, f"{name} {label}", exp)
        row = dict(launches=launches)
        if ref is None:
            ref = y
        else:
            row["max_err"], row["mean_err"] = form_error(
                name, y, ref, f"{label} vs monolithic")
        if fx_up is not None:
            row["fixture_max_abs_m"], row["fixture_mean_abs_m"] = form_error(
                name, y[:4], fx_up, f"{label} vs the JAX fixture")
        del y
        row.update(serving_rate(serve, frames, card, "14 forms",
                                f"{name} {label}", top_ops=False))
        log("14 forms", f"{name} {label}: launches {launches}"
            + (f", vs monolithic max {row['max_err']:.3g} mean "
               f"{row['mean_err']:.3g}" if "max_err" in row else "")
            + (f", vs JAX fixture max {row['fixture_max_abs_m']:.3g} m"
               if fx_up is not None else ""))
        out[label] = row
        del serve
    for batch in BIG_BATCHES if name in BIG_CONFIGS else ():
        out[f"b{batch}"] = forms_big(name, model, expected, frames, batch,
                                     card)
    rule_batches = (BATCH, *BIG_BATCHES, 2 * BIG_BATCHES[-1])
    for batch in rule_batches:
        spec = make_serving_fn(model, batch_hint=batch, dtype=torch.bfloat16,
                               device=DEVICE).spec
        if {k: spec[k] for k in ("path", "tile_batch") if k in spec} != \
                serving_form(batch):
            raise RuntimeError(f"{name}: make_serving_fn at batch {batch} "
                               f"built {spec}")
    out["rule"] = {b: serving_form(b) for b in rule_batches}
    log("14 forms", f"{name}: make_serving_fn's rule serves " + ", ".join(
        f"batch {b} {f}" for b, f in out["rule"].items()))
    if name in INT8_CONFIGS:
        out["int8"] = forms_int8(name, model, expected, frames, ref, card)
    if name in TUNE_CONFIGS:
        out["autotune"] = forms_autotune(name, model, card)
    return out


def forms_big(name: str, model, expected, frames, batch: int, card
              ) -> dict:
    """One configuration at ``batch`` frames (``frames`` repeated): the
    monolithic form in one call and, below the last of BIG_BATCHES, in
    tiles of half the batch (at the first, tiled-staged too): launches,
    frames/s, peak memory, or that the card's memory did not hold it."""
    big = frames.repeat(batch // BATCH, 1, 1, 1)
    specs = [("monolithic", dict(path="monolithic", dw_impl="pallas"))]
    if batch < BIG_BATCHES[-1]:
        specs.append(("tiled", dict(path="tiled", dw_impl="pallas",
                                    tile_batch=batch // 2)))
    if batch == BIG_BATCHES[0] and isinstance(model, HuDepthModel):
        specs.append(("tiled-staged", dict(path="tiled-staged",
                                           dw_impl="pallas",
                                           tile_batch=batch // 2)))
    out = {}
    for label, spec in specs:
        serve = serving_form_fn(model, spec)
        tiles = 2 if label.startswith("tiled") else 1
        try:
            _, launches = serve_counted(serve, big, f"{name} {label} b{batch}",
                                        (tiles * expected[0],
                                         tiles * expected[1]))
            rate = batch_rate(serve, big, 0, BIG_ITERS)
        except torch.OutOfMemoryError:
            del serve
            torch.cuda.empty_cache()
            out[label] = dict(out_of_memory=True)
            log("14 forms", f"{card}: {name} {label} at batch {batch}: out "
                "of device memory")
            continue
        out[label] = dict(launches=launches, **rate)
        log("14 forms", f"{card}: {name} {label} at batch {batch}"
            + (f" (tiles of {batch // 2})" if tiles > 1 else "")
            + f": {rate['frames_per_s']:.1f} frames/s "
            f"({rate['ms_per_batch']:.2f} ms a batch), peak "
            f"{rate['peak_gib']:.2f} GiB, launches {launches}")
        del serve
    del big
    torch.cuda.empty_cache()
    return out


def forms_autotune(name: str, model, card) -> dict:
    """``autotune_serving`` at BATCH in bf16 into a policy of its own, then
    ``make_serving_fn`` from that policy must serve the winner."""
    with tempfile.TemporaryDirectory() as tmp:
        policy = os.path.join(tmp, "serving_policy.json")
        _, entry = autotune_serving(model, BATCH, dtype=torch.bfloat16,
                                    policy_path=policy, verbose=False,
                                    warmup=TUNE_WARMUP, iters=TUNE_ITERS,
                                    device=DEVICE)
        served = make_serving_fn(model, batch_hint=BATCH,
                                 dtype=torch.bfloat16, policy_path=policy,
                                 device=DEVICE)
    won = {k: entry[k] for k in ("path", "dw_impl", "int8")}
    if {k: served.spec.get(k, False) for k in won} != won:
        raise RuntimeError(f"{name}: make_serving_fn served {served.spec}, "
                           f"the policy's winner is {won}")
    log("14 forms", f"{card}: {name} autotune_serving at batch {BATCH} "
        "bf16 (normalized f32 images in, no upsample), frames/s: "
        + ", ".join(f"{r['candidate']} {r['fps']}" for r in entry["measured"])
        + f"; winner {won}, served by make_serving_fn from the policy")
    return dict(winner=won, measured=entry["measured"])


def forms_train_autotune(card) -> dict:
    """``autotune_train`` for ENB0-HU at TRAIN_BATCH in bf16, then the
    training CLI's resolution of ``--train-policy`` must give the
    winner."""
    with tempfile.TemporaryDirectory() as tmp:
        policy = os.path.join(tmp, "train_policy.json")
        entry = autotune_train("efficientnet-b0", "hu2018", TRAIN_BATCH,
                               bf16=True, policy_path=policy, verbose=False,
                               warmup=TRAIN_TUNE_WARMUP,
                               iters=TRAIN_TUNE_ITERS, device=DEVICE)
        args = train_app.parse_args([
            "--encoder", "efficientnet-b0", "--decoder", "hu2018",
            "--per-device-batch", str(TRAIN_BATCH), "--bf16",
            "--train-policy", policy])
        accum, remat, source = train_app.train_policy(args,
                                                      torch.device(DEVICE))
    won = (entry["accum_steps"], entry["remat"])
    if (accum, remat) != won or not source.startswith("policy"):
        raise RuntimeError(f"--train-policy resolved to {accum}, {remat} "
                           f"({source}); the winner is {won}")
    log("14 forms", f"{card}: ENB0-HU autotune_train at batch {TRAIN_BATCH} "
        "bf16, images/s: " + ", ".join(f"{r['candidate']} {r['img_per_s']}"
                                       for r in entry["measured"])
        + f"; winner accum {won[0]} remat {won[1]}, which the training "
        f"CLI's --train-policy resolves to ({source})")
    return dict(winner=dict(accum_steps=won[0], remat=won[1]),
                measured=entry["measured"])


def phase_forms(frames, card) -> dict:
    """14: the serving forms (see FORMS_CONFIGS)."""
    t0 = time.perf_counter()
    fx = np.load(FIXTURE)
    fx_up = resize_bilinear_align_corners(
        torch.from_numpy(fx["depth"]).to(DEVICE)[..., None], FRAME_HW)
    out = {name: forms_config(name, frames, fx_up if name == "ENB0-HU"
                              else None, card)
           for name in FORMS_CONFIGS}
    out["train_autotune"] = forms_train_autotune(card)
    out["seconds"] = time.perf_counter() - t0
    out["card"] = card
    summary = {name: {label: round(r["frames_per_s"], 1)
                      for label, r in out[name].items()
                      if isinstance(r, dict) and "frames_per_s" in r}
               for name in FORMS_CONFIGS}
    log("14 forms", f"{card}: frames/s at batch {BATCH} by form: "
        + json.dumps(summary))
    log("14 forms", f"ok: phase 14 in {out['seconds']:.1f} s")
    return out


# Phase 15: the kernels as registered ops (torch.library.opcheck on the
# card), constant-baked serving (bake_weights) against the unbaked forms
# of the eight configurations, the ahead-of-time serving artifact
# (checkpoints.export), and the cost of the ops' dispatch against another
# tree of the port (``--parent-tree DIR``, dispatch_ab.py) when one is
# given. The artifact is served by a fresh interpreter that imports the
# loader alone (ARTIFACT_CHILD), which must not pull in the port's
# models, apps or checkpoint reader.
BAKE_CONFIGS = FORMS_CONFIGS
# The baked f32 forward against the unbaked one, relative to max|out|: the
# same function in another order of rounding (a CPU run of the eight
# configurations at 64x96 agrees to 1e-5).
FOLD_REL_MAX = 1e-4
# Forwards' worth of ENB0-HU's batch-1 f32 kernel launches a timed loop of
# the dispatch probe (op_dispatch_cost).
DISPATCH_REPS = 50
ARTIFACT_SEED = 15  # randomize_ seed of the tree an arg-weight artifact takes
# Modules an artifact's serving process must not hold: the model code, the
# apps, the .ede reader.
NOT_IN_LOADER = ("efficientdepthestimation_tpu_torch.models",
                 "efficientdepthestimation_tpu_torch.apps",
                 "efficientdepthestimation_tpu_torch.checkpoints.serialization")
ARTIFACT_CHILD = r'''
import json, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
from efficientdepthestimation_tpu_torch.checkpoints.export import (
    load_serving_artifact)
from efficientdepthestimation_tpu_torch.ops.kernels import depthwise, upproj
import_s = time.perf_counter() - t0
path, frames_path, out_path, warmup, iters, banned = sys.argv[1:7]
sync = (torch.cuda.synchronize if torch.cuda.is_available()
        else lambda: None)
t0 = time.perf_counter()
fn, meta = load_serving_artifact(path)
sync()
load_s = time.perf_counter() - t0
frames = torch.from_numpy(np.load(frames_path)).to(meta["device"])
depthwise.depthwise_bn_swish.launches = upproj.upsample_conv.launches = 0
t0 = time.perf_counter()
out = fn(frames)
sync()
first_s = time.perf_counter() - t0
launches = [depthwise.depthwise_bn_swish.launches,
            upproj.upsample_conv.launches]
np.save(out_path, out.cpu().numpy())
del out
for _ in range(int(warmup)):
    fn(frames)
sync()
t0 = time.perf_counter()
for _ in range(int(iters)):
    fn(frames)
sync()
dt = time.perf_counter() - t0
held = sorted(m for m in sys.modules if m.startswith(tuple(
    banned.split(","))))
print(json.dumps(dict(import_s=import_s, load_s=load_s, first_call_s=first_s,
                      launches=launches, frames_per_s=frames.shape[0]
                      * int(iters) / dt, ms_per_batch=1e3 * dt / int(iters),
                      banned_modules=held, meta=meta)))
'''


# opcheck's tests: all four at the first shape of each op and dtype, the
# first three at the others (the fourth, AOT dispatch with dynamic shapes,
# traces and compiles a graph, seconds a shape).
OPCHECK_QUICK = ("test_schema", "test_autograd_registration",
                 "test_faketensor")


def opcheck_ops(card) -> dict:
    """``torch.library.opcheck`` of the four kernels' ops (and the loss op
    that carries the pair's autograd formula) on the card: the depthwise
    and upsample-conv ops at every distinct shape ENB0-HU's serving path
    gives them at BATCH, in bf16 and f32, the upsample-conv op with
    gradients; the loss ops at the training shape."""
    t0 = time.perf_counter()
    model = load_any_checkpoint(CHECKPOINT, device=DEVICE)
    dw_sites, up_sites, _ = main_path_sites(model)
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    counts = dict(depthwise_bn_swish=0, upsample_conv=0)
    seen = set()

    def opcheck(op, args, first: bool) -> None:
        torch.library.opcheck(op, args, **({} if first else dict(
            test_utils=OPCHECK_QUICK)))
    for dtype in (torch.bfloat16, torch.float32):
        for s in dw_sites:
            key = ("dw", s["hw"], s["c"], s["k"], s["stride"], s["pad"],
                   dtype)
            if key in seen:
                continue
            seen.add(key)
            x, taps, scale, bias = (t.detach()
                                    for t in dw_inputs(s, dtype, gen))
            (pt, pb), (pl, pr) = s["pad"]
            opcheck(torch.ops.ede.depthwise_bn_swish, (
                x, taps, scale, bias, [s["stride"]] * 2, [pt, pb, pl, pr]),
                s is dw_sites[0])
            counts["depthwise_bn_swish"] += 1
        for s in up_sites:
            key = ("up", s["hw"], s["c"], s["o"], s["size"], dtype)
            if key in seen:
                continue
            seen.add(key)
            x, k = (t.detach().requires_grad_()
                    for t in up_inputs(s, model, dtype, gen))
            opcheck(torch.ops.ede.upsample_conv, (x, k, list(s["size"])),
                    s is up_sites[0])
            counts["upsample_conv"] += 1
    pred, target = loss_inputs(torch.bfloat16, gen)
    mask = torch.ones(TRAIN_BATCH, device=DEVICE)
    coef = torch.full((1,), 1.0 / pred.numel(), device=DEVICE)
    torch.library.opcheck(torch.ops.ede.fused_depth_loss_fwd, (pred, target))
    torch.library.opcheck(torch.ops.ede.fused_depth_loss_bwd,
                          (pred, target, mask, coef))
    torch.library.opcheck(torch.ops.ede.fused_depth_loss,
                          (pred.requires_grad_(), target, mask, None))
    counts.update(fused_depth_loss_fwd=1, fused_depth_loss_bwd=1,
                  fused_depth_loss=1)
    seconds = time.perf_counter() - t0
    log("15 ops", f"{card}: torch {torch.__version__}; opcheck passed on the "
        f"card for {counts} distinct shapes (all its tests at the first of "
        f"each op and dtype, {', '.join(OPCHECK_QUICK)} at the rest; "
        f"ENB0-HU's serving sites at "
        f"batch {BATCH}, bf16 and f32; the loss at ({TRAIN_BATCH}, "
        f"{LOSS_HW[0]}, {LOSS_HW[1]}) bf16) in {seconds:.1f} s")
    del model
    torch.cuda.empty_cache()
    return dict(shapes=counts, seconds=seconds, torch=torch.__version__)


def busy_idle_elementwise(fn, calls: int = 2) -> dict:
    """From one device-only trace of ``calls`` calls of ``fn``
    (``_trace``): the kernels' busy ms a call, the device's idle share of
    the host window (as ``idle_share``), device records a call, and the
    device ms and launches a call of PyTorch's element-wise kernels
    (those whose name holds ``elementwise``)."""
    prof, spans, window = _trace(fn, calls, [ProfilerActivity.CUDA])
    busy, host = union_us(spans) / calls / 1e3, 1e3 * window / calls
    if not 0 < busy <= host:
        raise RuntimeError(f"kernels busy {busy} ms in a {host} ms window")
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "elementwise" in e.name]
    us = sum(e.time_range.end - e.time_range.start for e in events)
    return dict(busy_ms=busy, idle_share=1 - busy / host, traced_ms=host,
                records=len(spans) / calls, elementwise_ms=us / calls / 1e3,
                elementwise_launches=len(events) / calls)


def fixture_check(name: str, out: torch.Tensor, fixtures: dict) -> dict:
    """The first four outputs against the configuration's JAX fixture,
    upsampled to frame size, within phase 5's (ENB0-HU) or phase 7's
    (ENB0-LR) bf16 limits; {} where there is none."""
    if name not in fixtures:
        return {}
    e_max, e_mean = form_error(name, out[:4], fixtures[name],
                               "baked vs the JAX fixture")
    return dict(fixture_max_abs_m=e_max, fixture_mean_abs_m=e_mean)


def bake_config(name: str, frames, fixtures: dict, card) -> dict:
    """One configuration served unbaked and baked (``make_infer_fn``, bf16,
    uint8 frames in, depth at frame size out) in this process: exact
    launches for both; on the first F32_CHECK_FRAMES frames the baked f32
    forward within FOLD_REL_MAX of the unbaked one (the folds are exact
    up to rounding), each bf16 form within phase 5's bf16 tolerances of
    the unbaked f32 forward (and the baked one of the JAX fixture, where
    there is one); the baked bf16 output within twice those tolerances of
    the unbaked one on all frames (two bf16 forwards, each its own
    rounding away from the f32 one: ENB0-HU's pair reads 0.558 m against
    the 0.5 m limit); then for each frames/s, busy ms and idle share
    (``serving_rate``), element-wise ms and peak memory."""
    t0 = time.perf_counter()
    model, expected = forms_model(name)
    n = F32_CHECK_FRAMES
    f32 = make_infer_fn(model, preprocess=True, upsample_to=FRAME_HW,
                        device=DEVICE)(frames[:n])
    f32_baked = make_infer_fn(model, preprocess=True, upsample_to=FRAME_HW,
                              device=DEVICE, bake_weights=True)(frames[:n])
    fold_rel = max_abs(f32_baked, f32) / f32.abs().max().item()
    if not fold_rel <= FOLD_REL_MAX:
        raise RuntimeError(f"{name} baked vs unbaked f32 forward: max "
                           f"{fold_rel} of max|out|, limit {FOLD_REL_MAX}")
    del f32_baked
    rows, outs = {}, {}
    for label, bake in (("unbaked", False), ("baked", True)):
        serve = make_infer_fn(model, upsample_to=FRAME_HW,
                              dtype=torch.bfloat16, preprocess=True,
                              device=DEVICE, bake_weights=bake)
        y, launches = serve_counted(serve, frames, f"{name} {label}",
                                    expected)
        row = dict(launches=launches)
        row["f32_max_err"], row["f32_mean_err"] = form_error(
            name, y[:n], f32, f"{label} vs its f32 forward")
        outs[label] = y.cpu()  # off the card: the peaks hold the model's own
        del y
        row.update(batch_rate(serve, frames, WARMUP, ITERS))
        with torch.inference_mode():
            row.update(busy_idle_elementwise(lambda: serve(frames)))
        rows[label] = row
        del serve
    base, baked = rows["unbaked"], rows["baked"]
    baked["f32_fold_rel"] = fold_rel
    baked["max_err"], baked["mean_err"] = form_error(
        name, outs["baked"], outs["unbaked"], "baked vs unbaked", 2.0)
    baked.update(fixture_check(name, outs["baked"].to(DEVICE), fixtures))
    baked["speedup"] = baked["frames_per_s"] / base["frames_per_s"]
    log("15 bake", f"{card}: {name} bf16 batch {BATCH}, unbaked -> baked: "
        f"{base['frames_per_s']:.1f} -> {baked['frames_per_s']:.1f} "
        f"frames/s (x{baked['speedup']:.3f}), busy {base['busy_ms']:.2f} -> "
        f"{baked['busy_ms']:.2f} ms, idle share {base['idle_share']:.3f} -> "
        f"{baked['idle_share']:.3f}, element-wise "
        f"{base['elementwise_ms']:.2f} ms ({base['elementwise_launches']:.0f}"
        f" launches) -> {baked['elementwise_ms']:.2f} ms "
        f"({baked['elementwise_launches']:.0f}), peak "
        f"{base['peak_gib']:.2f} -> {baked['peak_gib']:.2f} GiB, launches "
        f"{baked['launches']}; vs the f32 forward on {n} frames, unbaked "
        f"max {base['f32_max_err']:.3g} mean {base['f32_mean_err']:.3g}, "
        f"baked max {baked['f32_max_err']:.3g} mean "
        f"{baked['f32_mean_err']:.3g}; baked vs unbaked f32 max "
        f"{fold_rel:.3g} of max|out|; baked vs unbaked bf16 max "
        f"{baked['max_err']:.3g} mean {baked['mean_err']:.3g}"
        + (f", vs JAX fixture max {baked['fixture_max_abs_m']:.3g} m"
           if "fixture_max_abs_m" in baked else "")
        + f" ({time.perf_counter() - t0:.1f} s)")
    del model, outs, f32
    torch.cuda.empty_cache()
    return rows


def serve_artifact_child(path: str, frames, tmp: str) -> tuple[dict, torch.Tensor]:
    """``ARTIFACT_CHILD`` in a fresh ``python3`` serving ``frames`` from the
    artifact at ``path``: its figures and its first output."""
    frames_path = os.path.join(tmp, "frames.npy")
    out_path = os.path.join(tmp, "artifact_out.npy")
    np.save(frames_path, frames.cpu().numpy())
    done = subprocess.run(
        [sys.executable, "-c", ARTIFACT_CHILD, path, frames_path, out_path,
         str(WARMUP), str(ITERS), ",".join(NOT_IN_LOADER)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"artifact child failed:\n{done.stderr[-4000:]}")
    info = json.loads(done.stdout.strip().splitlines()[-1])
    return info, torch.from_numpy(np.load(out_path)).to(DEVICE)


def phase_artifact(frames, card) -> dict:
    """ENB0-HU from its ``.ede`` exported baked at BATCH in bf16, served by
    a fresh process beside the live baked ``make_serving_fn``; a
    dynamic-batch artifact at batch 1 and BATCH; an arg-weight artifact
    rebound to a second, seeded random tree."""
    model = load_any_checkpoint(CHECKPOINT, device=DEVICE)
    expected = ENB0_HU_LAUNCHES
    kw = dict(encoder="efficientnet-b0", decoder="hu2018",
              dtype=torch.bfloat16, device=DEVICE)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "enb0_hu_b128_bf16.edz")
        t0 = time.perf_counter()
        meta = save_serving_artifact(path, model, batch=BATCH, **kw)
        out["export_s"] = time.perf_counter() - t0
        out["artifact_bytes"] = os.path.getsize(path)
        child, got = serve_artifact_child(path, frames, tmp)
        if child["banned_modules"]:
            raise RuntimeError("the artifact's process imported "
                               f"{child['banned_modules']}")
        if tuple(child["launches"]) != expected:
            raise RuntimeError(f"artifact launches {child['launches']}, "
                               f"expected {expected}")
        live = make_serving_fn(model, batch_hint=BATCH, upsample_to=FRAME_HW,
                               dtype=torch.bfloat16, preprocess=True,
                               device=DEVICE)
        if not live.spec["bake_weights"]:
            raise RuntimeError(f"make_serving_fn at batch {BATCH} served "
                               f"{live.spec}, not baked")
        ref, launches = serve_counted(live, frames, "live baked", expected)
        diff = max_abs(got, ref)
        form_error("ENB0-HU", got, ref, "artifact vs live baked")
        out.update(meta=meta, child=child, live_launches=launches,
                   max_abs_vs_live=diff,
                   live=batch_rate(live, frames, WARMUP, ITERS))
        log("15 artifact", f"{card}: ENB0-HU baked bf16 batch {BATCH}: "
            f"export {out['export_s']:.1f} s, {out['artifact_bytes']} bytes; "
            f"fresh process: imports {child['import_s']:.2f} s, load "
            f"{child['load_s']:.2f} s, first call {child['first_call_s']:.2f}"
            f" s, launches {child['launches']}, "
            f"{child['frames_per_s']:.1f} frames/s "
            f"({child['ms_per_batch']:.2f} ms a batch) beside the live baked "
            f"make_serving_fn's {out['live']['frames_per_s']:.1f} "
            f"({out['live']['ms_per_batch']:.2f} ms); max |artifact - live| "
            f"{diff:.3g} m; no model, app or checkpoint-reader module in "
            "the serving process")
        del got

        path = os.path.join(tmp, "enb0_hu_dynamic_bf16.edz")
        save_serving_artifact(path, model, batch=None, **kw)
        fn, _ = load_serving_artifact(path)
        dyn = {}
        for b in (1, BATCH):
            y, launches = serve_counted(fn, frames[:b], f"dynamic b{b}",
                                        expected)
            want = live(frames[:b])
            dyn[b] = dict(launches=launches, max_abs_vs_live=max_abs(y, want))
            form_error("ENB0-HU", y, want, f"dynamic artifact b{b}")
        out["dynamic"] = dyn
        log("15 artifact", f"dynamic-batch artifact against the live baked "
            "fn on the same frames: "
            + ", ".join(f"batch {b} launches {r['launches']} max |artifact "
                        f"- live| {r['max_abs_vs_live']:.3g} m"
                        for b, r in dyn.items()))
        del fn, ref

        path = os.path.join(tmp, "enb0_hu_argw_bf16.edz")
        save_serving_artifact(path, model, batch=BATCH, bake_weights=False,
                              **kw)
        twin = randomize_(build_model("efficientnet-b0", "hu2018"),
                          ARTIFACT_SEED)
        fn, _ = load_serving_artifact(
            path, weights=to_jax_variables(twin.state_dict()))
        y, launches = serve_counted(fn, frames, "arg-weight artifact",
                                    expected)
        want = make_infer_fn(twin, upsample_to=FRAME_HW,
                             dtype=torch.bfloat16, preprocess=True,
                             device=DEVICE)(frames)
        own = make_infer_fn(model, upsample_to=FRAME_HW,
                            dtype=torch.bfloat16, preprocess=True,
                            device=DEVICE)(frames)
        out["arg_weights"] = dict(
            launches=launches, max_abs_vs_live=max_abs(y, want),
            max_abs_own_vs_twin=max_abs(own, want))
        form_error("random ENB0-HU", y, want, "rebound artifact vs live")
        if not out["arg_weights"]["max_abs_own_vs_twin"] > 1e-3:
            raise RuntimeError("the artifact's own weights serve the twin's "
                               "depth: the rebinding is not checked")
        log("15 artifact", f"arg-weight artifact rebound to a randomize_ "
            f"seed-{ARTIFACT_SEED} ENB0-HU tree: launches {launches}, max "
            f"|artifact - live| {out['arg_weights']['max_abs_vs_live']:.3g}; "
            f"the artifact's own tree, served live, differs from the twin by "
            f"{out['arg_weights']['max_abs_own_vs_twin']:.3g}")
        del fn, y, want, own, twin
    del model
    torch.cuda.empty_cache()
    return out


def op_dispatch_cost(card) -> dict:
    """The host cost of calling the kernels through their registered ops,
    in this tree alone: ENB0-HU's kernel sites of a batch-1 f32 forward
    (16 depthwise, 2 upsample-conv), each launched through its public
    wrapper, as the model calls it (the op's dispatch, then the CUDA
    implementation), and through the CUDA implementation called as a
    plain function (the route of the ctypes wrappers before the ops);
    op, plain, plain, op, each loop DISPATCH_REPS forwards' worth of
    launches under ``inference_mode``, timed on the host clock up to the
    last launch's return (issue time) and to the synchronize after it."""
    model = load_any_checkpoint(CHECKPOINT, device=DEVICE)
    dw_sites, up_sites, _ = main_path_sites(model, dtype=torch.float32)
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    via_op, plain = [], []
    for s in dw_sites:
        x, taps, scale, bias = dw_inputs(s, torch.float32, gen, batch=1)
        (pt, pb), (pl, pr) = s["pad"]
        via_op.append(functools.partial(
            depthwise_bn_swish, x, taps, scale, bias, s["stride"], s["pad"]))
        plain.append(functools.partial(
            depthwise._depthwise_cuda, x, taps, scale, bias,
            [s["stride"]] * 2, [pt, pb, pl, pr]))
    for s in up_sites:
        x, k = up_inputs(s, model, torch.float32, gen, batch=1)
        via_op.append(functools.partial(upsample_conv, x, k, s["size"]))
        plain.append(functools.partial(upproj._upsample_conv_cuda, x, k,
                                       list(s["size"])))

    def loop(calls) -> tuple[float, float]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DISPATCH_REPS):
            for call in calls:
                call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (1e3 * (t1 - t0) / DISPATCH_REPS,
                1e3 * (t2 - t0) / DISPATCH_REPS)

    runs = {"op": [], "plain": []}
    with torch.inference_mode():
        loop(via_op), loop(plain)  # warm: shapes' launch configurations
        for label in ("op", "plain", "plain", "op"):
            runs[label].append(loop(via_op if label == "op" else plain))
    issue = {k: float(np.mean([r[0] for r in v])) for k, v in runs.items()}
    wall = {k: float(np.mean([r[1] for r in v])) for k, v in runs.items()}
    n = len(via_op)
    del model
    torch.cuda.empty_cache()
    return dict(launches=n, reps=DISPATCH_REPS, runs=runs,
                issue_ms=issue, wall_ms=wall,
                ms_per_forward=issue["op"] - issue["plain"],
                us_per_call=1e3 * (issue["op"] - issue["plain"]) / n)


def phase_dispatch(card, parent: str | None) -> dict:
    """The ops' own dispatch cost (``op_dispatch_cost``) and the host-paced
    paths it could slow (``dispatch_ab``): this tree in this process, and
    with ``parent``, parent, this, this, parent, each in a process of its
    own."""
    cost = op_dispatch_cost(card)
    probe = dispatch_ab.probe(ROOT)
    cost["share_of_b1_latency"] = cost["ms_per_forward"] / probe["b1_f32_ms"]
    log("15 dispatch", f"{card}: the ops' dispatch on ENB0-HU's "
        f"{cost['launches']} batch-1 f32 launches: issue "
        f"{cost['issue_ms']['op']:.3f} ms a forward through the ops, "
        f"{cost['issue_ms']['plain']:.3f} ms calling their CUDA "
        f"implementations (to the synchronize "
        f"{cost['wall_ms']['op']:.3f}, {cost['wall_ms']['plain']:.3f} ms): "
        f"{cost['us_per_call']:.1f} us a launch, "
        f"{100 * cost['share_of_b1_latency']:.1f}% of the batch-1 f32 "
        f"latency; ENB0-HU batch-1 f32 latency {probe['b1_f32_ms']:.2f} ms "
        f"(median), batch-{BATCH} bf16 {probe['b128_bf16_fps']:.1f} "
        f"frames/s, bf16 training step {probe['train_bf16_img_s']:.1f} "
        "images/s")
    if parent is None:
        log("15 dispatch", "no --parent-tree given: no comparison with "
            "another tree")
        return dict(this=probe, op_cost=cost)
    result = dispatch_ab.run_ab(parent)
    for run in result["runs"]:
        log("15 dispatch", f"{result['card']}: {run['tree']}: batch-1 f32 "
            f"{run['b1_f32_ms']:.2f} ms, batch-{BATCH} bf16 "
            f"{run['b128_bf16_fps']:.1f} frames/s, training "
            f"{run['train_bf16_img_s']:.1f} images/s")
    result.update(this=probe, op_cost=cost)
    return result


def phase_ops_bake_artifact(frames, card, parent: str | None) -> dict:
    """15: the ops, baking, the artifact and the ops' dispatch cost."""
    t0 = time.perf_counter()
    out = {"ops": opcheck_ops(card)}
    t1 = time.perf_counter()
    fixtures = {}
    for name, path in (("ENB0-HU", FIXTURE), ("ENB0-LR", LR_FIXTURE)):
        fixtures[name] = resize_bilinear_align_corners(
            torch.from_numpy(np.load(path)["depth"]).to(DEVICE)[..., None],
            FRAME_HW)
    out["bake"] = {name: bake_config(name, frames, fixtures, card)
                   for name in BAKE_CONFIGS}
    t2 = time.perf_counter()
    out["artifact"] = phase_artifact(frames, card)
    t3 = time.perf_counter()
    out["dispatch"] = phase_dispatch(card, parent)
    t4 = time.perf_counter()
    out["seconds"] = t4 - t0
    out["part_seconds"] = dict(ops=t1 - t0, bake=t2 - t1, artifact=t3 - t2,
                               dispatch=t4 - t3)
    out["card"] = card
    log("15 ops/bake/artifact", f"{card}: baked/unbaked frames/s at batch "
        f"{BATCH}: " + json.dumps({n: round(r["baked"]["speedup"], 3)
                                   for n, r in out["bake"].items()}))
    log("15 ops/bake/artifact", f"ok: phase 15 in {out['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in out["part_seconds"].items())
        + ")")
    return out


# ---------------------------------------------------------------- phase 16

# Phase 16: spatial serving (apps.common.make_serving_fn(mesh=...,
# spatial=True), parallel.spatial) by SPATIAL_WORLD processes sharing the
# card over gloo, as phase 13's two ranks do: ENB0-HU and ENB0-LR from
# their .ede at full width on the fixture's frames, preprocessed and
# upsampled back to 480×640, at each of SPATIAL_BATCHES in f32 and bf16.
# Each rank launches each kernel as one card does (its rows of every
# level), its band gathered (parallel.gather_rows) is held against the
# one-rank fn's output: f32 within SPATIAL_F32_ATOL metres (the bands'
# convolutions are other shapes, whose cuDNN algorithms sum in other
# orders), bf16 within phase 5's bf16 limits. On one card the ranks share
# its SMs and exchange halos through the host, so spatial serving is
# expected to cost here: their batch-1 latency is printed beside one rank's.
SPATIAL_WORLD = 2
SPATIAL_CONFIGS = {
    "ENB0-HU": (CHECKPOINT, {torch.float32: ENB0_HU_F32_LAUNCHES,
                             torch.bfloat16: ENB0_HU_LAUNCHES}),
    "ENB0-LR": (LR_CHECKPOINT, {torch.float32: (16, 0),
                                torch.bfloat16: (16, 0)}),
}
SPATIAL_BATCHES = (1, 4)
SPATIAL_F32_ATOL = 1e-4
SPATIAL_LATENCY_CALLS = 10
SPATIAL_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def latency_ms(serve, frames, calls: int = SPATIAL_LATENCY_CALLS
               ) -> dict:
    """Median and least ms of ``calls`` calls, each to its synchronize,
    after one warm call."""
    serve(frames)
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve(frames)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return dict(median_ms=float(np.median(times)), min_ms=min(times))


def spatial_rank(argv: list[str]) -> None:
    """One of SPATIAL_WORLD processes of phase 16: each configuration,
    dtype and batch served row-sharded, launches counted from 0 around the
    call; rank 0 writes the gathered outputs, every rank its launches and
    batch-1 latency, to the directory ``argv[1]``."""
    rank, tmp = int(argv[0]), argv[1]
    if not maybe_initialize_distributed(device=DEVICE, backend="gloo"):
        raise RuntimeError("no process group from the environment")
    mesh = create_mesh(device=f"{DEVICE}:0", backend="gloo")
    frames = torch.from_numpy(fixture_frames()).to(DEVICE)
    outputs, figures = {}, {}
    for name, (path, expected) in SPATIAL_CONFIGS.items():
        model = load_any_checkpoint(path, device=DEVICE)
        for label, dtype in SPATIAL_DTYPES.items():
            serve = make_serving_fn(model, mesh=mesh, spatial=True,
                                    upsample_to=FRAME_HW, dtype=dtype,
                                    preprocess=True)
            for batch in SPATIAL_BATCHES:
                band, launches = counted(
                    lambda: serve(frames[:batch]), expected[dtype],
                    f"{name} {label} spatial serving, rank {rank}")
                rows = spatial_sharding(mesh).rows(FRAME_HW[0])
                if tuple(band.shape) != (batch, rows.stop - rows.start,
                                         FRAME_HW[1], 1):
                    raise RuntimeError(f"rank {rank}'s band "
                                       f"{tuple(band.shape)}")
                whole = gather_rows(band, FRAME_HW[0], mesh)
                if rank == 0:
                    outputs[f"{name}/{label}/{batch}"] = whole.cpu()
                figures[f"{name}/{label}/{batch}"] = dict(
                    launches=list(launches.values()))
            dist.barrier()
            figures[f"{name}/{label}/latency"] = latency_ms(
                serve, frames[:1])
            dist.barrier()
            figures[f"{name}/{label}/collectives"] = collective_ms(
                lambda: serve(frames[:1]), lambda n: "spatial")
        del model
    if rank == 0:
        torch.save(outputs, os.path.join(tmp, "outputs.pt"))
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(figures, f)
    dist.destroy_process_group()


def window_bound(x_rows: int, rows: int, s: dict, batch: int,
                 itemsize: int) -> float:
    """``up_bound`` of a window: its source rows read once, its output
    rows written once, the conv's operations at its rows."""
    ws, c, o = s["hw"][1], s["c"], s["o"]
    w = s["size"][1]
    nbytes = (batch * x_rows * ws * c + 25 * c * o + batch * rows * w * o
              ) * itemsize
    ops = 2 * batch * rows * w * 25 * c * o
    rate = BF16_OPS_PER_S if itemsize == 2 else F32_OPS_PER_S
    return max(1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / rate)


def fenced(t: torch.Tensor, rows: int = 2) -> torch.Tensor:
    """A contiguous copy of NHWC ``t`` between ``rows`` rows of NaN on
    either side in memory: a kernel that reads a row outside the slice it
    is given, even at a weight of 0, returns NaN."""
    pad = rows * t.shape[2] * t.shape[3]
    flat = torch.full((t.numel() + 2 * pad,), float("nan"), dtype=t.dtype,
                      device=t.device)
    return flat[pad:pad + t.numel()].view(t.shape).copy_(t)


def window_checks(card) -> dict:
    """The upsample-conv kernel's row window at every band of ENB0-HU's
    kernel sites (D.up2-4, MFF.up1-2) that SPATIAL_WORLD ranks own, batch
    SPATIAL_BATCHES[-1], bf16 and f32, its source rows between rows of NaN
    in memory (``fenced``; D's steps of 0.5 put the last upsampled row of a
    band on a source row, whose zero-weight neighbour the kernel loads):
    against its plain version (phase 5's tolerances) and against the
    whole-image kernel's rows; ``opcheck`` of the window op at each band;
    each rank's windows timed (CUDA events over eager calls, summed over
    the sites) beside their bound, their plain version's time and the
    whole-image kernel's."""
    model = load_any_checkpoint(CHECKPOINT, device=DEVICE)
    _, up_sites, _ = main_path_sites(model)
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    batch = SPATIAL_BATCHES[-1]
    out = {}
    for label, dtype in SPATIAL_DTYPES.items():
        tol = TOL[("upsample_conv", dtype)]["y"]
        res = out[label] = dict(plain_err=0.0, whole_err=0.0, whole_ms=0.0,
                                ranks=[dict(ms=0.0, plain_ms=0.0,
                                            bound_ms=0.0)
                                       for _ in range(SPATIAL_WORLD)])
        for s in up_sites:
            x, k = (t.detach() for t in up_inputs(s, model, dtype, gen,
                                                  batch=batch))
            whole = upsample_conv(x, k, s["size"])
            res["whole_ms"] += cuda_ms(lambda: upsample_conv(x, k,
                                                             s["size"]))
            hs, h = s["hw"][0], s["size"][0]
            for r in range(SPATIAL_WORLD):
                start, stop = owned_rows(h, SPATIAL_WORLD, r)
                lo, hi = upsample_conv_rows(start, stop, hs, h)
                args = (fenced(x[:, lo:hi]), k, s["size"],
                        (lo, hs, start, stop - start))
                y = upsample_conv_window(*args)
                e = check_close(f"{label} window {s['name']} rank {r}", y,
                                upsample_conv_window_plain(*args), tol)
                res["plain_err"] = max(res["plain_err"], e)
                e = check_close(f"{label} window {s['name']} rank {r} vs "
                                "the whole image", y, whole[:, start:stop],
                                tol)
                res["whole_err"] = max(res["whole_err"], e)
                torch.library.opcheck(
                    torch.ops.ede.upsample_conv_window,
                    (args[0], k, list(s["size"]), list(args[3])),
                    **({} if r == 0 else dict(test_utils=OPCHECK_QUICK)))
                t = res["ranks"][r]
                t["ms"] += cuda_ms(lambda: upsample_conv_window(*args))
                t["plain_ms"] += cuda_ms(
                    lambda: upsample_conv_window_plain(*args))
                t["bound_ms"] += window_bound(hi - lo, stop - start, s,
                                              batch, x.element_size())
        log("16 spatial", f"{card}: {label} upsample-conv window at the "
            f"{len(up_sites)} kernel sites' bands of {SPATIAL_WORLD} ranks, "
            f"batch {batch}, NaN around each slice: max abs "
            f"{res['plain_err']:.3g} from its plain "
            f"version, {res['whole_err']:.3g} from the whole-image kernel's "
            f"rows (phase 5's tolerances), opcheck passed; ms a rank "
            f"(summed over the sites; bound, plain): " + ", ".join(
                f"{t['ms']:.3f} ({t['bound_ms']:.3f}, {t['plain_ms']:.3f})"
                for t in res["ranks"])
            + f"; the whole image {res['whole_ms']:.3f}")
    del model
    return out


def phase_spatial(card) -> dict:
    """16: spatial serving (see SPATIAL_CONFIGS)."""
    t0 = time.perf_counter()
    window = window_checks(card)
    with tempfile.TemporaryDirectory() as tmp:
        launch_ranks(tmp, "--spatial-rank")
        got = torch.load(os.path.join(tmp, "outputs.pt"))
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                 for r in range(SPATIAL_WORLD)]
    frames = torch.from_numpy(fixture_frames()).to(DEVICE)
    out = dict(card=card, window=window, configs={})
    for name, (path, expected) in SPATIAL_CONFIGS.items():
        model = load_any_checkpoint(path, device=DEVICE)
        for label, dtype in SPATIAL_DTYPES.items():
            serve = make_serving_fn(model, upsample_to=FRAME_HW, dtype=dtype,
                                    preprocess=True, device=DEVICE)
            for batch in SPATIAL_BATCHES:
                key = f"{name}/{label}/{batch}"
                ref = serve(frames[:batch])
                err = (got[key].to(DEVICE) - ref).abs()
                e_max, e_mean = err.max().item(), err.mean().item()
                if not bool(torch.isfinite(got[key]).all()) or (
                        e_max > SPATIAL_F32_ATOL if dtype == torch.float32
                        else e_max > BF16_MODEL_MAX_ABS
                        or e_mean > BF16_MODEL_MEAN_ABS):
                    raise RuntimeError(f"{key} spatial vs one rank: max "
                                       f"{e_max} mean {e_mean} m")
                for r in ranks:
                    if tuple(r[key]["launches"]) != tuple(expected[dtype]):
                        raise RuntimeError(f"{key}: a rank launched "
                                           f"{r[key]['launches']}")
                out["configs"][key] = dict(max_abs=e_max, mean_abs=e_mean,
                                           launches=ranks[0][key]["launches"])
            one = latency_ms(serve, frames[:1])
            ranks_ms = [r[f"{name}/{label}/latency"] for r in ranks]
            spent = [r[f"{name}/{label}/collectives"] for r in ranks]
            out["configs"][f"{name}/{label}/latency"] = dict(
                one_rank=one, ranks=ranks_ms, collectives=spent)
            limit = (SPATIAL_F32_ATOL if dtype == torch.float32
                     else BF16_MODEL_MAX_ABS)
            log("16 spatial", f"{card}: {name} {label}, {SPATIAL_WORLD} "
                f"ranks over gloo on one card against one rank: batches "
                f"{SPATIAL_BATCHES} max abs " + ", ".join(
                    f"{out['configs'][f'{name}/{label}/{b}']['max_abs']:.3g}"
                    for b in SPATIAL_BATCHES)
                + f" m (<= {limit}), launches a rank {expected[dtype]}; "
                f"batch-1 latency ms (median/least) one rank "
                f"{one['median_ms']:.2f}/{one['min_ms']:.2f}, ranks "
                + ", ".join(f"{m['median_ms']:.2f}/{m['min_ms']:.2f}"
                            for m in ranks_ms)
                + "; all-reduces of a batch-1 call, ms of the call's ms: "
                + ", ".join(f"{c['spatial']['calls']}, "
                            f"{c['spatial']['ms']:.1f} of "
                            f"{c['step_ms']:.1f}" for c in spent))
        del model
    out["seconds"] = time.perf_counter() - t0
    log("16 spatial", f"ok: phase 16 in {out['seconds']:.1f} s")
    return out



# Phase 17: the end-to-end rehearsal (scripts/run_e2e_torch.py) in a
# subprocess, at a reduced size: 64 + 16 pairs, SIGTERM once 1 epoch is
# logged, a 1-epoch fine-tune, 4 benchmark samples. 3 epochs, not 2: with 8
# steps an epoch, a SIGTERM sent a second after the first epoch's log line
# can land after the second epoch's last step, and the run then ends
# unpreempted; the third epoch keeps a step boundary ahead of it. Batch 1
# against batch 4 of apps.evaluate: the sums' order only, 1e-3 relative on
# every metric but LOG10, which the reference divides by the batch count
# (e2e/E2E.md). Then, with the counts set to 0, one f32 training step on
# the rehearsal's data (its CLI's dtype: the loss pair and the f32 route's
# upsample-conv sites) and one f32 eval batch of its test split, from its
# staged HU checkpoint.
E2E_ARGS = ["--n-train", "64", "--n-test", "16", "--epochs", "3",
            "--preempt-after-epochs", "1", "--freeze-epochs", "1",
            "--bench-samples", "4", "--poll-seconds", "1"]
E2E_EVAL_RTOL = 1e-3
E2E_ENTRANTS = ("random", "reside_enb0_hu_trained", "midas_enb0_lr_trained",
                "reside_enb0_random", "flat")
E2E_BATCH = 8
E2E_STEP_LAUNCHES = (0, ENB0_HU_F32_LAUNCHES[1], 1, 1)


def e2e_checks(work: str) -> dict:
    """The rehearsal's outcomes, read from its work directory."""
    meta = json.load(open(os.path.join(work, "train_meta.json")))
    out = {}
    for tag in ("hu", "lr"):
        text = open(os.path.join(work, f"train_{tag}_a.log")).read()
        preempted = re.findall(r"Preempted at epoch \d+", text)
        run_b = os.path.join(work, "runs", meta["run_dirs"][tag][1])
        best = [p for p in os.listdir(run_b)
                if p.endswith(".ede") and p != "train_state.ede"]
        if not preempted or not best:
            raise RuntimeError(f"rehearsal {tag}: preempted {preempted}, "
                               f"resumed run's checkpoints {best}")
        out[tag] = dict(preempted=preempted[0], epochs=len(
            meta["trajectories"][tag]))
    for name in ("ENB0-HU", "ENB0-LR"):
        load_any_checkpoint(os.path.join(work, "checkpoints", f"{name}.ede"),
                            device=DEVICE)
    evals = {}
    for bs in (1, 4):
        line = next(ln for ln in open(os.path.join(work, f"evaluate_b{bs}.log"))
                    if ln.startswith("EVALUATE "))
        evals[bs] = json.loads(line.removeprefix("EVALUATE "))
    rel = {k: abs(evals[1][k] - evals[4][k]) / max(abs(evals[1][k]), 1e-12)
           for k in evals[1]}
    bad = {k: v for k, v in rel.items() if k != "log10" and v > E2E_EVAL_RTOL}
    if bad:
        raise RuntimeError(f"rehearsal evaluate, batch 1 against 4: {bad}")
    rows = list(csv.reader(open(os.path.join(work, "benchmark_out",
                                             "nyu.csv"))))
    header, table = rows[0], {r[0]: r for r in rows[1:]}
    if sorted(table) != sorted(E2E_ENTRANTS):
        raise RuntimeError(f"rehearsal benchmark entrants {sorted(table)}")
    for name, row in table.items():
        for key in ("mae", "abs_rel", "rmse", "ssim", "lpips"):
            if not math.isfinite(float(row[header.index(key)])):
                raise RuntimeError(f"rehearsal benchmark {name} {key}")
    study = os.path.join(work, "study_material")
    n_study = sum(len(f) for _, _, f in os.walk(study))
    if not os.path.isfile(os.path.join(study, "video_urls.csv")):
        raise RuntimeError("rehearsal study materials not written")
    out.update(evaluate_rel=rel, study_files=n_study, abs_rel={
        name: float(table[name][header.index("abs_rel")])
        for name in E2E_ENTRANTS})
    return out


def e2e_launches(work: str, data: str) -> dict:
    """The launches of one f32 training step on the rehearsal's training
    data and of one eval batch of its test split, from its staged HU
    checkpoint, each counted from 0."""
    from PIL import Image

    path = os.path.join(work, "checkpoints", "ENB0-HU.ede")
    model = load_any_checkpoint(path, device=DEVICE)
    state = create_train_state(model, LR, WEIGHT_DECAY)
    step = make_train_step(mixed_precision=False, device=DEVICE)
    train = DepthPairDataset(os.path.join(data, "train.csv"), is_test=False)
    batch = next(iter(train_app._epoch_batches(train, E2E_BATCH, DEVICE,
                                               shuffle=True, seed=0)))
    torch.cuda.synchronize()
    for c in KERNEL_COUNTERS.values():
        c.launches = 0
    state, metrics = step(state, batch, 0)
    step_launches = launches_since(dict.fromkeys(KERNEL_COUNTERS, 0))
    if step_launches != E2E_STEP_LAUNCHES or not math.isfinite(
            float(metrics["loss"])):
        raise RuntimeError(f"rehearsal f32 training step: launches "
                           f"{step_launches}, expected {E2E_STEP_LAUNCHES}; "
                           f"loss {float(metrics['loss'])}")
    with open(os.path.join(data, "test.csv")) as f:
        rows = list(csv.reader(f))[:E2E_BATCH]
    pairs = [(np.asarray(Image.open(img).convert("RGB")),
              np.asarray(Image.open(dep))) for img, dep in rows]
    model = load_any_checkpoint(path, device=DEVICE)
    _, eval_launches, _ = eval_counted(model, pairs, E2E_BATCH,
                                       ENB0_HU_F32_LAUNCHES)
    del model, state, step
    return dict(step=step_launches,
                eval=tuple(eval_launches.values()))


def phase_e2e(card) -> dict:
    """17: the rehearsal (see E2E_ARGS)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("out", "work", "data")}
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "scripts",
                                          "run_e2e_torch.py"), *E2E_ARGS,
             "--out", dirs["out"], "--work-dir", dirs["work"],
             "--data-dir", dirs["data"]],
            cwd=tmp, capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stdout[-6000:], proc.stderr[-6000:], file=sys.stderr)
            raise RuntimeError(f"scripts/run_e2e_torch.py exited "
                               f"{proc.returncode}")
        out = dict(card=card, checks=e2e_checks(dirs["work"]),
                   launches=e2e_launches(dirs["work"], dirs["data"]))
        out["timings"] = json.load(open(os.path.join(dirs["out"],
                                                     "timings_torch.json")))
    out["seconds"] = time.perf_counter() - t0
    checks, launches = out["checks"], out["launches"]
    log("17 e2e", f"{card}: scripts/run_e2e_torch.py {' '.join(E2E_ARGS)}: "
        f"{checks['hu']['preempted']} (HU), {checks['lr']['preempted']} "
        f"(LR), resumed; staged HU and LR load; evaluate batch 1 against 4 "
        f"worst relative (but LOG10) "
        f"{max(v for k, v in checks['evaluate_rel'].items() if k != 'log10'):.2e}"
        f" (<= {E2E_EVAL_RTOL}); benchmark abs_rel " + ", ".join(
            f"{k} {v:.4f}" for k, v in checks["abs_rel"].items())
        + f"; {checks['study_files']} study files; from the staged HU "
        f"checkpoint, launches (depthwise, upsample-conv, loss forward, loss "
        f"backward) of one f32 step {launches['step']}, of one eval batch "
        f"of {E2E_BATCH} {launches['eval']}")
    log("17 e2e", "wall s a phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["timings"].items() if k != "card"))
    log("17 e2e", f"ok: phase 17 in {out['seconds']:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    for flag, rank_main in (("--parallel-rank", parallel_rank),
                            ("--spatial-rank", spatial_rank)):
        if flag in sys.argv:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            rank_main(sys.argv[sys.argv.index(flag) + 1:])
            return 0
    # The training CLI's run logger takes wandb when it imports: local
    # files only.
    os.environ["WANDB_MODE"] = "disabled"
    # f32 comparisons mean f32: no TF32 in cuDNN convs or matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t_phase = time.perf_counter()
    seconds = {}

    def done(phase: str) -> None:
        """The wall seconds since the previous phase ended."""
        nonlocal t_phase
        now = time.perf_counter()
        seconds[phase] = round(now - t_phase, 1)
        t_phase = now

    phase_build()
    native_info = phase_native_build()
    card = phase_card()
    done("1-2 build, card")
    model = load_any_checkpoint(CHECKPOINT, device=DEVICE)
    dw_sites, up_sites, _ = main_path_sites(model)
    if (len(dw_sites), len(up_sites)) != ENB0_HU_LAUNCHES:
        raise RuntimeError(f"found {len(dw_sites)} depthwise and "
                           f"{len(up_sites)} direct upsample-conv sites")
    errs = phase_kernels(model, dw_sites, up_sites)[torch.bfloat16]
    other_errs, routes = phase_other_sites(model, card)
    for key, e in other_errs.items():
        errs[key] = max(errs[key], e)
    errs.update(phase_loss_kernels())
    done("3 kernels, routes")
    serve, frames, launches = phase_serve(model)
    res, rate = phase_time(model, serve, frames, card, dw_sites, up_sites)
    done("4-5 serve, time")
    configs = [dict(name="ENB0-HU", launches=dict(launches), **rate)]
    del serve, model
    phase_train_fixture()
    state, step, batch, train_launches = phase_train_steps()
    res.update(phase_train_time(card, state, step, batch))
    launches.update({k: train_launches[k] for k in ("fused_depth_loss",
                                                    "fused_depth_loss_bwd")})
    del state, step, batch
    done("6 train")
    configs.append(phase_lr(frames, card))
    for name in RANDOM_CONFIGS:
        configs.append(phase_random(name, frames, card))
    for c in configs:
        c["card"] = card
    done("7-8 configs")
    evaluation = phase_eval(card)
    done("9 eval")
    apps = phase_pth_apps(frames, card)
    done("10 apps")
    training = phase_train_cli(frames, card)
    done("11 train CLI")
    benchmark = phase_benchmark(card)
    done("12 benchmark")
    parallel = phase_parallel(frames, card)
    done("13 parallel")
    forms = phase_forms(frames, card)
    done("14 forms")
    parent = (sys.argv[sys.argv.index("--parent-tree") + 1]
              if "--parent-tree" in sys.argv else None)
    ops_bake = phase_ops_bake_artifact(frames, card, parent)
    done("15 ops, bake, artifact")
    spatial_figures = phase_spatial(card)
    done("16 spatial")
    e2e = phase_e2e(card)
    done("17 e2e")
    log("seconds", f"{card}: wall s a phase " + json.dumps(seconds)
        + f", {sum(seconds.values()):.1f} in all")

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
    print(json.dumps({"phase_seconds": seconds}))
    print(json.dumps({"e2e": e2e}))
    print(json.dumps({"spatial": spatial_figures}))
    print(json.dumps({"ops_bake_artifact": ops_bake}))
    print(json.dumps({"forms": forms}))
    print(json.dumps({"native": native_info}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"routes": routes}))
    print(json.dumps({"eval": evaluation}))
    print(json.dumps({"apps": apps}))
    print(json.dumps({"train": training}))
    print(json.dumps({"benchmark": finite_or_none(benchmark)}))
    print(json.dumps({"configs": configs}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
