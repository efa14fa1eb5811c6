#!/usr/bin/env python3
"""Time the host-paced serving and training paths of one checkout of the
port on one card: the cost of calling the kernels through registered ops,
when two checkouts are compared.

    python3 -P dispatch_ab.py --tree TREE

times the ``efficientdepthestimation_tpu_torch`` package under TREE (e.g. a
``git archive`` of the parent commit) and prints one JSON line;
``run_ab(OTHER_TREE)`` (``chip_smoke.py --parent-tree OTHER_TREE``) runs
OTHER_TREE, this tree, this tree again and OTHER_TREE again, each in a
process of its own. Each process imports the named tree's package alone,
and only functions both trees have, and times ENB0-HU from
``e2e/ENB0-HU-synthetic.ede``, unbaked:

- ``b1_f32_ms``: one 480×640 uint8 frame served in f32 (``make_serving_fn``
  with no batch hint), the median of LATENCY_CALLS calls each timed to its
  synchronize after WARMUP;
- ``b128_bf16_fps``: frames/s of ``make_infer_fn`` in bf16 on 128 frames,
  ITERS calls after WARMUP, host clock;
- ``train_bf16_img_s``: images/s of the bf16 training step at batch 64
  (``make_train_step(mixed_precision=True)``) on random frames and depths,
  ITERS steps after WARMUP.

It needs a CUDA card; ``-P`` keeps this file's directory off ``sys.path``,
so that only the named tree's package is imported.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(HERE, "e2e", "ENB0-HU-synthetic.ede")
FRAME_HW = (480, 640)
WARMUP, ITERS, LATENCY_CALLS = 3, 10, 20
BATCH, TRAIN_BATCH = 128, 64


def probe(tree: str) -> dict:
    """The three figures of the package under ``tree``."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from efficientdepthestimation_tpu_torch.apps.common import (
        load_any_checkpoint,
        make_infer_fn,
        make_serving_fn,
    )
    from efficientdepthestimation_tpu_torch.training.train_step import (
        create_train_state,
        make_train_step,
    )

    if not torch.cuda.is_available():
        raise SystemExit("dispatch_ab: no CUDA device is available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(
        0, 256, (BATCH, *FRAME_HW, 3), dtype=np.uint8)).cuda()
    model = load_any_checkpoint(CHECKPOINT, device="cuda")
    out = {"tree": tree, "package": os.path.dirname(
        sys.modules["efficientdepthestimation_tpu_torch"].__file__)}

    serve = make_serving_fn(model, upsample_to=FRAME_HW, preprocess=True,
                            device="cuda")
    frame = frames[:1]
    for _ in range(WARMUP):
        serve(frame)
    torch.cuda.synchronize()
    times = []
    for _ in range(LATENCY_CALLS):
        t0 = time.perf_counter()
        serve(frame)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    out["b1_f32_ms"] = float(np.median(times))

    def rate(fn, n: int) -> float:
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
        return n * ITERS / (time.perf_counter() - t0)

    serve = make_infer_fn(model, upsample_to=FRAME_HW, dtype=torch.bfloat16,
                          preprocess=True, device="cuda")
    out["b128_bf16_fps"] = rate(lambda: serve(frames), BATCH)
    del serve

    batch = {"image": frames[:TRAIN_BATCH],
             "depth": torch.from_numpy(rng.integers(
                 10, 250, (TRAIN_BATCH, *FRAME_HW), dtype=np.uint8)).cuda(),
             "num_valid": TRAIN_BATCH}
    state = create_train_state(model, 1e-4, 1e-4)
    step = make_train_step(mixed_precision=True, device="cuda")
    out["train_bf16_img_s"] = rate(lambda: step(state, batch, 0),
                                   TRAIN_BATCH)
    return out


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def run_ab(other: str, timeout: float = 600) -> dict:
    """OTHER, this, this, OTHER, each in a process of its own."""
    runs = []
    for tree in (other, HERE, HERE, other):
        done = subprocess.run(
            [sys.executable, "-P", os.path.abspath(__file__), "--tree",
             tree], check=True, capture_output=True, text=True,
            timeout=timeout)
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
    return {"card": card(), "runs": runs}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--tree", required=True,
                        help="time the paths of the package under TREE")
    args = parser.parse_args()
    print(json.dumps(probe(args.tree)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
