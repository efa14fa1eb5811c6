#!/usr/bin/env python3
"""Time the loss kernel pair of two checkouts of the port on one card.

    python3 -P loss_ab.py --ab OTHER_TREE

runs, each in a process of its own, OTHER_TREE's pair, this tree's, this
tree's again and OTHER_TREE's again (``OTHER_TREE`` is a directory that
holds an ``efficientdepthestimation_tpu_torch`` package, e.g. a
``git archive`` of the parent commit). Each process imports the named
tree's package, and this tree's ``chip_smoke.py`` for its inputs and its
timing method: at the training shape (64, 114, 152), ``loss_inputs`` with
bf16 pred, it times one ``fused_depth_loss_fwd`` call, one
``fused_depth_loss_bwd`` call and the launch floor, an empty kernel
(``torch.cuda._sleep(0)``), each by ``graph_ms`` (CUDA-graph replay: the
device time of the wrapper's call, fills included), best of 5 graphs. It
prints one JSON line per process and a last line with all four and the
card. It needs a CUDA card; ``-P`` keeps this file's directory off
``sys.path``, so that only the named tree's package is imported.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPEATS = 5


def smoke_module(tree: str):
    """This tree's chip_smoke.py, importing the package under ``tree``."""
    sys.path.insert(0, os.path.abspath(tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_tree(tree: str) -> dict:
    """The pair of the package under ``tree``, best of REPEATS graphs."""
    smoke = smoke_module(tree)
    import torch

    from efficientdepthestimation_tpu_torch.ops.kernels import fused_loss

    if not torch.cuda.is_available():
        raise SystemExit("loss_ab: no CUDA device is available")
    gen = torch.Generator(device="cuda").manual_seed(3)
    pred, target = smoke.loss_inputs(torch.bfloat16, gen)
    mask = torch.ones(pred.shape[0], device="cuda")
    coef = torch.full((1,), 1.0 / pred.numel(), device="cuda")
    fns = {"launch_floor": lambda: torch.cuda._sleep(0),
           "fwd": lambda: fused_loss.fused_depth_loss_fwd(pred, target),
           "bwd": lambda: fused_loss.fused_depth_loss_bwd(pred, target, mask,
                                                          coef)}
    out = {"tree": tree, "package": os.path.dirname(fused_loss.__file__)}
    for name, fn in fns.items():
        out[name + "_ms"] = min(smoke.graph_ms(fn) for _ in range(REPEATS))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--tree", help="time the pair of this tree")
    group.add_argument("--ab", help="time OTHER_TREE, this, this, OTHER_TREE")
    args = parser.parse_args()
    if args.tree:
        print(json.dumps(time_tree(args.tree)), flush=True)
        return 0
    runs = []
    for tree in (args.ab, HERE, HERE, args.ab):
        done = subprocess.run(
            [sys.executable, "-P", os.path.abspath(__file__), "--tree",
             tree], check=True, capture_output=True, text=True, timeout=600)
        line = done.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
