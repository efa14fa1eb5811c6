"""Write the JAX evaluation reference that the PyTorch port is held against.

The JAX package evaluates both committed checkpoints in f32 on the CPU over
the first 60 test pairs of ``synthetic_nyu.generate_dataset(seed=0)``, built
in memory (``render_scene(10_000_000 + i)``, depth as 16-bit millimetres;
the PNG round trip is lossless, so the arrays are those of the files):
``eval_preprocess``, then ``make_eval_step`` (forward, align-corners
upsample to the 228×304 label, ``depth_metrics_batch``) and
``edge_metrics_batch`` at threshold 0.25 on the step's output, over
``batch_iterator(..., pad_last=True)`` at batch 8 (7 full batches and a
tail of 4) and batch 1. For each model ``m`` (``hu``, ``lr``) and batch
size ``b`` (8, 1) the fixture holds metric values only:

- ``{m}/b{b}/sums``: per batch, the depth sums in ``SUM_KEYS`` order;
- ``{m}/b{b}/edge_sums``: per batch, the edge sums in ``EDGE_KEYS`` order;
- ``{m}/b{b}/tracker``: ``MetricsTracker.to_dict()`` in ``TRACKER_KEYS``
  order after the last batch;
- ``{m}/b{b}/edge``: the edge averages (sums over the 60 pairs / 60);
- ``hu/b4first4/sums``, ``hu/b4first4/edge_sums``: ENB0-HU on the first 4
  pairs as one batch of 4;
- ``frames_sum``, ``depths_sum``: checks of the recipe.

``tests/test_torch_eval.py`` holds the port's CPU evaluation to it;
``chip_smoke.py`` phase 9 holds the evaluation on the CUDA card to it, where
there is no JAX.

    JAX_PLATFORMS=cpu python tests/make_torch_eval_fixture.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_PATH = os.path.join(HERE, "fixtures", "torch_eval_enb0.npz")
CHECKPOINTS = {"hu": os.path.join(HERE, "..", "e2e", "ENB0-HU-synthetic.ede"),
               "lr": os.path.join(HERE, "..", "e2e", "ENB0-LR-synthetic.ede")}
N_PAIRS = 60
TEST_SEED_BASE = 10_000_000  # generate_dataset's test scenes, seed 0
BATCH_SIZES = (8, 1)
THRESHOLD = 0.25
SUM_KEYS = ("mae", "mse", "abs_rel", "log10", "delta1", "delta2", "delta3",
            "batch_size")
EDGE_KEYS = ("edge_accuracy", "edge_precision", "edge_recall", "edge_f1")
TRACKER_KEYS = ("mae", "mse", "abs_rel", "log10", "delta1", "delta2",
                "delta3", "rmse")


def eval_pairs(n: int = N_PAIRS) -> list[tuple[np.ndarray, np.ndarray]]:
    """(uint8 RGB 480×640×3, uint16 depth mm 480×640) of the first ``n``
    test scenes, as ``generate_dataset`` writes them."""
    from efficientdepthestimation_tpu.data.synthetic_nyu import render_scene

    pairs = []
    for i in range(n):
        rgb, depth_m = render_scene(TEST_SEED_BASE + i)
        pairs.append((rgb, np.clip(depth_m * 1000.0, 0, 65535)
                      .astype(np.uint16)))
    return pairs


def evaluate(checkpoint: str, pairs, batch_size: int):
    """Per-batch depth and edge sums, the tracker and the edge averages of
    the JAX package's evaluation."""
    import jax
    import jax.numpy as jnp

    from efficientdepthestimation_tpu.apps.common import load_any_checkpoint
    from efficientdepthestimation_tpu.data import (
        batch_iterator,
        eval_preprocess,
    )
    from efficientdepthestimation_tpu.training.metrics import (
        MetricsTracker,
        edge_metrics_batch,
    )
    from efficientdepthestimation_tpu.training.train_step import (
        TrainState,
        make_eval_step,
    )

    model, variables = load_any_checkpoint(checkpoint)
    state = TrainState(step=0, params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=None,
                       apply_fn=model.apply, tx=None)
    eval_step = make_eval_step()
    edges = jax.jit(lambda out, depths, nv: edge_metrics_batch(
        out, depths, THRESHOLD, num_valid=nv))
    tracker = MetricsTracker()
    sums_rows, edge_rows = [], []
    for batch in batch_iterator(pairs, batch_size, pad_last=True):
        images, depths = eval_preprocess(jnp.asarray(batch["image"]),
                                         jnp.asarray(batch["depth"]))
        nv = jnp.asarray(batch["num_valid"], jnp.int32)
        sums, out = eval_step(state, images, depths, nv)
        sums = jax.device_get(sums)
        edge = jax.device_get(edges(out, depths, nv))
        tracker.update_from_sums(sums)
        sums_rows.append([float(sums[k]) for k in SUM_KEYS])
        edge_rows.append([float(edge[k]) for k in EDGE_KEYS])
    total = sum(int(r[-1]) for r in sums_rows)
    values = tracker.to_dict()
    edge_rows = np.array(edge_rows, np.float64)
    return (np.array(sums_rows, np.float64), edge_rows,
            np.array([values[k] for k in TRACKER_KEYS], np.float64),
            edge_rows.sum(axis=0) / total)


def main() -> None:
    t0 = time.perf_counter()
    pairs = eval_pairs()
    out = {"frames_sum": np.int64(sum(int(p[0].sum(dtype=np.int64))
                                      for p in pairs)),
           "depths_sum": np.int64(sum(int(p[1].sum(dtype=np.int64))
                                      for p in pairs))}
    for name, checkpoint in CHECKPOINTS.items():
        for b in BATCH_SIZES:
            sums, edge_sums, tracker, edge = evaluate(checkpoint, pairs, b)
            out[f"{name}/b{b}/sums"] = sums
            out[f"{name}/b{b}/edge_sums"] = edge_sums
            out[f"{name}/b{b}/tracker"] = tracker
            out[f"{name}/b{b}/edge"] = edge
            print(f"{name} batch {b}: tracker "
                  + " ".join(f"{k} {v:.6g}" for k, v in zip(TRACKER_KEYS,
                                                            tracker))
                  + "; edge " + " ".join(f"{v:.6g}" for v in edge),
                  flush=True)
    sums, edge_sums, _, _ = evaluate(CHECKPOINTS["hu"], pairs[:4], 4)
    out["hu/b4first4/sums"] = sums
    out["hu/b4first4/edge_sums"] = edge_sums
    np.savez_compressed(FIXTURE_PATH, **out)
    print(f"wrote {FIXTURE_PATH}: {os.path.getsize(FIXTURE_PATH)} bytes in "
          f"{time.perf_counter() - t0:.0f} s")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))  # the repo root
    main()
