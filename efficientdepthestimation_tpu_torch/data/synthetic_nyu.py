"""Procedural NYU-v2 stand-in with real depth structure, host numpy only.

A copy of ``efficientdepthestimation_tpu/data/synthetic_nyu.py``: simple
"rooms" (a floor/back-wall depth ramp plus box and ellipse furniture at
nearer depths), RGB shaded from depth and textured, deterministic in the
seed, and the PNG/CSV dataset writer. The committed
``e2e/ENB0-HU-synthetic.ede`` was trained on these scenes; the training
tests and ``chip_smoke.py`` make their batches from them, and
``chip_smoke.py`` evaluates on ``eval_pair`` scenes built in memory, the
pairs ``generate_dataset`` writes. PIL is imported only where PNGs are
written.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["render_scene", "depth_png_units", "train_pair", "eval_pair",
           "synthetic_train_set", "TEST_SEED_OFFSET", "generate_dataset",
           "main"]

# Test scenes use seeds seed + i + TEST_SEED_OFFSET, disjoint from training.
TEST_SEED_OFFSET = 10_000_000


def _smooth_noise(rng: np.random.Generator, hw: Tuple[int, int],
                  octaves: int = 3) -> np.ndarray:
    """Cheap multi-octave value noise in [0, 1] (no scipy dependency)."""
    h, w = hw
    out = np.zeros(hw, np.float32)
    amp = 1.0
    for o in range(octaves):
        gh, gw = 4 * 2 ** o, 5 * 2 ** o
        grid = rng.random((gh, gw), dtype=np.float32)
        ys = np.linspace(0, gh - 1, h, dtype=np.float32)
        xs = np.linspace(0, gw - 1, w, dtype=np.float32)
        y0 = np.clip(ys.astype(np.int32), 0, gh - 2)
        x0 = np.clip(xs.astype(np.int32), 0, gw - 2)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        a = grid[y0][:, x0]
        b = grid[y0][:, x0 + 1]
        c = grid[y0 + 1][:, x0]
        d = grid[y0 + 1][:, x0 + 1]
        out += amp * ((1 - fy) * ((1 - fx) * a + fx * b)
                      + fy * ((1 - fx) * c + fx * d))
        amp *= 0.5
    return out / (2.0 - 2.0 ** (1 - octaves))


def render_scene(seed: int, hw: Tuple[int, int] = (480, 640),
                 n_objects: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """One scene → ``(rgb uint8 HxWx3, depth_m float32 HxW)``.

    Depth is in metres, NYU-like range ~[0.7, 10). Deterministic in ``seed``.
    """
    rng = np.random.default_rng(seed)
    h, w = hw
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]

    # Room shell: back wall plane + floor ramp meeting at a horizon line.
    wall_d = rng.uniform(4.0, 9.0)
    horizon = rng.uniform(0.45, 0.7)
    side_tilt = rng.uniform(-1.5, 1.5)  # oblique viewing angle
    wall = wall_d + side_tilt * (xx - 0.5) * np.ones_like(yy)
    # floor: depth decreases from wall_d at the horizon to ~1m at the bottom
    frac = np.clip((yy - horizon) / max(1e-6, 1.0 - horizon), 0.0, 1.0)
    floor = wall_d / (1.0 + frac * (wall_d / 1.2 - 1.0))
    depth = np.where(yy < horizon, wall, floor).astype(np.float32)

    # Per-pixel region id for albedo (0 = wall, 1 = floor, 2+ = objects)
    region = np.where(yy < horizon, 0, 1).astype(np.int32)

    if n_objects is None:
        n_objects = int(rng.integers(3, 9))
    for i in range(n_objects):
        oy, ox = rng.uniform(0.15, 0.95), rng.uniform(0.05, 0.95)
        oh = rng.uniform(0.08, 0.45)
        ow = rng.uniform(0.06, 0.35)
        # objects sit in front of whatever is behind them
        base = float(depth[min(h - 1, int(oy * h)), min(w - 1, int(ox * w))])
        od = rng.uniform(0.7, max(0.8, base * 0.85))
        if rng.random() < 0.5:  # box
            mask = ((np.abs(yy - oy) < oh / 2) & (np.abs(xx - ox) < ow / 2))
        else:  # ellipse
            mask = (((yy - oy) / (oh / 2)) ** 2 + ((xx - ox) / (ow / 2)) ** 2) < 1.0
        # slight front-face depth gradient so objects are not flat cards
        obj_depth = od + 0.3 * oh * (yy - oy)
        closer = mask & (obj_depth < depth)
        depth = np.where(closer, obj_depth, depth).astype(np.float32)
        region = np.where(closer, i + 2, region)

    depth = np.clip(depth, 0.7, 9.99)

    # RGB: per-region albedo × depth-cue shading × normal shading × texture.
    albedo = rng.uniform(0.25, 0.95, size=(n_objects + 2, 3)).astype(np.float32)
    rgb = albedo[region]  # HxWx3
    # darker with distance (the main monocular cue)
    shade = (1.0 - 0.55 * (depth - 0.7) / 9.3)[..., None]
    # normal shading from the depth gradient (lights edges/slopes)
    gy, gx = np.gradient(depth)
    normal_shade = (1.0 / np.sqrt(1.0 + 25.0 * (gx ** 2 + gy ** 2)))[..., None]
    tex = (0.85 + 0.3 * _smooth_noise(rng, hw))[..., None]
    rgb = np.clip(rgb * shade * (0.6 + 0.4 * normal_shade) * tex, 0.0, 1.0)
    return (rgb * 255).astype(np.uint8), depth


def depth_png_units(depth_m: np.ndarray, is_test: bool) -> np.ndarray:
    """Depth in metres as its PNG stores it: 16-bit millimetres for the
    test split (nyu_transform.py:173), 8-bit ×25.5 per metre for training
    (nyu_transform.py:175)."""
    if is_test:
        return np.clip(depth_m * 1000.0, 0, 65535).astype(np.uint16)
    return np.clip(depth_m * 25.5, 0, 255).astype(np.uint8)


def train_pair(seed: int, hw: Tuple[int, int] = (480, 640)
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``(rgb uint8 HxWx3, depth uint8 HxW)``, the 8-bit train convention."""
    rgb, depth_m = render_scene(seed, hw)
    return rgb, depth_png_units(depth_m, is_test=False)


def eval_pair(seed: int, hw: Tuple[int, int] = (480, 640)
              ) -> Tuple[np.ndarray, np.ndarray]:
    """``(rgb uint8 HxWx3, depth uint16 HxW)``, 16-bit millimetres: test
    pair ``i`` of ``generate_dataset(seed=s)`` is
    ``eval_pair(s + i + TEST_SEED_OFFSET)``."""
    rgb, depth_m = render_scene(seed, hw)
    return rgb, depth_png_units(depth_m, is_test=True)



def synthetic_train_set(seeds: Sequence[int],
                        hw: Tuple[int, int] = (480, 640)
                        ) -> list[Tuple[np.ndarray, np.ndarray]]:
    """An in-memory training set of ``train_pair`` scenes, one per seed,
    that ``data.datasets.batch_iterator`` batches."""
    return [train_pair(s, hw) for s in seeds]


def _save_pair(img_dir, depth_dir, idx, rgb, depth_m, is_test):
    from PIL import Image

    img_path = os.path.join(img_dir, f"{idx:05d}.png")
    depth_path = os.path.join(depth_dir, f"{idx:05d}.png")
    Image.fromarray(rgb).save(img_path)
    # uint16 arrays become 16-bit ("I;16") PNGs, uint8 8-bit ("L") ones.
    Image.fromarray(depth_png_units(depth_m, is_test)).save(depth_path)
    return img_path, depth_path


def generate_dataset(out_dir: str, n_train: int = 2000, n_test: int = 200,
                     hw: Tuple[int, int] = (480, 640), seed: int = 0,
                     ) -> Tuple[str, str]:
    """Write the dataset; returns ``(train_csv, test_csv)`` paths.

    CSV rows are ``image_path,depth_path`` with no header, the format of
    the reference's ``nyu2_train.csv`` (``loaddata.py:14-18``). Train and
    test scenes use disjoint seed ranges.
    """
    paths = {}
    for split, n, is_test in (("train", n_train, False),
                              ("test", n_test, True)):
        img_dir = os.path.join(out_dir, split, "images")
        depth_dir = os.path.join(out_dir, split, "depths")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(depth_dir, exist_ok=True)
        csv_path = os.path.join(out_dir, f"{split}.csv")
        with open(csv_path, "w", newline="") as f:
            writer = csv.writer(f)
            for i in range(n):
                scene_seed = seed + i + (TEST_SEED_OFFSET if is_test else 0)
                rgb, depth_m = render_scene(scene_seed, hw)
                writer.writerow(_save_pair(img_dir, depth_dir, i, rgb,
                                           depth_m, is_test))
        paths[split] = csv_path
    return paths["train"], paths["test"]


def main(args=None):
    parser = argparse.ArgumentParser(description="Generate synthetic NYU data")
    parser.add_argument("--out", required=True)
    parser.add_argument("--train", type=int, default=2000)
    parser.add_argument("--test", type=int, default=200)
    parser.add_argument("--hw", type=int, nargs=2, default=(480, 640))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(args)
    train_csv, test_csv = generate_dataset(
        args.out, args.train, args.test, tuple(args.hw), args.seed)
    print(f"train: {train_csv}\ntest:  {test_csv}")


if __name__ == "__main__":
    main()
