"""Write the JAX reference outputs that the PyTorch port is held against.

Each fixture holds the JAX package's f32 114×152 depth of one trained
checkpoint for 4 uint8 480×640 frames drawn from ``np.random.default_rng(0)``:
``model.apply(v, eval_preprocess_image_only(frames))``.

* ``torch_port_enb0_hu.npz``: ENB0-HU, ``e2e/ENB0-HU-synthetic.ede``;
* ``torch_port_enb0_lr.npz``: ENB0-LR, ``e2e/ENB0-LR-synthetic.ede`` (the
  self-describing MidasNet format).

``tests/test_torch_slice.py`` and ``tests/test_torch_slice_lr.py`` check
that JAX still reproduces them and that the port matches them on the CPU;
``chip_smoke.py`` compares the port on the CUDA card against them, where
there is no JAX.

    JAX_PLATFORMS=cpu python tests/make_torch_port_fixture.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_PATH = os.path.join(HERE, "fixtures", "torch_port_enb0_hu.npz")
CHECKPOINT = os.path.join(HERE, "..", "e2e", "ENB0-HU-synthetic.ede")
LR_FIXTURE_PATH = os.path.join(HERE, "fixtures", "torch_port_enb0_lr.npz")
LR_CHECKPOINT = os.path.join(HERE, "..", "e2e", "ENB0-LR-synthetic.ede")
N_FRAMES = 4


def fixture_frames() -> np.ndarray:
    return np.random.default_rng(0).integers(0, 256, (N_FRAMES, 480, 640, 3),
                                             dtype=np.uint8)


def jax_depth(frames: np.ndarray, checkpoint: str = CHECKPOINT) -> np.ndarray:
    """The JAX package's f32 (N, 114, 152) depth for uint8 frames."""
    import jax.numpy as jnp

    from efficientdepthestimation_tpu.apps.common import load_any_checkpoint
    from efficientdepthestimation_tpu.data.transforms import (
        eval_preprocess_image_only,
    )

    model, variables = load_any_checkpoint(checkpoint)
    images = eval_preprocess_image_only(jnp.asarray(frames))
    return np.asarray(model.apply(variables, images))[..., 0]


def main() -> None:
    frames = fixture_frames()
    for checkpoint, path in ((CHECKPOINT, FIXTURE_PATH),
                             (LR_CHECKPOINT, LR_FIXTURE_PATH)):
        depth = jax_depth(frames, checkpoint).astype(np.float32)
        np.savez_compressed(path, depth=depth,
                            frames_sum=np.int64(frames.sum(dtype=np.int64)))
        print(f"wrote {path}: depth {depth.shape}, "
              f"{os.path.getsize(path)} bytes")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))  # the repo root
    main()
