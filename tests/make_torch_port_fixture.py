"""Write the JAX reference outputs that the PyTorch port is held against.

The fixture holds the JAX package's f32 114×152 depth of ENB0-HU
(``e2e/ENB0-HU-synthetic.ede``) for 4 uint8 480×640 frames drawn from
``np.random.default_rng(0)``: ``model.apply(v, eval_preprocess_image_only(
frames))``. ``tests/test_torch_slice.py`` checks that JAX still reproduces it
and that the port matches it on the CPU; ``chip_smoke.py`` compares the port
on the CUDA card against it, where there is no JAX.

    JAX_PLATFORMS=cpu python tests/make_torch_port_fixture.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_PATH = os.path.join(HERE, "fixtures", "torch_port_enb0_hu.npz")
CHECKPOINT = os.path.join(HERE, "..", "e2e", "ENB0-HU-synthetic.ede")
N_FRAMES = 4


def fixture_frames() -> np.ndarray:
    return np.random.default_rng(0).integers(0, 256, (N_FRAMES, 480, 640, 3),
                                             dtype=np.uint8)


def jax_depth(frames: np.ndarray) -> np.ndarray:
    """The JAX package's f32 (N, 114, 152) depth for uint8 frames."""
    import jax.numpy as jnp

    from efficientdepthestimation_tpu.apps.common import load_any_checkpoint
    from efficientdepthestimation_tpu.data.transforms import (
        eval_preprocess_image_only,
    )

    model, variables = load_any_checkpoint(CHECKPOINT)
    images = eval_preprocess_image_only(jnp.asarray(frames))
    return np.asarray(model.apply(variables, images))[..., 0]


def main() -> None:
    frames = fixture_frames()
    depth = jax_depth(frames).astype(np.float32)
    np.savez_compressed(FIXTURE_PATH, depth=depth,
                        frames_sum=np.int64(frames.sum(dtype=np.int64)))
    print(f"wrote {FIXTURE_PATH}: depth {depth.shape}, "
          f"{os.path.getsize(FIXTURE_PATH)} bytes")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))  # the repo root
    main()
