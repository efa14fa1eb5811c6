"""Write the JAX training-step reference that the PyTorch port is held against.

One ENB0-HU training step of the JAX package, in f32, on the CPU:
``e2e/ENB0-HU-synthetic.ede`` with drop-connect off (the model is rebuilt
here with ``EfficientNetFeatures(drop_connect_rate=0.0)``, since
``jax.random``'s bits cannot be reproduced by a ``torch.Generator``), two
``render_scene`` frames (seeds 0 and 1, depth ×25.5 as uint8, the train
convention), ``PRNGKey(0)`` at step 0, the 228×304 crop, the fused loss in
Pallas interpret mode. The fixture holds:

- the augmentation draws ``train_preprocess`` makes from the step's key;
- the loss and the ``depth_metrics_batch`` sums of the step;
- a dozen gradient leaves across E, D, MFF and R
  (``make_grad_snapshot(use_pallas_loss=True, pallas_interpret=True)``);
- after one ``make_train_step`` (Adam 1e-4 with L2 1e-4): three BN running
  statistics and three parameter leaves.

``tests/test_torch_training.py`` holds the port's CPU step to it, and (marked
slow) checks that JAX still reproduces it; ``chip_smoke.py`` holds the port's
f32 step on the CUDA card to it, where there is no JAX.

    JAX_PLATFORMS=cpu python tests/make_torch_train_fixture.py
"""

from __future__ import annotations

import functools
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_PATH = os.path.join(HERE, "fixtures", "torch_train_enb0_hu.npz")
CHECKPOINT = os.path.join(HERE, "..", "e2e", "ENB0-HU-synthetic.ede")
SEEDS = (0, 1)
CROP_HW = (228, 304)
LR = WEIGHT_DECAY = 1e-4

# JAX variable paths ("collection/module/.../leaf") kept in the fixture.
GRAD_LEAVES = (
    "E/_conv_stem/kernel", "E/_bn0/scale",
    "E/_blocks.0/_depthwise_conv/kernel", "E/_blocks.5/_se_reduce/bias",
    "E/_blocks.9/_bn1/bias", "E/_blocks.15/_bn2/scale",
    "D/bn/scale", "D/up3/conv1/kernel", "D/up4/conv1/kernel",
    "MFF/up1/conv2/kernel", "MFF/up3/conv2/kernel", "MFF/bn/bias",
    "R/bn1/scale", "R/conv2/kernel", "R/conv2/bias",
)
STAT_LEAVES = ("E/_bn0/var", "D/up4/bn1/mean", "R/bn0/var")
PARAM_LEAVES = ("E/_blocks.0/_depthwise_conv/kernel", "D/up4/conv1/kernel",
                "R/conv2/kernel")


def train_frames() -> tuple[np.ndarray, np.ndarray]:
    """uint8 (2, 480, 640, 3) frames and uint8 (2, 480, 640) depths."""
    from efficientdepthestimation_tpu.data.synthetic_nyu import render_scene

    scenes = [render_scene(s) for s in SEEDS]
    images = np.stack([rgb for rgb, _ in scenes])
    depths = np.stack([np.clip(d * 25.5, 0, 255).astype(np.uint8)
                       for _, d in scenes])
    return images, depths


def _leaf(tree: dict, path: str) -> np.ndarray:
    for key in path.split("/"):
        tree = tree[key]
    return np.asarray(tree)


def augmentation_draws(key, n: int) -> dict[str, np.ndarray]:
    """The draws ``train_preprocess`` makes from ``key``, in its order
    (``data/transforms.py:268, 275, 282, 297, 305-307, 319``)."""
    import jax

    k_flip, k_rot, k_light, k_order, k_b, k_c, k_s = jax.random.split(key, 7)

    def u(k, shape):
        return jax.random.uniform(k, shape, minval=-0.4, maxval=0.4)

    return {
        "flip": np.asarray(jax.random.bernoulli(k_flip, 0.5, (n,))),
        "angles": np.asarray(jax.random.uniform(k_rot, (n,), minval=-5.0,
                                                maxval=5.0)),
        "alpha": np.asarray(jax.random.normal(k_light, (n, 3)) * 0.1),
        "order": np.asarray(jax.random.permutation(k_order, 3)),
        "a_b": np.asarray(u(k_b, (n, 1, 1, 1))).reshape(n),
        "a_c": np.asarray(u(k_c, (n, 1, 1, 1))).reshape(n),
        "a_s": np.asarray(u(k_s, (n, 1, 1, 1))).reshape(n),
    }


def jax_reference() -> dict[str, np.ndarray]:
    """Run the JAX step and gather everything the fixture keeps."""
    import jax
    import jax.numpy as jnp

    from efficientdepthestimation_tpu.apps.common import load_any_checkpoint
    from efficientdepthestimation_tpu.models.efficientnet import (
        EfficientNetFeatures,
    )
    from efficientdepthestimation_tpu.training.train_step import (
        adam_with_l2,
        create_train_state,
        make_grad_snapshot,
        make_train_step,
    )

    loaded, variables = load_any_checkpoint(CHECKPOINT)
    variant = loaded.encoder_factory.keywords["variant"]
    model = loaded.clone(encoder_factory=functools.partial(
        EfficientNetFeatures, variant=variant, drop_connect_rate=0.0))
    state = create_train_state(model, variables,
                               adam_with_l2(LR, WEIGHT_DECAY))
    images, depths = train_frames()
    batch = {"image": jnp.asarray(images), "depth": jnp.asarray(depths),
             "num_valid": jnp.asarray(len(SEEDS), jnp.int32)}
    rng = jax.random.PRNGKey(0)
    rng_aug, _ = jax.random.split(jax.random.fold_in(rng, 0))

    out = {f"draw_{k}": v
           for k, v in augmentation_draws(rng_aug, len(SEEDS)).items()}
    out["frames_sum"] = np.int64(images.sum(dtype=np.int64))
    out["depths_sum"] = np.int64(depths.sum(dtype=np.int64))

    kw = dict(use_pallas_loss=True, pallas_interpret=True, preprocess=True,
              crop_hw=CROP_HW)
    t0 = time.perf_counter()
    grads = make_grad_snapshot(**kw)(state, batch, rng)
    print(f"grad snapshot: {time.perf_counter() - t0:.0f} s", flush=True)
    for path in GRAD_LEAVES:
        out[f"grad/{path}"] = _leaf(grads, path)

    t0 = time.perf_counter()
    new_state, metrics = make_train_step(donate=False, **kw)(state, batch,
                                                             rng)
    print(f"train step: {time.perf_counter() - t0:.0f} s", flush=True)
    for name, value in metrics.items():
        out[f"metric/{name}"] = np.float32(value)
    for path in STAT_LEAVES:
        out[f"stat/{path}"] = _leaf(new_state.batch_stats, path)
    for path in PARAM_LEAVES:
        out[f"param/{path}"] = _leaf(new_state.params, path)
    return out


def main() -> None:
    out = jax_reference()
    np.savez_compressed(FIXTURE_PATH, **out)
    print(f"wrote {FIXTURE_PATH}: loss {float(out['metric/loss']):.6f}, "
          f"{os.path.getsize(FIXTURE_PATH)} bytes")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))  # the repo root
    main()
