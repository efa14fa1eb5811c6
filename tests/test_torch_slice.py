"""The PyTorch port's ENB0-HU serving slice against the JAX package.

Both packages load ``e2e/ENB0-HU-synthetic.ede``; the port's weights are the
JAX variables through ``from_jax_variables``. At full serving size
(480×640 frames, 228×304 model input) on the CPU, in f32:
encoder taps and the 114×152 output against ``model.apply`` (rtol 1e-3,
atol 1e-4, the tolerance of ``test_parity_full_size.py``), and the whole
serving fn against JAX ``make_infer_fn(..., preprocess=True,
upsample_to=(480, 640))``. The committed fixture
(``make_torch_port_fixture.py``) carries the JAX reference to the CUDA card,
which has no JAX; here JAX must still reproduce it and the port match it.
"""

import inspect

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from efficientdepthestimation_tpu.apps import common as japps
from efficientdepthestimation_tpu.data.transforms import (
    eval_preprocess_image_only as jax_preprocess,
)

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
    make_infer_fn,
    make_serving_fn,
)
from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    from_jax_variables,
)
from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
    read_ede,
)

from make_torch_port_fixture import (
    CHECKPOINT,
    FIXTURE_PATH,
    fixture_frames,
    jax_depth,
)

MODEL_TOL = dict(rtol=1e-3, atol=1e-4)
# bf16 serving against the f32 reference, in metres of depth (1-7 m here);
# the same bounds chip_smoke.py holds the card's bf16 output to.
BF16_MAX_ABS, BF16_MEAN_ABS = 0.5, 0.05


@pytest.fixture(scope="module")
def jax_model():
    return japps.load_any_checkpoint(CHECKPOINT)


@pytest.fixture(scope="module")
def port_model():
    return load_any_checkpoint(CHECKPOINT, device="cpu")


@pytest.fixture(scope="module")
def fixture():
    return dict(np.load(FIXTURE_PATH))


def test_ede_reader_sees_every_array():
    header, tree = read_ede(CHECKPOINT)
    assert header["encoder"] == "efficientnet-b0"
    assert header["decoder"] == "hu2018"
    state = from_jax_variables(tree)
    assert len(state) == 446
    # HWIO → OIHW, and the depthwise (k, k, 1, C) → (C, 1, k, k)
    assert state["E._blocks.1._depthwise_conv.weight"].shape == (96, 1, 3, 3)
    assert state["D.up1.conv1.weight"].shape == (80, 160, 5, 5)
    assert state["E._bn0.running_var"].shape == (32,)


def test_port_weights_are_the_jax_variables(jax_model, port_model):
    _, variables = jax_model
    state = from_jax_variables(jax.tree_util.tree_map(np.asarray, variables))
    ours = port_model.state_dict()
    assert set(state) == set(ours)
    for key, value in state.items():
        assert torch.equal(value, ours[key]), key


def test_encoder_taps_match_jax(jax_model, port_model, fixture):
    model, variables = jax_model
    images = jax_preprocess(jnp.asarray(fixture_frames()[:2]))
    enc_vars = {"params": variables["params"]["E"],
                "batch_stats": variables["batch_stats"]["E"]}
    ref = model.encoder_factory().apply(enc_vars, images)
    with torch.inference_mode():
        ours = port_model.E(torch.from_numpy(np.array(images)))
    assert len(ours) == len(ref) == 4
    for i, (t, r) in enumerate(zip(ours, ref)):
        assert t.shape == r.shape, f"tap {i}"
        np.testing.assert_allclose(t.numpy(), np.asarray(r), **MODEL_TOL,
                                   err_msg=f"encoder tap {i}")


def test_jax_reproduces_fixture(fixture):
    frames = fixture_frames()
    assert int(frames.sum(dtype=np.int64)) == int(fixture["frames_sum"])
    np.testing.assert_allclose(jax_depth(frames), fixture["depth"],
                               rtol=1e-5, atol=1e-5)


def test_port_matches_fixture(port_model, fixture):
    infer = make_infer_fn(port_model, preprocess=True, device="cpu")
    out = infer(torch.from_numpy(fixture_frames()))
    assert out.shape == (4, 114, 152, 1) and out.dtype == torch.float32
    np.testing.assert_allclose(out[..., 0].numpy(), fixture["depth"],
                               **MODEL_TOL)


def test_serving_fn_matches_jax(jax_model, port_model):
    frames = np.random.default_rng(1).integers(0, 256, (2, 480, 640, 3),
                                               dtype=np.uint8)
    model, variables = jax_model
    ref = japps.make_infer_fn(model, variables, upsample_to=(480, 640),
                              preprocess=True)(jnp.asarray(frames))
    serve = make_serving_fn(port_model, upsample_to=(480, 640),
                            dtype=torch.float32, preprocess=True,
                            device="cpu")
    out = serve(torch.from_numpy(frames))
    assert out.shape == (2, 480, 640, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)


def test_serving_fn_defaults_match_jax(jax_model, port_model):
    """``make_serving_fn`` with no option in both packages: the same
    defaults, so normalized f32 images in and f32 depth at the model's
    output size out, the same values."""
    port = inspect.signature(make_serving_fn).parameters
    ref = inspect.signature(japps.make_serving_fn).parameters
    for name in ("upsample_to", "dtype", "preprocess"):
        assert port[name].default == ref[name].default, name
    images = np.random.default_rng(3).standard_normal(
        (2, 228, 304, 3)).astype(np.float32)
    model, variables = jax_model
    expected = japps.make_serving_fn(model, variables)(jnp.asarray(images))
    out = make_serving_fn(port_model, device="cpu")(torch.from_numpy(images))
    assert expected.shape == out.shape == (2, 114, 152, 1)
    assert expected.dtype == jnp.float32 and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(expected),
                               **MODEL_TOL)


def test_bf16_serving_near_fixture(port_model, fixture):
    serve = make_serving_fn(port_model, dtype=torch.bfloat16,
                            preprocess=True, device="cpu")
    out = serve(torch.from_numpy(fixture_frames()[:2]))[..., 0]
    assert out.dtype == torch.float32
    err = np.abs(out.numpy() - fixture["depth"][:2])
    assert err.max() <= BF16_MAX_ABS and err.mean() <= BF16_MEAN_ABS

