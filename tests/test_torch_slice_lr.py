"""The PyTorch port's ENB0-LR serving slice against the JAX package.

Both packages load ``e2e/ENB0-LR-synthetic.ede``, the JAX package's trained
MidasNet in the reference's self-describing format (sizes WH in the
header, HW in the model). The port's weights are the JAX variables through
``from_jax_variables``. At full serving size (480×640 frames, 228×304 model
input) on the CPU, in f32: the encoder taps and the 114×152 output against
``model.apply`` (rtol 1e-3, atol 1e-4, the tolerance of
``test_parity_full_size.py``), and the whole serving fn against JAX
``make_infer_fn(..., preprocess=True, upsample_to=(480, 640))``. The
committed fixture (``make_torch_port_fixture.py``) carries the JAX
reference to the CUDA card, which has no JAX.
"""

import copy
import json
import warnings

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
    MAGIC,
    load_midas,
    read_ede,
)
from efficientdepthestimation_tpu_torch.models.midas import MidasNet

from make_torch_port_fixture import (
    CHECKPOINT,
    LR_CHECKPOINT,
    LR_FIXTURE_PATH,
    fixture_frames,
    jax_depth,
)

MODEL_TOL = dict(rtol=1e-3, atol=1e-4)
# bf16 serving against the f32 reference, in metres of depth (1.1-3.4 m
# here): chip_smoke.py's phase 7 run on the CPU shows max 0.030 m, mean
# 0.0034 m; the bounds leave about 3x for the card's other summation
# orders, and chip_smoke.py holds the card's bf16 output to them.
BF16_MAX_ABS, BF16_MEAN_ABS = 0.1, 0.01


@pytest.fixture(scope="module")
def jax_model():
    return japps.load_any_checkpoint(LR_CHECKPOINT)


@pytest.fixture(scope="module")
def port_model():
    return load_any_checkpoint(LR_CHECKPOINT, device="cpu")


@pytest.fixture(scope="module")
def fixture():
    return dict(np.load(LR_FIXTURE_PATH))


def test_ede_reader_sees_every_array(port_model):
    header, tree = read_ede(LR_CHECKPOINT)
    assert header["format"] == "midas-self-describing"
    assert header["encoder"]["name"] == "efficientnet-b0"
    assert header["input_size"] == [304, 228]   # WH
    assert header["output_size"] == [152, 114]
    state = from_jax_variables(tree)
    assert len(state) == 411
    assert state["decoder.blocks.0.res_block1.down_sample.0.weight"].shape \
        == (24, 320, 1, 1)
    assert state["decoder.conv3.bias"].shape == (1,)
    assert isinstance(port_model, MidasNet)
    assert port_model.output_size == (114, 152)  # HW
    assert port_model.input_size == (228, 304)
    assert port_model.decoder.feature_count == 24
    assert not port_model.decoder.non_negative


def test_port_weights_are_the_jax_variables(jax_model, port_model):
    _, variables = jax_model
    state = from_jax_variables(jax.tree_util.tree_map(np.asarray, variables))
    ours = port_model.state_dict()
    assert set(state) == set(ours)
    for key, value in state.items():
        assert torch.equal(value, ours[key]), key


def test_encoder_taps_match_jax(jax_model, port_model):
    model, variables = jax_model
    images = jax_preprocess(jnp.asarray(fixture_frames()[:2]))
    enc_vars = {c: variables[c]["encoder"] for c in variables}
    ref = jax.jit(model.encoder_factory().apply)(enc_vars, images)
    with torch.inference_mode():
        ours = port_model.encoder(torch.from_numpy(np.array(images)))
    assert len(ours) == len(ref) == 4
    for i, (t, r) in enumerate(zip(ours, ref)):
        assert t.shape == r.shape, f"tap {i}"
        np.testing.assert_allclose(t.numpy(), np.asarray(r), **MODEL_TOL,
                                   err_msg=f"encoder tap {i}")


def test_jax_reproduces_fixture(fixture):
    frames = fixture_frames()
    assert int(frames.sum(dtype=np.int64)) == int(fixture["frames_sum"])
    np.testing.assert_allclose(jax_depth(frames, LR_CHECKPOINT),
                               fixture["depth"], rtol=1e-5, atol=1e-5)


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


def test_bf16_serving_near_fixture(port_model, fixture):
    serve = make_serving_fn(port_model, dtype=torch.bfloat16,
                            preprocess=True, device="cpu")
    out = serve(torch.from_numpy(fixture_frames()[:2]))[..., 0]
    assert out.dtype == torch.float32
    # the serving fn's cast (``model.to(dtype)`` of a copy) takes every
    # weight and statistic, the head conv's bias included, and leaves the
    # caller's model in f32
    cast = copy.deepcopy(port_model).to(torch.bfloat16)
    assert {v.dtype for v in cast.state_dict().values()} == {torch.bfloat16}
    assert port_model.decoder.conv3.bias.dtype == torch.float32
    err = np.abs(out.numpy() - fixture["depth"][:2])
    assert err.max() <= BF16_MAX_ABS and err.mean() <= BF16_MEAN_ABS


def _with_header(path, out, **changes):
    header, _ = read_ede(path)
    with open(path, "rb") as f:
        f.read(4)
        n = int.from_bytes(f.read(8), "little")
        f.read(n)
        payload = f.read()
    new = json.dumps({**header, **changes}).encode()
    out.write_bytes(MAGIC + len(new).to_bytes(8, "little") + new + payload)
    return str(out)


def test_version_mismatch_warns(tmp_path):
    path = _with_header(LR_CHECKPOINT, tmp_path / "old.ede", version="0.1.0")
    with pytest.warns(UserWarning, match="Version mismatch: checkpoint "
                      "0.1.0 vs 0.2.0"):
        model, header = load_midas(path)
    assert isinstance(model, MidasNet) and header["version"] == "0.1.0"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        load_midas(LR_CHECKPOINT)
    with pytest.raises(ValueError, match="Not a MidasNet"):
        load_midas(CHECKPOINT)


def test_header_sizes_are_wh(tmp_path):
    """A non-square header: (W, H) in the file, (H, W) in the model, and
    ``input_size`` defaults to ``output_size`` as in the JAX package."""
    path = _with_header(LR_CHECKPOINT, tmp_path / "wh.ede",
                        input_size=None, output_size=[100, 60])
    model, _ = load_midas(path)
    assert model.output_size == (60, 100) and model.input_size == (60, 100)
    with torch.inference_mode():
        out = model(torch.zeros(1, 64, 96, 3))
    assert out.shape == (1, 60, 100, 1)
