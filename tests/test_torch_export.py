"""Ahead-of-time serving artifacts of the port (``checkpoints/export.py``,
``apps/export.py``), on the CPU.

The JAX package's ``tests/test_export.py`` cases on the port's artifacts
(baked round trip, arg weights serving their own tree and a swapped one,
dynamic batch, f32 exact against the live pipeline, non-artifacts
refused); ENB0-HU's f32 artifact against the JAX package's ``_pipeline``
on the same frames and weights; each package refusing the other's
artifact; an artifact served by a fresh interpreter that imports no model,
app or checkpoint-reader module of the port; and the export CLI's
``--verify``.
"""

import json
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as jnn
from torch import nn

from efficientdepthestimation_tpu.apps.common import (
    load_any_checkpoint as jax_load_any_checkpoint,
)
from efficientdepthestimation_tpu.checkpoints import export as jax_export

from efficientdepthestimation_tpu_torch.apps import export as export_app
from efficientdepthestimation_tpu_torch.apps.common import (
    _serving_copy,
    load_any_checkpoint,
)
from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    to_jax_variables,
)
from efficientdepthestimation_tpu_torch.checkpoints.export import (
    load_serving_artifact,
    pipeline,
    save_serving_artifact,
)
from efficientdepthestimation_tpu_torch.models.common import (
    BatchNorm,
    Conv,
    randomize_,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(ROOT, "e2e", "ENB0-HU-synthetic.ede")
IN_HW, CROP_HW, OUT_HW = (60, 80), (24, 32), (60, 80)
# ENB0-HU's artifacts take the deployment's 480×640 frames, the crop and
# output cut to keep the CPU forward short.
ENB0_HW = dict(in_hw=(480, 640), crop_hw=(64, 96), out_hw=(96, 128))
# A bf16 output against another of the same model, relative to its max
# |value| (chip_smoke.py's BF16_RANDOM_MAX_REL / BF16_RANDOM_MEAN_REL):
# the baked pipeline rounds its folded convs once where the unbaked one
# rounds the conv and then the BatchNorm.
BF16_MAX_REL, BF16_MEAN_REL = 0.15, 0.03
JAX_ATOL_M = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _TinyDepth(nn.Module):
    """A conv → BN → ReLU → conv stand-in with one foldable pair."""

    CONV_BN = (("conv1", "bn1"),)

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(3, 8, 3, padding=1)
        self.bn1 = BatchNorm(8)
        self.conv2 = Conv(8, 1, 3, padding=1, bias=True)

    def forward(self, x):
        return self.conv2(F.relu(self.bn1(self.conv1(x))))


def _tiny(seed=0):
    return randomize_(_TinyDepth(), seed).eval()


def _frames(batch, hw=IN_HW, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (batch, *hw, 3), dtype=np.uint8))


def _reference_out(model, frames, dtype=torch.bfloat16, bake=False):
    """The live pipeline (the JAX package's ``_reference_out``)."""
    served = _serving_copy(model, "cpu", dtype, bake)
    with torch.inference_mode():
        return pipeline(served, CROP_HW, OUT_HW, dtype)(frames)


def _check_bf16(got, model, frames):
    """A bf16 artifact against the live pipeline: bit for bit the baked
    one's, and within ``BF16_*_REL`` of the unbaked one's."""
    assert torch.equal(got, _reference_out(model, frames, bake=True))
    ref = _reference_out(model, frames)
    err = (got - ref).abs() / ref.abs().max()
    assert err.max() <= BF16_MAX_REL and err.mean() <= BF16_MEAN_REL


def _save(path, model, **kw):
    return save_serving_artifact(
        str(path), model, encoder="tiny", decoder="tiny", in_hw=IN_HW,
        crop_hw=CROP_HW, out_hw=OUT_HW, device="cpu", **kw)


def test_baked_artifact_roundtrip(tmp_path):
    model = _tiny()
    path = tmp_path / "tiny.edz"
    meta = _save(path, model, batch=3)
    assert meta["baked_weights"] and meta["batch"] == 3
    assert meta["device"] == "cpu" and meta["dtype"] == "bfloat16"
    assert meta["format"] == "ede-torch-serving-artifact"
    with zipfile.ZipFile(path) as zf:
        assert sorted(zf.namelist()) == ["meta.json", "program.pt2"]
    fn, meta2 = load_serving_artifact(path)
    assert meta2 == meta
    frames = _frames(3)
    got = fn(frames)
    assert got.shape == (3, *OUT_HW, 1) and got.dtype == torch.float32
    _check_bf16(got, model, frames)
    with pytest.raises(ValueError, match="already baked"):
        load_serving_artifact(path, bake_on_load=True)


def test_arg_weights_artifact_carries_its_own_tree(tmp_path):
    """The no-bake artifact serves the weights it was saved with, and
    another tree of the same architecture when given one."""
    w1, w2 = _tiny(0), _tiny(1)
    path = tmp_path / "tiny_argw.edz"
    meta = _save(path, w1, batch=2, bake_weights=False)
    assert not meta["baked_weights"]
    with zipfile.ZipFile(path) as zf:
        assert "weights.msgpack" in zf.namelist()
    frames = _frames(2)
    want_w1 = _reference_out(w1, frames)
    want_w2 = _reference_out(w2, frames)
    assert (want_w1 - want_w2).abs().max() > 1e-4  # the check means something
    fn, _ = load_serving_artifact(path)
    torch.testing.assert_close(fn(frames), want_w1, rtol=0, atol=1e-6)
    tree2 = to_jax_variables(w2.state_dict())
    swapped, _ = load_serving_artifact(path, weights=tree2)
    torch.testing.assert_close(swapped(frames), want_w2, rtol=0, atol=1e-6)
    baked, _ = load_serving_artifact(path, bake_on_load=True)
    torch.testing.assert_close(baked(frames), want_w1, rtol=0, atol=1e-6)


def test_dynamic_batch_artifact_serves_any_batch(tmp_path):
    model = _tiny()
    path = tmp_path / "tiny_dyn.edz"
    meta = _save(path, model, batch=None)
    assert meta["batch"] is None
    fn, _ = load_serving_artifact(path)
    for b in (1, 4):
        frames = _frames(b)
        got = fn(frames)
        assert got.shape == (b, *OUT_HW, 1)
        _check_bf16(got, model, frames)


def test_f32_export_is_exact(tmp_path):
    """An f32 artifact computes what the live baked pipeline does, bit for
    bit, and the unbaked one within f32 rounding."""
    model = _tiny()
    path = tmp_path / "tiny_f32.edz"
    _save(path, model, batch=2, dtype=None)
    fn, meta = load_serving_artifact(path)
    assert meta["dtype"] is None
    frames = _frames(2)
    got = fn(frames)
    assert torch.equal(got, _reference_out(model, frames, None, bake=True))
    torch.testing.assert_close(got, _reference_out(model, frames, None),
                               rtol=1e-5, atol=1e-6)


def test_rejects_non_artifact(tmp_path):
    bad = tmp_path / "bad.edz"
    with zipfile.ZipFile(bad, "w") as zf:
        zf.writestr("meta.json", "{}")
    with pytest.raises(ValueError, match="Not a serving artifact"):
        load_serving_artifact(bad)


@pytest.fixture(scope="module")
def enb0_artifact(tmp_path_factory):
    """ENB0-HU from its ``.ede``, exported baked in f32 at batch 2."""
    path = tmp_path_factory.mktemp("artifact") / "enb0_hu_f32.edz"
    model = load_any_checkpoint(CHECKPOINT, device="cpu")
    save_serving_artifact(str(path), model, encoder="efficientnet-b0",
                          decoder="hu2018", batch=2, dtype=None,
                          device="cpu", **ENB0_HW)
    return path


def test_enb0_hu_artifact_matches_jax_pipeline(enb0_artifact):
    """The artifact against the JAX package's serving pipeline on the same
    frames and the same ``.ede``, f32, within 1e-4 m."""
    frames = _frames(2, ENB0_HW["in_hw"], seed=1)
    fn, _ = load_serving_artifact(enb0_artifact)
    jmodel, variables = jax_load_any_checkpoint(CHECKPOINT)
    want = np.asarray(jax_export._pipeline(
        jmodel, ENB0_HW["crop_hw"], ENB0_HW["out_hw"], None)(
            variables, jnp.asarray(frames.numpy())))
    got = fn(frames).numpy()
    assert got.shape == want.shape == (2, *ENB0_HW["out_hw"], 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL_M)


class _JaxTiny(jnn.Module):
    @jnn.compact
    def __call__(self, x, train: bool = False):
        return jnn.Conv(1, (3, 3), padding="SAME")(x)


def test_each_package_refuses_the_others_artifact(tmp_path):
    jmodel = _JaxTiny()
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, *CROP_HW, 3)))
    theirs = tmp_path / "jax.edz"
    jax_export.save_serving_artifact(
        theirs, jmodel, variables, encoder="tiny", decoder="tiny", batch=1,
        in_hw=IN_HW, crop_hw=CROP_HW, out_hw=OUT_HW)
    ours = tmp_path / "torch.edz"
    _save(ours, _tiny(), batch=1)
    with pytest.raises(ValueError, match="Not a serving artifact"):
        load_serving_artifact(theirs)
    with pytest.raises(ValueError, match="Not a serving artifact"):
        jax_export.load_serving_artifact(ours)


SERVE_ALONE = r"""
import json, sys
import numpy as np
import torch
from efficientdepthestimation_tpu_torch.checkpoints.export import (
    load_serving_artifact)
fn, meta = load_serving_artifact(sys.argv[1])
out = fn(torch.from_numpy(np.load(sys.argv[2])))
np.save(sys.argv[3], out.numpy())
held = sorted(m for m in sys.modules if m.startswith((
    "efficientdepthestimation_tpu_torch.models",
    "efficientdepthestimation_tpu_torch.apps",
    "efficientdepthestimation_tpu_torch.checkpoints.serialization",
    "efficientdepthestimation_tpu.", "jax")))
print(json.dumps(held))
"""


def test_artifact_serves_without_model_code(enb0_artifact, tmp_path):
    """A fresh interpreter loads and serves the artifact with ``torch`` and
    the kernels' op registrations: no module of the port's models, apps or
    checkpoint reader, nothing of JAX, enters ``sys.modules``."""
    frames = _frames(2, ENB0_HW["in_hw"], seed=2)
    np.save(tmp_path / "frames.npy", frames.numpy())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run(
        [sys.executable, "-c", SERVE_ALONE, str(enb0_artifact),
         str(tmp_path / "frames.npy"), str(tmp_path / "out.npy")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert json.loads(done.stdout.strip().splitlines()[-1]) == []
    fn, _ = load_serving_artifact(enb0_artifact)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  fn(frames).numpy())


def test_export_cli_verify(tmp_path):
    """``apps.export --verify`` on ENB0-HU's ``.ede`` on the CPU, bf16."""
    out = tmp_path / "enb0.edz"
    meta = export_app.main([
        "--model", CHECKPOINT, "--out", str(out), "--batch", "2",
        "--in-hw", *map(str, ENB0_HW["in_hw"]),
        "--crop-hw", *map(str, ENB0_HW["crop_hw"]),
        "--out-hw", *map(str, ENB0_HW["out_hw"]), "--device", "cpu",
        "--verify"])
    assert (meta["encoder"], meta["decoder"]) == ("efficientnet-b0",
                                                  "hu2018")
    assert meta["dtype"] == "bfloat16" and meta["baked_weights"]
    assert meta["verify_max_abs_diff"] < 1e-2
    assert out.exists()
