"""The PyTorch port's eval step, eval epoch and CLIs against the JAX
package's, on one PNG/CSV workspace on the CPU.

The workspace is ``tests/test_apps.py``'s: a resnet18-HU with the JAX
package's random init, written by its ``save_checkpoint`` (and, for
``evaluate``, as a reference ``.pth``) and read by the port, here with 3
distinct 480×640 pairs (uint8 RGB, 16-bit mm depth) so that batch 2 pads
its tail, and a directory of 3 frames. Each CLI runs in
both packages, the port's with ``--device cpu``.
"""

import contextlib
import io
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from efficientdepthestimation_tpu.checkpoints.serialization import (
    save_checkpoint,
)
from efficientdepthestimation_tpu.models import build_model

from efficientdepthestimation_tpu_torch.apps import common as pcommon
from efficientdepthestimation_tpu_torch.apps import train as ptrain
from efficientdepthestimation_tpu_torch.data import datasets as pdata
from efficientdepthestimation_tpu_torch.training import train_step as pstep

# Port against JAX on the CPU, the same random resnet18-HU: depth maps to
# ~1e-6, so depth metrics to 1e-5 relative; δ and edge counts flip with a
# value within rounding of a threshold, one pixel of a 228×304 label being
# 1.4e-5: 2 pixels an image.
DEPTH_RTOL = 1e-5
COUNT_ATOL = 2 / (228 * 304)
N_PAIRS, BATCH = 3, 2
# test_nyu's JPG previews: depths within 1 mm of JAX's may give preview
# pixels one level apart (1 mm is 0.0255 of a level) at a few pixels. In
# JPEG such a change can round a quantized DCT coefficient of its 8×8 block
# to the next step, at most 24 at quality 90 (the tables run 2..24), which
# moves a decoded pixel by at most 24/4 = 6 levels. The mean stays near 0.
PREVIEW_ATOL, PREVIEW_MEAN = 6, 0.01


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A resnet18-HU checkpoint, a test CSV of 3 pairs, a frames dir."""
    from PIL import Image

    root = tmp_path_factory.mktemp("torch_apps")
    rng = np.random.default_rng(0)
    model = build_model("resnet18", "hu2018")
    # The parameter shapes do not depend on the input's size.
    variables = model.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((1, 64, 96, 3)))
    ckpt_dir = root / "checkpoints"
    ckpt_dir.mkdir()
    ckpt = str(ckpt_dir / "RN18-HU.ede")
    save_checkpoint(ckpt, jax.tree_util.tree_map(np.asarray, variables),
                    encoder="resnet18", decoder="hu2018")
    frames = root / "frames"
    frames.mkdir()
    (root / "data").mkdir()
    rows = []
    for i in range(N_PAIRS):
        image = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
        depth16 = rng.integers(500, 9000, (480, 640), dtype=np.uint16)
        Image.fromarray(image).save(root / "data" / f"rgb{i}.png")
        Image.fromarray(depth16).save(root / "data" / f"d{i}.png")
        Image.fromarray(image).save(frames / f"{i:03d}.png")
        rows.append(f"data/rgb{i}.png,data/d{i}.png\n")
    csv = root / "test.csv"  # paths relative to the CSV's directory
    csv.write_text("".join(rows))
    return dict(root=root, ckpt=ckpt, ckpt_dir=str(ckpt_dir), csv=str(csv),
                frames=str(frames))


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _assert_metrics_close(ours: dict, ref: dict):
    """A random-init model may predict a flat map, whose edge precision
    and F1 are NaN (0/0) in both packages."""
    assert list(ours) == list(ref)
    for k, v in ref.items():
        if np.isnan(v):
            assert np.isnan(ours[k]), (k, ours[k])
        elif k.startswith(("delta", "edge")):
            assert abs(ours[k] - v) <= COUNT_ATOL, (k, ours[k], v)
        else:
            np.testing.assert_allclose(ours[k], v, rtol=DEPTH_RTOL, err_msg=k)


def test_datasets_match_jax(workspace):
    """The same rows (relative paths resolved against the CSV's directory)
    and the same decoded arrays, 16-bit depths included; frames sorted."""
    from efficientdepthestimation_tpu.data import datasets as jdata

    ref = jdata.DepthPairDataset(workspace["csv"], is_test=True,
                                 use_native=False)
    ours = pdata.DepthPairDataset(workspace["csv"], is_test=True,
                                  cache_in_ram=True)
    assert ours.rows == ref.rows and len(ours) == N_PAIRS
    for i in range(N_PAIRS):
        (a, b), (c, d) = ours[i], ref[i]
        assert a.dtype == c.dtype and np.array_equal(a, c)
        assert b.dtype == d.dtype == np.uint16 and np.array_equal(b, d)
    assert ours[0] is ours[0]  # served from the cache
    jf = jdata.VideoFrameDataset(workspace["frames"])
    pf = pdata.VideoFrameDataset(workspace["frames"])
    assert pf.files == jf.files
    assert np.array_equal(pf[1], jf[1])


def test_infer_arch_from_path_matches_jax():
    from efficientdepthestimation_tpu.apps.common import infer_arch_from_path

    for path in ("ckpt/ENB0-HU.pth", "/x/RN50-LR.ede", "demo_resnet.pth",
                 "efficientnet-b0_lasinger.pth", "my-efficientnet-lr.pth",
                 "densenet.ede", "senet154_model.pth", "model_resnet"):
        assert pcommon.infer_arch_from_path(path) == \
            infer_arch_from_path(path), path
    for bad in ("model.pth", "weights.ede"):
        with pytest.raises(ValueError):
            pcommon.infer_arch_from_path(bad)
        with pytest.raises(ValueError):
            infer_arch_from_path(bad)


def test_eval_step_and_epoch_match_jax(workspace):
    """``make_eval_step`` on a padded batch of 2 (num_valid 1), then
    ``run_eval_epoch`` over the 3 pairs at batch 2, against the JAX
    package's ``make_eval_step`` and ``run_eval_epoch``."""
    from efficientdepthestimation_tpu.apps import train as jtrain
    from efficientdepthestimation_tpu.apps.common import load_any_checkpoint
    from efficientdepthestimation_tpu.data import datasets as jdata
    from efficientdepthestimation_tpu.data.transforms import eval_preprocess
    from efficientdepthestimation_tpu.training.train_step import (
        TrainState,
        make_eval_step,
    )

    jmodel, variables = load_any_checkpoint(workspace["ckpt"])
    jstate = TrainState(step=0, params=variables["params"],
                        batch_stats=variables["batch_stats"], opt_state=None,
                        apply_fn=jmodel.apply, tx=None)
    jstep = make_eval_step()
    model = pcommon.load_any_checkpoint(workspace["ckpt"], device="cpu")
    state = pstep.create_train_state(model, 1e-4)
    step = pstep.make_eval_step(device="cpu")

    data = pdata.DepthPairDataset(workspace["csv"], is_test=True)
    rgb, depth = data[2]
    rgb, depth = np.stack([rgb, rgb]), np.stack([depth, depth])
    images, depths = eval_preprocess(jnp.asarray(rgb), jnp.asarray(depth))
    ref, ref_out = jstep(jstate, images, depths, jnp.asarray(1, jnp.int32))
    ours, out = step(state, torch.from_numpy(np.array(images)),
                     torch.from_numpy(np.array(depths)), 1)
    assert ours["batch_size"] == float(ref["batch_size"]) == 1.0
    _assert_metrics_close({k: ours[k] for k in ref},
                          {k: float(v) for k, v in ref.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-4,
                               atol=1e-5)

    ref_tracker = _quiet(jtrain.run_eval_epoch, jstate, jstep,
                         jdata.DepthPairDataset(workspace["csv"],
                                                is_test=True), BATCH, None,
                         None)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        tracker = ptrain.run_eval_epoch(state, step, data, BATCH,
                                        device="cpu")
    assert "Val [00003/00003]" in printed.getvalue()
    _assert_metrics_close(tracker.to_dict(), ref_tracker.to_dict())


def test_evaluate_cli_matches_jax(workspace):
    """``apps.evaluate`` at batch 2 over 3 pairs (a padded tail): the
    tracker and the edge averages, and the printed AV/PV/RV/FV lines."""
    from efficientdepthestimation_tpu.apps import evaluate as jevaluate
    from efficientdepthestimation_tpu_torch.apps import evaluate

    argv = ["--model", workspace["ckpt"], "--test-csv", workspace["csv"],
            "--batch-size", str(BATCH)]
    ref_tracker, ref_edges = _quiet(jevaluate.main, argv)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        tracker, edges = evaluate.main(argv + ["--device", "cpu"])
    _assert_metrics_close(tracker.to_dict(), ref_tracker.to_dict())
    _assert_metrics_close(edges, ref_edges)
    lines = printed.getvalue().splitlines()
    assert [ln.split()[0] for ln in lines[-4:]] == ["AV", "PV", "RV", "FV"]
    assert "Progress: [03/03]" in printed.getvalue()


def test_evaluate_cli_on_pth_matches_jax(workspace, tmp_path):
    """``apps.evaluate`` of the workspace's model as a reference ``.pth``
    (a raw ``state_dict`` under ``module.``, written by the JAX package's
    ``state_dict_from_variables``) in both packages, at batch 2."""
    from efficientdepthestimation_tpu.apps import evaluate as jevaluate
    from efficientdepthestimation_tpu.checkpoints.pth_import import (
        state_dict_from_variables,
    )
    from efficientdepthestimation_tpu.checkpoints.serialization import (
        load_checkpoint,
    )
    from efficientdepthestimation_tpu_torch.apps import evaluate

    jmodel, variables, _ = load_checkpoint(workspace["ckpt"])
    sd = state_dict_from_variables(jmodel, jax.tree_util.tree_map(
        np.asarray, variables))
    pth = str(tmp_path / "RN18-HU.pth")
    torch.save({f"module.{k}": torch.from_numpy(np.array(v))
                for k, v in sd.items()}, pth)
    argv = ["--model", pth, "--test-csv", workspace["csv"], "--batch-size",
            str(BATCH)]
    ref_tracker, ref_edges = _quiet(jevaluate.main, argv)
    tracker, edges = _quiet(evaluate.main, argv + ["--device", "cpu"])
    _assert_metrics_close(tracker.to_dict(), ref_tracker.to_dict())
    _assert_metrics_close(edges, ref_edges)


class _Built(Exception):
    pass


def _serving_kwargs(app, argv) -> dict:
    """The keywords ``app.main(argv)`` passes to ``make_serving_fn``; the
    run stops there."""
    seen = {}

    def spy(model, **kw):
        seen.update(kw)
        raise _Built

    saved, app.make_serving_fn = app.make_serving_fn, spy
    try:
        with pytest.raises(_Built):
            _quiet(app.main, argv)
    finally:
        app.make_serving_fn = saved
    return seen


def test_test_nyu_cli_matches_jax(workspace, tmp_path):
    """``apps.test_nyu`` at batch 2: the same files, 16-bit depth PNGs
    equal within 1 mm (a value within rounding of an integer mm may
    truncate to the other side), and JPG previews written as the JAX
    package writes them (libjpeg at quality 90: its quantization tables)
    whose pixels agree within PREVIEW_ATOL."""
    from PIL import Image

    from efficientdepthestimation_tpu.apps import test_nyu as jtest_nyu
    from efficientdepthestimation_tpu_torch.apps import test_nyu

    argv = ["-c", workspace["ckpt_dir"], "--test-csv", workspace["csv"],
            "-b", str(BATCH)]
    _quiet(jtest_nyu.main, argv + ["-o", str(tmp_path / "jax")])
    _quiet(test_nyu.main, argv + ["-o", str(tmp_path / "port"), "--device",
                                  "cpu"])
    ref_dir, our_dir = tmp_path / "jax" / "RN18-HU", tmp_path / "port" / \
        "RN18-HU"
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(our_dir)) == [
        f"{i:04d}.{ext}" for i in range(N_PAIRS) for ext in ("jpg", "png")]
    for name in names[1::2]:
        ref = np.asarray(Image.open(ref_dir / name)).astype(np.int64)
        ours = np.asarray(Image.open(our_dir / name))
        assert ours.shape == (480, 640) and ours.max() > 0
        assert np.abs(ours.astype(np.int64) - ref).max() <= 1, name
    for name in names[::2]:
        with Image.open(ref_dir / name) as a, Image.open(our_dir / name) as b:
            assert b.format == a.format == "JPEG"
            assert b.quantization == a.quantization, name
            ref, ours = np.asarray(a).astype(np.int64), np.asarray(b)
        assert ours.shape == (480, 640)
        err = np.abs(ours - ref)
        assert err.max() <= PREVIEW_ATOL and err.mean() <= PREVIEW_MEAN, (
            name, err.max(), err.mean())
    # --policy reaches the serving fn with the batch as its hint (served
    # end to end in test_torch_autotune.py)
    kw = _serving_kwargs(test_nyu, argv + ["-o", str(tmp_path / "x"),
                                           "--policy", "p.json", "--device",
                                           "cpu"])
    assert kw["policy_path"] == "p.json" and kw["batch_hint"] == BATCH


def test_inference_benchmark_cli_matches_jax(workspace, tmp_path):
    """``apps.inference_benchmark`` with 2 trials at batch 2: the same
    models, columns and memory source (``static`` on the CPU, as JAX
    reports there), memory > 0, and its two files."""
    from efficientdepthestimation_tpu.apps import (
        inference_benchmark as jbench,
    )
    from efficientdepthestimation_tpu_torch.apps import inference_benchmark

    argv = ["-c", workspace["ckpt_dir"], "-f", workspace["frames"], "-n", "2",
            "-b", str(BATCH)]
    ref = _quiet(jbench.main, argv + ["-o", str(tmp_path / "jax")])
    out_dir = tmp_path / "port"
    ours = _quiet(inference_benchmark.main,
                  argv + ["-o", str(out_dir), "--device", "cpu"])
    assert list(ours) == list(ref.index) == ["RN18-HU"]
    entry = ours["RN18-HU"]
    assert list(entry) == list(ref.columns)
    assert entry[("memory_source", "first")] == \
        ref[("memory_source", "first")].iloc[0] == "static"
    assert entry[("memory_usage", "mean")] > 0
    assert all(entry[(f, "mean")] > 0 for f in inference_benchmark.TIMES)
    assert all(np.isfinite(entry[(f, "std")])
               for f in inference_benchmark.TIMES)
    csv_lines = (out_dir / "inference_benchmark.csv").read_text().splitlines()
    assert csv_lines[0].split(",")[:3] == ["model", "load_time_mean",
                                          "load_time_std"]
    assert csv_lines[1].startswith("RN18-HU,") and len(csv_lines) == 2
    assert "RN18-HU" in (out_dir / "inference_benchmark.tex").read_text()
    # a world of one serves the whole batch through the mesh path
    dp = _quiet(inference_benchmark.main,
                argv + ["-o", str(tmp_path / "dp"), "--device", "cpu",
                        "--data-parallel"])
    assert list(dp) == ["RN18-HU"] and list(dp["RN18-HU"]) == list(entry)
    with pytest.raises(NotImplementedError, match="A11b"):
        inference_benchmark.main(argv + ["--spatial", "--device", "cpu"])
    kw = _serving_kwargs(inference_benchmark, argv + [
        "-o", str(tmp_path / "policy"), "--policy", "p.json", "--dw-impl",
        "xla", "--device", "cpu"])
    assert (kw["policy_path"], kw["batch_hint"], kw["dw_impl"]) == (
        "p.json", BATCH, "xla")


def test_summary_statistics_match_pandas():
    """mean and std with ddof 1 per model, NaN std for one trial, the first
    memory source: what the JAX package's pandas ``groupby().agg`` gives."""
    import pandas as pd

    from efficientdepthestimation_tpu_torch.apps import inference_benchmark

    rng = np.random.default_rng(5)
    rows = [dict(model=m, trial=t, memory_source=s,
                 **{f: float(rng.uniform(0, 3))
                    for f in inference_benchmark.TIMES})
            for m, n, s in (("B", 3, "live"), ("A", 1, "static"))
            for t in range(n)]
    ref = pd.DataFrame(rows).groupby("model").agg(
        {**{f: ["mean", "std"] for f in inference_benchmark.TIMES},
         "memory_source": ["first"]})
    ours = inference_benchmark.summarize(rows)
    assert sorted(ours) == list(ref.index)
    for model, entry in ours.items():
        assert list(entry) == list(ref.columns)
        for col, value in entry.items():
            want = ref.loc[model, col]
            if isinstance(value, str):
                assert value == want
            elif np.isnan(want):
                assert np.isnan(value)
            else:
                np.testing.assert_allclose(value, want, rtol=1e-12)


def test_synthetic_dataset_writer_matches_jax(tmp_path):
    """``generate_dataset`` at 48×64: the same CSV rows (under each root)
    and the same PNG contents, 8-bit train and 16-bit test depths."""
    from PIL import Image

    from efficientdepthestimation_tpu.data import synthetic_nyu as jsyn
    from efficientdepthestimation_tpu_torch.data import synthetic_nyu as psyn

    ref = jsyn.generate_dataset(str(tmp_path / "j"), 2, 2, (48, 64), seed=3)
    ours = psyn.generate_dataset(str(tmp_path / "p"), 2, 2, (48, 64), seed=3)
    for r, o in zip(ref, ours):
        ref_rows = open(r).read().replace(str(tmp_path / "j"), "")
        our_rows = open(o).read().replace(str(tmp_path / "p"), "")
        assert our_rows == ref_rows
        for line in open(o).read().split():
            for path in line.split(","):
                twin = path.replace(str(tmp_path / "p"), str(tmp_path / "j"))
                a, b = Image.open(path), Image.open(twin)
                assert a.mode == b.mode
                assert np.array_equal(np.asarray(a), np.asarray(b))
