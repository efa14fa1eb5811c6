"""The PyTorch port's evaluation modules against the JAX package's.

Seeded numpy inputs go through the JAX function and its counterpart in
``efficientdepthestimation_tpu_torch`` on the CPU: ``eval_preprocess``, the
edge metrics, the meters and trackers, the synthetic test pairs, and
ENB0-HU's evaluation from its ``.ede`` against the JAX evaluation fixture
(``tests/make_torch_eval_fixture.py``). Each test states its tolerance.
"""

import contextlib
import io
import math
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from efficientdepthestimation_tpu.data import synthetic_nyu as jsyn
from efficientdepthestimation_tpu.data import transforms as jt
from efficientdepthestimation_tpu.training import metrics as jmetrics

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
)
from efficientdepthestimation_tpu_torch.apps.evaluate import evaluate_dataset
from efficientdepthestimation_tpu_torch.data import synthetic_nyu as psyn
from efficientdepthestimation_tpu_torch.data import transforms as tt
from efficientdepthestimation_tpu_torch.training import metrics as pmetrics
from efficientdepthestimation_tpu_torch.training import train_step as pstep

from make_torch_eval_fixture import (
    CHECKPOINTS,
    EDGE_KEYS,
    FIXTURE_PATH,
    SUM_KEYS,
    TRACKER_KEYS,
)

# The port's ENB0-HU on the CPU against the JAX package's on the CPU, same
# pairs: the depth maps agree to ~1e-5 m, so the depth metrics to 1e-5
# relative (a CPU run of the port over all 60 fixture pairs, both models,
# batch 8 and 1: at most 4.6e-7); δ1-δ3 and the edge averages count pixels
# on either side of a threshold, where one pixel of a 228×304 image is
# 1.4e-5: up to 2 flips an image (the same run: at most 2.4e-7 for δ and
# 2.8e-6 for the edges).
DEPTH_RTOL = 1e-5
COUNT_ATOL = 2 / (228 * 304)
COUNTED = ("delta1", "delta2", "delta3")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two PyTorch intra-op threads a worker: the suite's workers share a
    few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- preprocess


@pytest.mark.parametrize("depth_shape", ["nhw", "nhw1"])
def test_eval_preprocess_matches_jax(depth_shape):
    """Depths: nearest resampling and a division, so exactly JAX's. Images:
    the image half, as ``tests/test_torch_transforms.py`` holds it (one
    uint8 level of the normalized output on at most 0.1% of values, 1e-5
    elsewhere)."""
    rng = np.random.default_rng(21)
    frames = rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    depths = rng.integers(0, 65536, (2, 480, 640), dtype=np.uint16)
    if depth_shape == "nhw1":
        depths = depths[..., None]
    ref_img, ref_dep = jt.eval_preprocess(jnp.asarray(frames),
                                          jnp.asarray(depths))
    img, dep = tt.eval_preprocess(torch.from_numpy(frames),
                                  torch.from_numpy(depths))
    assert dep.dtype == torch.float32 and dep.shape == (2, 228, 304, 1)
    assert np.array_equal(dep.numpy(), np.asarray(ref_dep))
    diff = np.abs(img.numpy() - np.asarray(ref_img))
    assert img.shape == ref_img.shape
    assert diff.max() <= 1.0 / (255 * min(tt.IMAGENET_STD)) + 1e-5
    assert np.mean(diff > 1e-5) <= 1e-3


def test_eval_pairs_match_jax_dataset_convention():
    """A test pair is the JAX writer's 16-bit mm conversion of the scene,
    and the port's train pair its 8-bit one, bit for bit."""
    seed = psyn.TEST_SEED_OFFSET + 3
    rgb, depth_m = jsyn.render_scene(seed, (48, 64))
    ours_rgb, ours_mm = psyn.eval_pair(seed, (48, 64))
    assert np.array_equal(ours_rgb, rgb)
    assert ours_mm.dtype == np.uint16
    assert np.array_equal(ours_mm, np.clip(depth_m * 1000.0, 0, 65535)
                          .astype(np.uint16))
    assert np.array_equal(psyn.train_pair(seed, (48, 64))[1],
                          psyn.depth_png_units(depth_m, is_test=False))


# -------------------------------------------------------------- metrics


def _edge_inputs():
    """Outputs and labels on a grid of 1/8 m (every Sobel sum exact in f32,
    in any order, so both packages find the same edges), batch 4 whose
    last two samples repeat the second, as ``pad_last`` makes them."""
    rng = np.random.default_rng(22)
    out = (np.round(rng.uniform(1, 4, (4, 24, 32, 1)) * 8) / 8)
    lab = (np.round(rng.uniform(1, 4, (4, 24, 32, 1)) * 8) / 8)
    out[2:], lab[2:] = out[1], lab[1]
    return out.astype(np.float32), lab.astype(np.float32)


@pytest.mark.parametrize("num_valid", [None, 2])
def test_edge_metrics_match_jax(num_valid):
    """Per-sample accuracy, precision, recall and F1 summed over the valid
    samples; the same edges, so only the order of 4 additions differs:
    1e-6 relative."""
    out, lab = _edge_inputs()
    ref = jmetrics.edge_metrics_batch(jnp.asarray(out), jnp.asarray(lab),
                                      0.25, num_valid=num_valid)
    ours = pmetrics.edge_metrics_batch(torch.from_numpy(out),
                                       torch.from_numpy(lab), 0.25, num_valid)
    assert set(ours) == set(ref) == set(EDGE_KEYS)
    for k in ref:
        assert 0 < float(ours[k])
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-6,
                                   err_msg=k)
    # (N, H, W) inputs give the same sums.
    flat = pmetrics.edge_metrics_batch(torch.from_numpy(out[..., 0]),
                                       torch.from_numpy(lab[..., 0]), 0.25,
                                       num_valid)
    assert all(float(flat[k]) == float(ours[k]) for k in ours)


def test_edge_metrics_of_a_flat_prediction_are_nan_as_in_jax():
    """A flat prediction of 0 has no edge (a flat non-zero one has, at the
    border, against the Sobel's zero padding): precision 0/0 is NaN and F1
    carries it, also through the mask of a padded duplicate; accuracy and
    recall stay finite (recall 0)."""
    _, lab = _edge_inputs()
    out = np.zeros_like(lab)
    for num_valid in (None, 2):
        ref = jmetrics.edge_metrics_batch(jnp.asarray(out), jnp.asarray(lab),
                                          0.25, num_valid=num_valid)
        ours = pmetrics.edge_metrics_batch(torch.from_numpy(out),
                                           torch.from_numpy(lab), 0.25,
                                           num_valid)
        for k in ("edge_precision", "edge_f1"):
            assert math.isnan(float(ours[k])) and math.isnan(float(ref[k]))
        for k in ("edge_accuracy", "edge_recall"):
            np.testing.assert_allclose(float(ours[k]), float(ref[k]),
                                       rtol=1e-6, err_msg=k)
        assert float(ours["edge_recall"]) == 0.0


def test_sums_to_host_reads_every_sum():
    sums = {"a": torch.tensor(1.5),
            "b": torch.tensor(2.0, dtype=torch.float64),
            "c": torch.tensor(float("nan"))}
    host = pmetrics.sums_to_host(sums)
    assert list(host) == ["a", "b", "c"]
    assert host["a"] == 1.5 and host["b"] == 2.0 and math.isnan(host["c"])
    assert all(isinstance(v, float) for v in host.values())


def test_lambda_meter_matches_jax():
    """min and max over a stream with NaN and inf, which are ignored with
    the reference's warning."""
    stream = [3.0, float("nan"), 1.5, float("inf"), 2.0]
    for fn in (min, max):
        ref, ours = jmetrics.LambdaMeter(fn), pmetrics.LambdaMeter(fn)
        assert math.isnan(ours.value)
        for v in stream:
            ref_warned = not (math.isfinite(v))
            with pytest.warns(UserWarning, match="Invalid value") if \
                    ref_warned else contextlib.nullcontext():
                ours.update(v)
            with pytest.warns(UserWarning) if ref_warned else \
                    contextlib.nullcontext():
                ref.update(v)
            assert ours.value == ref.value
        assert f"{ours:.3f}" == f"{ref:.3f}" and str(ours) == str(ref)


def test_best_metrics_tracker_matches_jax():
    """Best-so-far over three epochs' trackers: least errors, most δ."""
    rng = np.random.default_rng(23)
    ref_best, ours_best = jmetrics.BestMetricsTracker(), \
        pmetrics.BestMetricsTracker()
    for _ in range(3):
        ref, ours = jmetrics.MetricsTracker(), pmetrics.MetricsTracker()
        sums = {k: float(rng.uniform(0, 2)) for k in ref.METRIC_KEYS}
        sums["batch_size"] = 2.0
        ref.update_from_sums(sums)
        ours.update_from_sums(sums)
        ref_best.update(ref)
        ours_best.update(ours)
    assert ours_best.to_dict() == ref_best.to_dict()
    assert list(ours_best.to_dict()) == list(ref_best.to_dict())
    assert ours_best["delta1"].value == ref_best["delta1"].value


def test_metrics_tracker_update_matches_jax():
    """``update(outputs, labels)`` over two batches, one with a NaN label
    and negative outputs (log10 NaN, ignored): f32 sums to 1e-6."""
    rng = np.random.default_rng(24)
    ref, ours = jmetrics.MetricsTracker(), pmetrics.MetricsTracker()
    for i in range(2):
        out = rng.uniform(-0.5 if i else 0.5, 9, (3, 6, 7, 1)).astype(
            np.float32)
        lab = rng.uniform(0.5, 9, (3, 6, 7, 1)).astype(np.float32)
        if i:
            lab[0, 1, 1] = np.nan
        ref.update(jnp.asarray(out), jnp.asarray(lab))
        ours.update(torch.from_numpy(out), torch.from_numpy(lab))
    r, o = ref.to_dict(), ours.to_dict()
    assert list(o) == list(r)
    for k in r:
        np.testing.assert_allclose(o[k], r[k], rtol=1e-6, err_msg=k)


# ----------------------------------------------- ENB0-HU against the fixture


@pytest.fixture(scope="module")
def enb0_hu():
    pairs = [psyn.eval_pair(psyn.TEST_SEED_OFFSET + i) for i in range(4)]
    return load_any_checkpoint(CHECKPOINTS["hu"], device="cpu"), pairs


def _tracker_of(rows) -> dict:
    tracker = pmetrics.MetricsTracker()
    for row in rows:
        tracker.update_from_sums(dict(zip(SUM_KEYS, row)))
    return tracker.to_dict()


def _assert_metrics_close(ours: dict, ref: dict, keys, log10: bool):
    for k in keys:
        if k == "log10" and not log10:
            continue
        if k in COUNTED or k.startswith("edge"):
            assert abs(ours[k] - ref[k]) <= COUNT_ATOL, (k, ours[k], ref[k])
        else:
            np.testing.assert_allclose(ours[k], ref[k], rtol=DEPTH_RTOL,
                                       err_msg=k)


@pytest.mark.parametrize("batch_size", [1, 4])
def test_enb0_hu_evaluation_matches_fixture(enb0_hu, batch_size):
    """``evaluate_dataset`` on the first 4 fixture pairs: the tracker and
    the edge averages against JAX's at the same batch size (batch 1: the
    fixture's first 4 rows; batch 4: one batch of the 4), with
    ``DEPTH_RTOL`` and ``COUNT_ATOL``."""
    model, pairs = enb0_hu
    fx = np.load(FIXTURE_PATH)
    key = "hu/b1" if batch_size == 1 else "hu/b4first4"
    rows = fx[f"{key}/sums"][:4]
    ref = _tracker_of(rows)
    ref_edges = dict(zip(EDGE_KEYS, fx[f"{key}/edge_sums"][:4].sum(0) / 4))
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        tracker, edges = evaluate_dataset(model, pairs, batch_size,
                                          device="cpu")
    assert "Progress: [04/04]" in printed.getvalue()
    _assert_metrics_close(tracker.to_dict(), ref, TRACKER_KEYS, log10=True)
    _assert_metrics_close(edges, ref_edges, EDGE_KEYS, log10=True)


def test_enb0_hu_eval_step_matches_fixture(enb0_hu):
    """``make_eval_step`` per batch of 1: each batch's sums against the
    fixture's row, with ``DEPTH_RTOL`` and ``COUNT_ATOL``; the output is
    the upsampled depth at the label size."""
    model, pairs = enb0_hu
    fx = np.load(FIXTURE_PATH)
    step = pstep.make_eval_step(device="cpu")
    for i, (rgb, depth) in enumerate(pairs):
        images, depths = tt.eval_preprocess(torch.from_numpy(rgb[None]),
                                            torch.from_numpy(depth[None]))
        sums, out = step(model, images, depths, 1)
        assert out.shape == (1, 228, 304, 1)
        assert all(isinstance(v, float) for v in sums.values())
        ref = dict(zip(SUM_KEYS, fx["hu/b1/sums"][i]))
        assert sums["batch_size"] == ref["batch_size"] == 1.0
        _assert_metrics_close(sums, ref, SUM_KEYS[:-1], log10=True)


def test_fixture_holds_metric_values_only():
    """60 pairs: 7 full batches of 8 and a padded tail of 4, or 60 of 1;
    a few KB."""
    fx = np.load(FIXTURE_PATH)
    for m in ("hu", "lr"):
        assert fx[f"{m}/b8/sums"].shape == (8, len(SUM_KEYS))
        assert fx[f"{m}/b1/sums"].shape == (60, len(SUM_KEYS))
        assert fx[f"{m}/b8/sums"][-1, -1] == 4.0
        assert fx[f"{m}/b8/tracker"].shape == (len(TRACKER_KEYS),)
        assert fx[f"{m}/b1/edge"].shape == (len(EDGE_KEYS),)
    assert os.path.getsize(FIXTURE_PATH) < 64 * 1024


def test_timer_and_async_writer(tmp_path):
    """``Timer`` and ``device_timer`` time as the JAX package's do (a
    CPU tensor needs no wait); ``AsyncImageWriter`` writes 8-bit RGB and
    16-bit PNGs that read back bit for bit."""
    from PIL import Image

    from efficientdepthestimation_tpu.utils import timer as jtimer
    from efficientdepthestimation_tpu_torch.utils import timer
    from efficientdepthestimation_tpu_torch.utils.async_writer import (
        AsyncImageWriter,
    )

    with timer.Timer() as t, jtimer.Timer() as jt_:
        pass
    assert t.elapsed.total_seconds() >= 0 and t.stop_time is not None
    assert type(t.elapsed) is type(jt_.elapsed)
    with timer.device_timer([torch.ones(2)]) as dt:
        pass
    assert dt.stop_time is not None
    image = np.random.default_rng(25).integers(0, 256, (6, 8, 3),
                                               dtype=np.uint8)
    depth = np.arange(48, dtype=np.uint16).reshape(6, 8) * 1000
    with AsyncImageWriter(num_workers=2) as writer:
        writer.submit(image, str(tmp_path / "a.png"))
        writer.submit(depth, str(tmp_path / "d.png"))
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a.png")), image)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "d.png")), depth)
