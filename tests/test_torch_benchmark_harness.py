"""The port's benchmark depth models and harness against the JAX package's,
on the CPU.

Depth models: ENB0-HU and ENB0-LR from ``e2e/*.ede`` through each
package's wrapper on the same 2 images at 224×320 (the benchmark's
``nyu_eval_sample(32)`` size) in f32, within 1e-3 m, the tolerance of the
earlier slices' forwards (a CPU run of the port matches to ~1e-5).

``main``: the flat baseline at fps 2 on 2 rendered NYU-like pairs, run by
both packages. The depth metric columns of ``nyu.csv`` agree within 1e-5
relative (measured ≤ 1.8e-6: the same f32 sums in another order). The
visual columns (SSIM, PSNR, MIFD) are computed on the stills each package
renders, which agree within one grey level on ≥ 0.9999 of their pixels
(``tests/test_torch_renderer.py``) but not everywhere: within 5e-5 relative
(measured ≤ 9.3e-6, SSIM). MIFD is within 1e-2: its FLANN matcher
draws randomized kd-trees from the C library's ``rand()``, so one
package's MIFD of one pair of stills moves by 0.37% from ``srand(1)`` to
``srand(0)``, and the two packages' by 8e-6 from ``srand(1)`` (the state
both runs start from) and 6.5e-3 from ``srand(0)``. ``nyu-relative.csv``
holds ratios of differences, so there the same figures bound the
absolute error.
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from efficientdepthestimation_tpu.benchmark import depth_model as jdm
from efficientdepthestimation_tpu.benchmark import harness as jharness
from efficientdepthestimation_tpu.data.synthetic_nyu import (
    generate_dataset,
    render_scene,
)
from efficientdepthestimation_tpu_torch.benchmark import depth_model, harness
from efficientdepthestimation_tpu_torch.benchmark.datasets import (
    DepthDataset,
    nyu_eval_sample,
)
from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    from_jax_variables,
)
from efficientdepthestimation_tpu_torch.models.registry import build_model

from test_torch_benchmark import seed_c_rand

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HU = os.path.join(ROOT, "e2e", "ENB0-HU-synthetic.ede")
LR = os.path.join(ROOT, "e2e", "ENB0-LR-synthetic.ede")
DEPTH_ATOL = 1e-3  # metres
DEPTH_COLUMNS = ["mae", "mse", "abs_rel", "delta1", "delta2", "delta3", "rmse"]
VISUAL_COLUMNS = ["ssim", "psnr", "lpips"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs its files in parallel workers,
    where torch's default of one thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(hw=(224, 320)) -> np.ndarray:
    return np.stack([render_scene(s, hw)[0] for s in (11, 12)]).astype(
        np.float32) / 255.0


@pytest.mark.parametrize("kind", ["hu", "lr"])
def test_depth_models_match_jax(kind, tmp_path):
    if kind == "hu":
        ours = depth_model.ReSIDEModel(HU, encoder="efficientnet-b0",
                                       device="cpu")
        ref = jdm.ReSIDEModel(HU, encoder="efficientnet-b0")
    else:
        ours = depth_model.MidasModel(LR, device="cpu")
        ref = jdm.MidasModel(LR)
    images = _images()
    got = ours(torch.from_numpy(images))
    want = np.asarray(ref(jnp.asarray(images)))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DEPTH_ATOL)
    # leading dims flattened and restored, served in tiles, scaled
    ours._tile = 1
    meta = {"scales": np.array([[[2.0], [0.5]]], np.float32)}
    tiled = ours(torch.from_numpy(images[None]), meta)
    np.testing.assert_allclose(
        tiled.numpy(), np.asarray(ref(jnp.asarray(images[None]), meta)),
        rtol=0, atol=2 * DEPTH_ATOL)
    # save: the reference .pth under JAX's keys
    ours.save(str(tmp_path / "ours.pth"))
    ref.save(str(tmp_path / "ref.pth"))
    a = torch.load(tmp_path / "ours.pth", weights_only=False)
    b = torch.load(tmp_path / "ref.pth", weights_only=False)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key].numpy(), b[key].numpy())


def test_random_weight_model_carries_jax_init():
    """A random-weight ReSIDE model (chapter 4's ``pretrained=False``
    entry): JAX's ``init_variables`` carried across serve the same depth;
    the port's own draws seeded weights."""
    from efficientdepthestimation_tpu.apps.common import init_variables
    from efficientdepthestimation_tpu.models import build_model as jbuild

    jm = jbuild("efficientnet-b0", "hu2018")
    # jitted, as flax's init runs slowly op by op; the same draws
    variables = jax.jit(lambda: init_variables(jm, (64, 96)))()
    ref = jdm.ReSIDEModel(model=jm, variables=variables)
    model = build_model("efficientnet-b0", "hu2018")
    model.load_state_dict(from_jax_variables(_numpy(ref.variables)))
    ours = depth_model.ReSIDEModel(model=model, device="cpu")
    images = _images((64, 96))
    got = ours(torch.from_numpy(images)).numpy()
    want = np.asarray(ref(jnp.asarray(images)))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    seeded = [depth_model.ReSIDEModel(encoder="efficientnet-b0",
                                      pretrained=False, device="cpu")
              for _ in range(2)]
    np.testing.assert_array_equal(*(m(torch.from_numpy(images)).numpy()
                                    for m in seeded))


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def test_flat_estimator():
    images = np.zeros((2, 3, 8, 10, 3), np.float32)
    flat = depth_model.FlatDepthEstimator()
    out = flat(torch.from_numpy(images), {"scales": np.ones((2, 3, 1))})
    want = np.asarray(jdm.FlatDepthEstimator()(jnp.asarray(images)))
    assert out.shape == want.shape == (2, 3, 8, 10)
    assert out.dtype == torch.float32 and not out.any()
    with pytest.raises(NotImplementedError):
        flat.save("unused.pth")


def test_preset_tables_match_jax():
    args = argparse.Namespace(
        preset="chapter3", device="cpu",
        reside_enb0_path="ENB0-HU.pth", reside_enb4_path="ENB4-HU.pth",
        reside_resnet50_path="RN50-HU.pth", reside_senet_path="SENET-HU.pth",
        midas_enb0_path="ENB0-LR.pth", midas_enb4_path="ENB4-LR.pth",
        midas_resnet50_path="RN50-LR.pth")
    for preset in ("chapter3", "chapter4", None):
        args.preset = preset
        ours = harness.preset_model_loaders(args, data="d")
        ref = jharness.preset_model_loaders(args, data="d")
        assert [(n, d) for n, _, d in ours] == [(n, d) for n, _, d in ref]
    assert [n for n, _, _ in ours] == []
    args.preset = "chapter4"
    names = [n for n, _, _ in harness.preset_model_loaders(args, None)]
    assert names == ["reside_enb0", "reside_senet",
                     "reside_enb0-random_weights", "flat"]


@pytest.fixture(scope="module")
def nyu_pairs(tmp_path_factory):
    """2 rendered test pairs of ``generate_dataset`` (480×640 RGB, 16-bit mm
    depth) and the NYU ``camera.json``."""
    root = tmp_path_factory.mktemp("nyu")
    _, test_csv = generate_dataset(str(root), n_train=0, n_test=2)
    (root / "camera.json").write_text(json.dumps(
        {"width": 640, "height": 480, "fx": 525.0, "fy": 525.0,
         "cx": 320.0, "cy": 240.0}))
    return test_csv


def _tex_rows(path: str) -> dict[str, list[str]]:
    lines = open(path).read().splitlines()
    body = lines[lines.index("\\midrule") + 1:lines.index("\\bottomrule")]
    header = [c.strip() for c in lines[2].rstrip(" \\").split("&")]
    return {"": header} | {r.split(" & ")[0]: r.rstrip(" \\").split(" & ")
                           for r in body}


def test_main_matches_jax(nyu_pairs, tmp_path, capsys):
    argv = ["--csv-path", nyu_pairs, "--batch-size", "2",
            "--renderer-fps", "2", "--baseline-model", "flat"]
    seed_c_rand()
    ours = harness.main(argv + ["--output-path", str(tmp_path / "ours"),
                                "--device", "cpu"])
    seed_c_rand()
    ref = jharness.main(argv + ["--output-path", str(tmp_path / "ref")])
    assert list(ours["nyu"]) == list(ref["nyu"]) == ["random", "flat"]
    for name in ours["nyu"]:
        assert list(ours["nyu"][name]) == list(ref["nyu"][name])

    listing = {}
    for side in ("ours", "ref"):
        root = tmp_path / side
        listing[side] = sorted(os.path.relpath(os.path.join(d, f), root)
                               for d, _, fs in os.walk(root) for f in fs)
    assert listing["ours"] == listing["ref"]
    for name in ("plots/ssim.png", "plots/frame_time.png", "nyu-relative.tex",
                 "nyu/nyu-depth.png", "nyu/nyu-rendered_images.png"):
        assert name in listing["ours"]

    for table in ("nyu", "nyu-relative"):
        a = pd.read_csv(tmp_path / "ours" / f"{table}.csv", index_col=0)
        b = pd.read_csv(tmp_path / "ref" / f"{table}.csv", index_col=0)
        assert list(a.index) == list(b.index)
        assert list(a.columns) == list(b.columns)
        assert "log10" not in a.columns
        # relative values are ratios of differences: their error is
        # absolute, the absolute table's relative one
        atol = 0.0 if table == "nyu" else 1.0
        for cols, tol in ((DEPTH_COLUMNS, 1e-5), (VISUAL_COLUMNS, 5e-5),
                          (["mifd"], 1e-2)):
            np.testing.assert_allclose(a[cols].to_numpy(), b[cols].to_numpy(),
                                       rtol=tol, atol=atol * tol)
        ta = _tex_rows(str(tmp_path / "ours" / f"{table}.tex"))
        tb = _tex_rows(str(tmp_path / "ref" / f"{table}.tex"))
        assert list(ta) == list(tb) and ta[""] == tb[""]
        keep = [i for i, c in enumerate(ta[""])
                if c in DEPTH_COLUMNS + ["ssim", "lpips"]]
        for row in ta:
            assert [ta[row][i] for i in keep] == [tb[row][i] for i in keep]

    meta = json.load(open(tmp_path / "ours/nyu/flat/depth/metadata.json"))
    assert meta["peak_memory_source"] == "static"
    assert set(meta) == set(json.load(open(
        tmp_path / "ref/nyu/flat/depth/metadata.json")))

    capsys.readouterr()
    again = harness.main(argv + ["--output-path", str(tmp_path / "ours"),
                                 "--device", "cpu"])
    assert capsys.readouterr().out.count("Found cached results") == 9
    for name, row in ours["nyu"].items():
        for key in DEPTH_COLUMNS + ["ssim", "psnr"]:
            assert again["nyu"][name][key] == row[key]


def test_sample_output_matches_jax(nyu_pairs, tmp_path):
    from efficientdepthestimation_tpu.benchmark.datasets import (
        DepthDataset as JDepthDataset,
        nyu_eval_sample as jnyu_eval_sample,
    )

    model = depth_model.MidasModel(LR, device="cpu")
    ds = DepthDataset(nyu_pairs, transform=nyu_eval_sample(32))
    got = harness.get_sample_output(model, ds, num_samples=2, device="cpu")
    want = jharness.get_sample_output(
        jdm.MidasModel(LR), JDepthDataset(nyu_pairs,
                                          transform=jnyu_eval_sample(32)),
        num_samples=2)
    assert got.shape == want.shape == (2, 224, 320, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    harness.save_sample_output(model, "midas", ds, str(tmp_path), 2,
                               device="cpu")
    assert sorted(os.listdir(tmp_path / "midas" / "depth")) == ["00.png",
                                                                "01.png"]


def test_reports_match_pandas(tmp_path):
    """The ``csv``-module tables against JAX's pandas ones on rows with
    NaN, a zero baseline (inf and NaN relative values) and columns first
    seen in a later row."""
    results = {"nyu": {
        "random": {"mae": 1.5, "log10": 0.2, "ssim": 0.5, "lpips": np.nan},
        "flat": {"mae": 2.0, "log10": np.nan, "ssim": 0.0, "lpips": np.nan,
                 "peak_memory_usage": 0.0, "frame_time": 0.25},
        "model": {"mae": 0.25, "ssim": 0.75, "frame_time": 0.125,
                  "peak_memory_usage": 1.5, "render_time": 3.0}}}
    for side, mod in (("ours", harness), ("ref", jharness)):
        os.makedirs(tmp_path / side)
        mod.save_benchmark_results(str(tmp_path / side), results,
                                   relative_to="flat")
    for table in ("nyu", "nyu-relative"):
        a = pd.read_csv(tmp_path / "ours" / f"{table}.csv", index_col=0)
        b = pd.read_csv(tmp_path / "ref" / f"{table}.csv", index_col=0)
        pd.testing.assert_frame_equal(a, b)
        assert open(tmp_path / "ours" / f"{table}.tex").read() == \
            open(tmp_path / "ref" / f"{table}.tex").read()
    os.makedirs(tmp_path / "plots")
    harness.visualise_results(str(tmp_path / "plots"),
                              str(tmp_path / "ours" / "nyu.csv"),
                              str(tmp_path / "ours" / "nyu-relative.csv"),
                              "flat")
    assert sorted(os.listdir(tmp_path / "plots")) == [
        "frame_time.png", "memory_usage.png", "ssim.png"]
