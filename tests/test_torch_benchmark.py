"""The port's benchmark metrics, LPIPS, datasets, noise and ``.raw`` I/O
against the JAX package's, on the CPU, on the same seeded inputs.

Tolerances: SSIM and PSNR are the same f32 formulas over convolutions that
sum their 121 taps, and means that sum their terms, in another order, so
1e-6 absolute plus 1e-6 relative; LPIPS-AlexNet adds five convolutions of
random weights, rtol 1e-4 (the tolerance ``tests/test_lpips_convert.py``
holds the JAX network to against torch); host-side code (datasets, noise,
``.raw``, the converter) is the same numpy, bit for bit.
"""

import ctypes
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from efficientdepthestimation_tpu.benchmark import datasets as jdatasets
from efficientdepthestimation_tpu.benchmark import metrics as jmetrics
from efficientdepthestimation_tpu.benchmark import noise as jnoise
from efficientdepthestimation_tpu.checkpoints import lpips_convert as jconvert
from efficientdepthestimation_tpu.utils import image_io as jimage_io
from efficientdepthestimation_tpu_torch.benchmark import datasets, metrics, noise
from efficientdepthestimation_tpu_torch.checkpoints import lpips_convert
from efficientdepthestimation_tpu_torch.utils import image_io

_ALEX = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3),
         (256, 256, 3)]  # (cin, cout, kernel) of torchvision's feature convs
_FEATURE_IDX = [0, 3, 6, 8, 10]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs its files in parallel workers,
    where torch's default of one thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def seed_c_rand() -> None:
    """MIFD's FLANN matcher draws its randomized kd-trees from the C
    library's ``rand()``, whose state earlier work in the process moves;
    each side of a comparison starts from ``srand(1)``, a fresh process's
    state."""
    ctypes.CDLL(None).srand(1)


def _pair(seed: int, shape) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    return a, b


# --- SSIM, PSNR, MIFD ---------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 32, 40, 3), (3, 24, 20, 1)])
def test_ssim_psnr_match_jax(shape):
    a, b = _pair(0, shape)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for avg in (True, False):
        np.testing.assert_allclose(
            metrics.ssim(ta, tb, return_batch_average=avg).numpy(),
            np.asarray(jmetrics.ssim(ja, jb, return_batch_average=avg)),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            metrics.psnr(ta, tb, return_batch_average=avg).numpy(),
            np.asarray(jmetrics.psnr(ja, jb, return_batch_average=avg)),
            rtol=1e-6, atol=1e-6)
    with pytest.raises(AssertionError):
        metrics.psnr(ta, tb[:1])
    with pytest.raises(AssertionError):
        metrics.psnr(ta.to(torch.uint8), tb.to(torch.uint8))
    np.testing.assert_array_equal(metrics.gaussian_kernel_1d(11, 1.5),
                                  jmetrics.gaussian_kernel_1d(11, 1.5))


def test_mifd_identical_images_match_jax():
    from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
        render_scene,
    )

    img, _ = render_scene(2, (120, 160))
    assert metrics.mifd(img, img) == pytest.approx(0.0, abs=1e-3)
    other, _ = render_scene(2, (120, 160))
    other = np.roll(other, 3, axis=1)
    seed_c_rand()
    ours = metrics.mifd(img, other)
    seed_c_rand()
    assert ours == jmetrics.mifd(img, other)


# --- LPIPS ----------------------------------------------------------------------


def _reference_pths(tmp_path, lins_key: str = "lin{i}.model.1.weight"):
    """A random-weight torchvision AlexNet state dict (with its classifier,
    which the converter skips) and lpips 0.1.4 heads, as files."""
    g = torch.Generator().manual_seed(0)
    alex = {}
    for idx, (cin, cout, k) in zip(_FEATURE_IDX, _ALEX):
        alex[f"features.{idx}.weight"] = torch.randn(cout, cin, k, k,
                                                     generator=g) * 0.05
        alex[f"features.{idx}.bias"] = torch.randn(cout, generator=g) * 0.05
    alex["classifier.1.weight"] = torch.randn(16, 9216, generator=g)
    heads = {lins_key.format(i=i): torch.rand(1, cout, 1, 1, generator=g) * 0.1
             for i, (_, cout, _) in enumerate(_ALEX)}
    alex_path, lpips_path = tmp_path / "alexnet.pth", tmp_path / "lpips.pth"
    torch.save(alex, alex_path)
    torch.save(heads, lpips_path)
    return str(alex_path), str(lpips_path)


@pytest.mark.parametrize("lins_key", ["lin{i}.model.1.weight",
                                      "lins.{i}.model.1.weight"])
def test_lpips_convert_writes_jax_npz(tmp_path, lins_key):
    alex, heads = _reference_pths(tmp_path, lins_key)
    ours, ref = str(tmp_path / "ours.npz"), str(tmp_path / "ref.npz")
    lpips_convert.convert(alex, heads, ours)
    jconvert.convert(alex, heads, ref)
    a, b = np.load(ours), np.load(ref)
    assert sorted(a.files) == sorted(b.files) and len(a.files) == 15
    for key in a.files:
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])
    lpips_convert.main(["--alexnet", alex, "--lpips", heads, "--output",
                        str(tmp_path / "sub" / "cli.npz")])
    assert os.path.isfile(tmp_path / "sub" / "cli.npz")


@pytest.fixture
def lpips_npz(tmp_path):
    alex, heads = _reference_pths(tmp_path)
    path = str(tmp_path / "lpips_alex.npz")
    lpips_convert.convert(alex, heads, path)
    return path


def test_lpips_alex_matches_jax(lpips_npz):
    weights = metrics.load_lpips_weights(lpips_npz)
    assert weights["conv0"]["kernel"].shape == (64, 3, 11, 11)
    assert weights["lin4"].shape == (1, 256, 1, 1)
    jweights = jmetrics.load_lpips_weights(lpips_npz)
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ours = metrics.lpips_alex(torch.from_numpy(a), torch.from_numpy(b),
                              weights).numpy()
    ref = np.asarray(jmetrics.lpips_alex(jnp.asarray(a), jnp.asarray(b),
                                         jweights))
    assert ours.shape == (2,)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6)
    same = metrics.lpips_alex(torch.from_numpy(a), torch.from_numpy(a),
                              weights).numpy()
    np.testing.assert_allclose(same, 0.0, atol=1e-7)
    assert metrics.load_lpips_weights(lpips_npz + ".missing") is None


@pytest.mark.parametrize("with_lpips", [False, True])
def test_visual_tracker_matches_jax(lpips_npz, with_lpips, monkeypatch):
    """``to_dict`` over two batches, one NCHW (the auto-fix) and one with
    an alpha channel, against JAX's tracker; without weights both record
    NaN for LPIPS."""
    monkeypatch.setenv("LPIPS_ALEX_WEIGHTS",
                       lpips_npz if with_lpips else lpips_npz + ".missing")
    from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
        render_scene,
    )

    labels = np.stack([render_scene(s, (64, 80))[0] for s in (1, 2)])
    outputs = np.roll(labels, 2, axis=2)
    batches = [(outputs.transpose(0, 3, 1, 2), labels.transpose(0, 3, 1, 2)),
               (np.concatenate([outputs, outputs[..., :1]], -1),
                np.concatenate([labels, labels[..., :1]], -1))]
    ours = metrics.VisualMetricsTracker(device="cpu")
    ref = jmetrics.VisualMetricsTracker()
    for tracker in (ours, ref):
        seed_c_rand()
        for out, lab in batches:
            tracker.update(out, lab)
    got, want = ours.to_dict(), ref.to_dict()
    assert list(got) == list(want) == ["ssim", "psnr", "lpips", "mifd"]
    assert np.isnan(got["lpips"]) == np.isnan(want["lpips"]) == (not with_lpips)
    # rendered scenes have flat regions, where SSIM's variance is the
    # difference of two nearly equal blurred sums: 1e-5 (7e-6 seen)
    for key, rtol in (("ssim", 1e-5), ("psnr", 1e-5), ("lpips", 1e-4)):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=1e-6)
    assert got["mifd"] == want["mifd"]
    assert "SSIM" in str(ours)


# --- datasets -------------------------------------------------------------------


def test_midas_resize_and_crop_match_jax():
    for args in ((320, 240, True, True, 32, "upper_bound"),
                 (320, 240, True, True, 1, "upper_bound"),
                 (384, 384, True, True, 32, "lower_bound"),
                 (384, 384, True, True, 32, "minimal"),
                 (300, 200, True, False, 16, "lower_bound")):
        ours, ref = datasets.MidasResize(*args), jdatasets.MidasResize(*args)
        for w, h in ((608, 456), (640, 480), (500, 300), (321, 987)):
            assert ours.get_size(w, h) == ref.get_size(w, h)
    assert datasets.MidasResize(320, 240, keep_aspect_ratio=True,
                                ensure_multiple_of=32,
                                resize_method="upper_bound").get_size(
        608, 456) == (320, 224)
    rng = np.random.default_rng(0)
    sample = {"image": rng.uniform(size=(480, 640, 3)),
              "depth": rng.uniform(size=(480, 640))}
    for size in ([0.95, 0.95], [300, 200]):
        ours = datasets.RatioCenterCrop(size)(sample)
        ref = jdatasets.RatioCenterCrop(size)(sample)
        for key in sample:
            np.testing.assert_array_equal(ours[key], ref[key])


@pytest.fixture
def nyu_csv(tmp_path):
    """tests/test_benchmark.py's layout: one RGB and one 16-bit depth PNG,
    listed twice, and ``camera.json``; plus a blank line."""
    rng = np.random.default_rng(0)
    image = (rng.uniform(size=(480, 640, 3)) * 255).astype(np.uint8)
    depth = rng.integers(500, 9000, (480, 640)).astype(np.uint16)
    Image.fromarray(image).save(tmp_path / "rgb.png")
    Image.fromarray(depth).save(tmp_path / "d.png")
    (tmp_path / "pairs.csv").write_text("rgb.png,d.png\n\nrgb.png,d.png\n")
    (tmp_path / "camera.json").write_text(json.dumps(
        {"width": 640, "height": 480, "fx": 525.0, "fy": 525.0,
         "cx": 320.0, "cy": 240.0}))
    return str(tmp_path / "pairs.csv")


@pytest.mark.parametrize("multiple,is_test", [(1, True), (32, True),
                                              (1, False)])
def test_depth_dataset_matches_jax(nyu_csv, multiple, is_test):
    ours = datasets.DepthDataset(nyu_csv, datasets.nyu_eval_sample(multiple),
                                 is_test=is_test)
    ref = jdatasets.DepthDataset(nyu_csv, jdatasets.nyu_eval_sample(multiple),
                                 is_test=is_test)
    assert len(ours) == len(ref) == 2
    for i in range(2):
        a, b = ours[i], ref[i]
        for key in ("image", "depth"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    assert a["image"].shape == ((240, 320, 3) if multiple == 1
                                else (224, 320, 3))
    assert ours.camera_intrinsics == ref.camera_intrinsics
    np.testing.assert_array_equal(ours.camera_matrix, ref.camera_matrix)
    assert ours.image_paths == ref.image_paths
    assert ours.depth_paths == ref.depth_paths


def test_depth_dataset_without_camera_json(nyu_csv):
    os.remove(os.path.join(os.path.dirname(nyu_csv), "camera.json"))
    with pytest.warns(UserWarning, match="camera.json"):
        ds = datasets.DepthDataset(nyu_csv)
    assert np.isnan(ds.camera_intrinsics["fx"])
    np.testing.assert_array_equal(ds.camera_matrix, np.eye(3))


def test_folder_datasets_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    flat = tmp_path / "flat"
    flat.mkdir()
    image_io.save_raw_float32_image(str(flat / "000000.raw"),
                                    rng.uniform(size=(8, 10)).astype(np.float32))
    Image.fromarray((rng.uniform(size=(8, 10)) * 255).astype(np.uint8)).save(
        flat / "000001.png")
    nested = tmp_path / "nested"
    for sub in ("000000", "000001"):
        (nested / sub).mkdir(parents=True)
        for k in (3, 5):
            Image.fromarray((rng.uniform(size=(8, 10, 3)) * 255).astype(
                np.uint8)).save(nested / sub / f"{k:06d}.png")
    (nested / "notes.txt").write_text("not a sample")
    for ours, ref in ((datasets.ImageFolderDataset(str(flat)),
                       jdatasets.ImageFolderDataset(str(flat))),
                      (datasets.NestedImageFolderDataset(str(nested)),
                       jdatasets.NestedImageFolderDataset(str(nested)))):
        assert len(ours) == len(ref)
        assert [str(p) for p in ours.image_paths] == \
            [str(p) for p in ref.image_paths]
        for i in range(len(ours)):
            np.testing.assert_array_equal(ours[i], ref[i])
    assert len(datasets.NestedImageFolderDataset(str(nested))) == 4


# --- noise and .raw -------------------------------------------------------------


def test_perlin_matches_jax():
    for width, height, scale in ((64, 48, 16), (320, 240, 32), (33, 17, 8)):
        np.random.seed(42)
        ref = jnoise.perlin(width, height, scale=scale)
        ours = noise.perlin(width, height, np.random.RandomState(42), scale)
        np.testing.assert_array_equal(ours, ref)
    np.random.seed(None)


def test_noisy_depth_maps_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    depths = [rng.uniform(0, 10, (240, 320)).astype(np.float32),
              rng.integers(0, 256, (240, 320, 1)).astype(np.uint8)]
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    noise.create_noisy_depth_maps(str(ours), depths)
    jnoise.create_noisy_depth_maps(str(ref), depths)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref)) == [
        "000000.png", "000001.png"]
    for f in os.listdir(ours):
        np.testing.assert_array_equal(np.asarray(Image.open(ours / f)),
                                      np.asarray(Image.open(ref / f)))
    # cached: a second call writes nothing
    before = os.path.getmtime(ours / "000000.png")
    noise.create_noisy_depth_maps(str(ours), depths)
    assert os.path.getmtime(ours / "000000.png") == before


@pytest.mark.parametrize("shape", [(7, 9), (7, 9, 3)])
def test_raw_round_trip_matches_jax(tmp_path, shape):
    arr = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    ours, ref = str(tmp_path / "ours.raw"), str(tmp_path / "ref.raw")
    image_io.save_image(ours, arr)
    jimage_io.save_image(ref, arr)
    assert open(ours, "rb").read() == open(ref, "rb").read()
    np.testing.assert_array_equal(image_io.load_raw_float32_image(ours), arr)
    np.testing.assert_array_equal(jimage_io.load_raw_float32_image(ours), arr)
    png = str(tmp_path / "img.png")
    image_io.save_image(png, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(png)),
                                  (255.0 * arr).astype(np.uint8))
