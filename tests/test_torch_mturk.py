"""The port's study tooling (``mturk/``) and COLMAP I/O
(``utils/colmap_io.py``) against the JAX package's, on the same seeded
inputs: the same tables, scores, frame choices and files.

The ratings fixture is ``tests/test_mturk.py``'s.
"""

import os

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from efficientdepthestimation_tpu.mturk import (
    collect_study_materials as jcollect,
)
from efficientdepthestimation_tpu.mturk import process_mturk_results as jpr
from efficientdepthestimation_tpu.mturk import (
    process_mturk_second_round_results as jpr2,
)
from efficientdepthestimation_tpu.mturk import tum2kf as jtum
from efficientdepthestimation_tpu.utils import colmap_io as jcolmap
from efficientdepthestimation_tpu_torch.mturk import (
    collect_study_materials as collect,
)
from efficientdepthestimation_tpu_torch.mturk import (
    process_mturk_results as pr,
)
from efficientdepthestimation_tpu_torch.mturk import (
    process_mturk_second_round_results as pr2,
)
from efficientdepthestimation_tpu_torch.mturk import tum2kf
from efficientdepthestimation_tpu_torch.utils import colmap_io


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def ratings_csv(tmp_path, rng):
    rows = []
    labels = ["Bad", "Poor", "Fair", "Good", "Excellent"]
    for worker in ("W1", "W2", "W3"):
        for i in range(10):
            rows.append({
                "WorkerId": worker,
                "WorkTimeInSeconds": 2 if worker == "W3" else 30,
                "Answer.rating.label":
                    "Good" if worker == "W3" else labels[int(rng.integers(5))],
                "Input.video_url":
                    f"https://bucket.s3.amazonaws.com/reside_enb0/{i:06d}.mp4",
            })
    path = tmp_path / "ratings.csv"
    pd.DataFrame(rows).to_csv(path, index=False)
    return str(path)


def test_process_raw_data_matches_jax(ratings_csv):
    ours = pr.process_raw_data(ratings_csv)
    pd.testing.assert_frame_equal(ours, jpr.process_raw_data(ratings_csv))
    assert (ours["Model"] == "hu_enb0").all()
    assert ours["Score"].between(1, 5).all()


def test_reject_workers_matches_jax(ratings_csv, tmp_path):
    q = tmp_path / "questionnaire.csv"
    pd.DataFrame({"WorkerId": ["W1"]}).to_csv(q, index=False)
    ours = pr.reject_workers(pr.process_raw_data(ratings_csv), [str(q)])
    ref = jpr.reject_workers(jpr.process_raw_data(ratings_csv), [str(q)])
    pd.testing.assert_frame_equal(ours, ref)
    assert bool(ours.loc["W3", "too_fast"])
    assert bool(ours.loc["W3", "all_same_answers"])
    assert bool(ours.loc["W2", "did_not_complete_questionnaire"])


def test_analysis_cli_matches_jax(ratings_csv, tmp_path, capsys):
    """``process_mturk_results.main``: the per-model table and the printed
    report are JAX's; both write their figure."""
    q = tmp_path / "questionnaire.csv"
    pd.DataFrame({"WorkerId": ["W1", "W2"]}).to_csv(q, index=False)
    printed, tables = {}, {}
    for key, mod in (("p", pr), ("j", jpr)):
        out = tmp_path / key
        out.mkdir()
        tables[key] = mod.main(["--results-csv", ratings_csv,
                                "--questionnaire-csv", str(q),
                                "--output-path", str(out)])
        printed[key] = capsys.readouterr().out.replace(str(out), "OUT")
        assert (out / "mturk_analysis.png").is_file()
    pd.testing.assert_frame_equal(tables["p"], tables["j"])
    assert printed["p"] == printed["j"]


def _second_round_frame(rng, models, videos) -> pd.DataFrame:
    n = 6
    data = {"WorkerId": [f"W{i}" for i in range(n)],
            "WorkTimeInSeconds": rng.integers(100, 900, n)}
    for m in models:
        for v in videos:
            for task in (f"{m}-{v:06d}-realism",
                         f"gt-{m}-{v:06d}-similarity"):
                pick = rng.integers(0, 7, n)
                for k in range(7):
                    data[f"Answer.{task}.{k + 1}"] = pick == k
        for v in videos:  # randomized-id ground-truth realism items
            for k in range(7):
                data[f"Answer.gt-{v:06d}-{m}x-realism.{k + 1}"] = \
                    rng.integers(0, 2, n).astype(bool)
    return pd.DataFrame(data)


def test_convert_to_scores_matches_jax(rng):
    df = pd.DataFrame({
        "Answer.m-000000-realism.1": [True, False, False],
        "Answer.m-000000-realism.2": [False, True, False],
        "Answer.m-000000-realism.3": [False, False, True],
    })
    for scale in (2, 3):
        ours = pr2.convert_to_scores(df, ["m-000000-realism", "absent"],
                                     scale_range=scale)
        ref = jpr2.convert_to_scores(df, ["m-000000-realism", "absent"],
                                     scale_range=scale)
        assert list(ours) == list(ref) == ["m-000000-realism"]
        pd.testing.assert_series_equal(ours["m-000000-realism"],
                                       ref["m-000000-realism"])
    assert list(ours["m-000000-realism"]) == [0, 1, 2]
    big = _second_round_frame(rng, ["flat", "reside_enb0"], [0, 30])
    cols = [f"{m}-{v:06d}-realism" for m in ("flat", "reside_enb0")
            for v in (0, 30)]
    ours = pr2.convert_to_scores(big, cols, 7)
    ref = jpr2.convert_to_scores(big, cols, 7)
    assert list(ours) == list(ref) == cols
    for col in cols:
        pd.testing.assert_series_equal(ours[col], ref[col])


def test_second_round_cli_matches_jax(rng, tmp_path, capsys):
    """``process_mturk_second_round_results.main``: similarity, realism
    and ground-truth realism scores as JAX's, its report and its figure."""
    models, videos = ["flat", "reside_enb0"], [0, 30]
    csv = tmp_path / "round2.csv"
    _second_round_frame(rng, models, videos).to_csv(csv, index=False)
    results, printed = {}, {}
    for key, mod in (("p", pr2), ("j", jpr2)):
        out = tmp_path / key
        out.mkdir()
        results[key] = mod.main(["--csv-path", str(csv), "--output-path",
                                 str(out), "--models", *models, "--videos",
                                 *map(str, videos)])
        printed[key] = capsys.readouterr().out
        assert (out / "similarity_by_rater.png").is_file()
    assert printed["p"] == printed["j"]
    for part in ("similarity", "realism", "gt_realism"):
        ours, ref = results["p"][part], results["j"][part]
        assert list(ours) == list(ref) and ours, part
        for col in ref:
            pd.testing.assert_series_equal(ours[col], ref[col])


@pytest.mark.parametrize("config", [
    dict(), dict(step=10), dict(stop_is_inclusive=True),
    dict(fps=30.0, time=(1.0, 2.0), interval=0.5),
    dict(fps=15.0, time=(0.5, None)), dict(range=(5, 10)),
    dict(range=(5, 10), stop_is_inclusive=True, step=2)])
def test_frame_sampler_matches_jax(config):
    frames = list(range(100))
    chosen = []
    for mod in (tum2kf, jtum):
        kw = {k: v for k, v in config.items()
              if k in ("step", "stop_is_inclusive", "fps")}
        sampler = mod.FrameSampler(**kw)
        if "time" in config:
            sampler = sampler.time_range(*config["time"])
        if "interval" in config:
            sampler = sampler.time_interval(config["interval"])
        if "range" in config:
            sampler = sampler.frame_range(*config["range"])
        chosen.append((sampler.choose(frames), sampler.start, sampler.stop,
                       sampler.step))
        assert repr(sampler).startswith("<FrameSampler(")
    assert chosen[0] == chosen[1]


def _tum_sequence(root, rng, n: int = 5):
    """A TUM RGB-D folder: colour JPEGs and 16-bit depth PNGs listed by
    timestamp, a trajectory at other timestamps."""
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb_lines, depth_lines, traj_lines = ["# rgb"], ["# depth"], ["# traj"]
    for i in range(n):
        t = 1.0 + i / 30.0
        image = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        depth = rng.integers(500, 20000, (48, 64)).astype(np.uint16)
        Image.fromarray(image).save(root / "rgb" / f"{t:.6f}.png")
        Image.fromarray(depth).save(root / "depth" / f"{t:.6f}.png")
        rgb_lines.append(f"{t + 0.004:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{t:.6f} depth/{t:.6f}.png")
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        pose = [*rng.standard_normal(3), *q]
        traj_lines.append(f"{t - 0.002:.6f} " + " ".join(f"{v:.6f}"
                                                          for v in pose))
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", traj_lines)):
        (root / name).write_text("\n".join(lines) + "\n")


def test_tum2kf_cli_matches_jax(rng, tmp_path, capsys):
    """``tum2kf.main`` on a 5-frame sequence: the same files, byte for
    byte (colour JPEGs by PIL, 16-bit depth PNGs, poses, info.txt)."""
    _tum_sequence(tmp_path / "tum", rng)
    for key, mod in (("p", tum2kf), ("j", jtum)):
        mod.main(["--base-folder", str(tmp_path / "tum"), "--output-path",
                  str(tmp_path / key)])
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == names
    assert len(names) == 3 * 5 + 1 and "info.txt" in names
    for name in names:
        assert _bytes(tmp_path / "p" / name) == _bytes(tmp_path / "j" / name)
    loader = tum2kf.TUMDataLoader(tmp_path / "tum").load(
        tum2kf.FrameSampler(step=2))
    ref = jtum.TUMDataLoader(tmp_path / "tum").load(jtum.FrameSampler(step=2))
    assert loader.num_frames == ref.num_frames == 3
    np.testing.assert_array_equal(loader.frames, ref.frames)
    np.testing.assert_array_equal(loader.depth_maps, ref.depth_maps)
    np.testing.assert_array_equal(loader.poses, ref.poses)
    with pytest.raises(RuntimeError, match="Not a readable folder"):
        tum2kf.TUMDataLoader(tmp_path / "none")


def test_collect_study_materials_matches_jax(tmp_path, capsys):
    """``collect_study_materials.main`` on a benchmark tree whose sweeps
    are the native MJPEG AVIs: the same URLs, HIT template and URL table,
    and side-by-side videos of every frame pair."""
    import cv2

    from efficientdepthestimation_tpu_torch.native import encoder

    bench = tmp_path / "benchmark" / "nyu"
    yy, xx = np.mgrid[0:32, 0:48]
    for model, shift in (("ground_truth", 0), ("reside_enb0", 5),
                         ("flat", 9)):
        video_dir = bench / model / (
            "video" if model == "ground_truth" else "rendered_images/video")
        video_dir.mkdir(parents=True)
        for idx in (0, 2):
            frames = np.stack([np.stack([((xx + i + shift) % 48) * 5, yy * 7,
                                         np.full_like(xx, 40 * idx)], -1)
                               for i in range(4)]).astype(np.uint8)
            encoder.write_mjpeg_avi(str(video_dir / f"{idx:06d}.avi"), frames,
                                    fps=12)
    nyu = tmp_path / "nyu"
    nyu.mkdir()
    (nyu / "nyu2_test.csv").write_text(
        "".join(f"rgb{i}.png,d{i}.png\n" for i in range(4)))
    urls = {}
    for key, mod in (("p", collect), ("j", jcollect)):
        out = tmp_path / key
        urls[key] = mod.main(["--benchmark-path", str(bench),
                              "--nyu-dataset-path", str(nyu),
                              "--output-path", str(out),
                              "--selection-interval", "2",
                              "--model-selection", "flat", "reside_enb0"])
    assert urls["p"] == urls["j"] == [
        f"https://bucket.s3.amazonaws.com/{m}/{i:06d}.mp4"
        for m in ("flat", "reside_enb0") for i in (0, 2)]
    for name in ("template.html", "video_urls.csv"):
        assert _bytes(tmp_path / "p" / name) == _bytes(tmp_path / "j" / name)
    for model in ("flat", "reside_enb0"):
        for idx in (0, 2):
            path = tmp_path / "p" / "pairs" / model / f"{idx:06d}.mp4"
            cap = cv2.VideoCapture(str(path))
            try:
                assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 4
                assert cap.get(cv2.CAP_PROP_FRAME_WIDTH) == 96
            finally:
                cap.release()


# ------------------------------------------------------------- colmap_io

def _model(mod):
    cameras = {1: mod.Camera(1, "SIMPLE_PINHOLE", 640, 480,
                             [525.0, 320.0, 240.0]),
               3: mod.Camera(3, "SIMPLE_PINHOLE", 320, 240,
                             [262.5, 160.0, 120.5])}
    images = {
        2: mod.Image(2, [1.0, 0.0, 0.0, 0.0], [0.1, 0.2, 0.3], 1,
                     "frame.png", np.array([[1.0, 2.0], [3.0, 4.0]]),
                     np.array([7, -1])),
        5: mod.Image(5, [0.5, 0.5, 0.5, 0.5], [-1.5, 0.25, 2.0], 3,
                     "frame_b.png", np.array([[10.5, 20.25]]),
                     np.array([7])),
    }
    points = {
        7: mod.Point3D(7, [0.5, -0.5, 2.0], [255, 128, 0], 0.25,
                       np.array([2, 5]), np.array([0, 0])),
        9: mod.Point3D(9, [1.0, 2.0, 3.0], [1, 2, 3], 1.5, np.array([2]),
                       np.array([1])),
    }
    return cameras, images, points


@pytest.mark.parametrize("ext", [".txt", ".bin"])
def test_colmap_model_files_match_jax(tmp_path, ext):
    for key, mod in (("p", colmap_io), ("j", jcolmap)):
        (tmp_path / key).mkdir()
        mod.write_model(*_model(mod), str(tmp_path / key), ext)
    for name in ("cameras", "images", "points3D"):
        assert _bytes(tmp_path / "p" / f"{name}{ext}") == \
            _bytes(tmp_path / "j" / f"{name}{ext}"), name
    cams, imgs, pts = colmap_io.read_model(str(tmp_path / "j"), ext)
    jcams, jimgs, jpts = jcolmap.read_model(str(tmp_path / "p"), ext)
    assert sorted(cams) == sorted(jcams) == [1, 3]
    for k in cams:
        assert vars(cams[k]) == vars(jcams[k])
    for k in imgs:
        a, b = imgs[k], jimgs[k]
        assert (a.id, a.camera_id, a.name) == (b.id, b.camera_id, b.name)
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)
        assert [vars(p) for p in a.points2D] == [vars(p) for p in b.points2D]
    for k in pts:
        a, b = pts[k], jpts[k]
        for attr in ("xyz", "rgb", "image_ids", "point2D_idxs"):
            np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))
        assert a.error == b.error and (a.x, a.r) == (b.x, b.r)


def test_colmap_camera_pose_and_rotations_match_jax(tmp_path, rng):
    cam, jcam = (mod.Camera(3, "SIMPLE_PINHOLE", 320, 240,
                            [260.0, 160.0, 120.0])
                 for mod in (colmap_io, jcolmap))
    cam.save_json(str(tmp_path / "p.json"))
    jcam.save_json(str(tmp_path / "j.json"))
    assert _bytes(tmp_path / "p.json") == _bytes(tmp_path / "j.json")
    back = colmap_io.Camera.load_json(str(tmp_path / "j.json"))
    assert vars(back) == vars(cam) and back.shape == (240, 320)
    np.testing.assert_array_equal(back.get_matrix(), jcam.get_matrix())
    np.testing.assert_array_equal(back.get_inverse_matrix(),
                                  jcam.get_inverse_matrix())
    np.testing.assert_array_equal(
        colmap_io.Camera.to_homogeneous_matrix(cam.get_matrix()),
        jcolmap.Camera.to_homogeneous_matrix(cam.get_matrix()))
    for _ in range(4):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        R = colmap_io.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jcolmap.qvec2rotmat(q))
        np.testing.assert_array_equal(colmap_io.rotmat2qvec(R),
                                      jcolmap.rotmat2qvec(R))
    pose = colmap_io.CameraPose(q, [1.0, 2.0, 3.0])
    pose.save_pkl(str(tmp_path / "pose.pkl"))
    loaded = colmap_io.CameraPose.load_pkl(str(tmp_path / "pose.pkl"))
    np.testing.assert_array_equal(loaded.R.as_matrix(),
                                  jcolmap.CameraPose(q, [1, 2, 3]).R
                                  .as_matrix())
    np.testing.assert_array_equal(loaded.t, pose.t)
