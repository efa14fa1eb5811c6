"""The port's demo, point_clouds, pcd2image, depth_video, examples and
inference CLIs against the JAX package's, on the CPU.

The workspace is ``tests/test_torch_apps.py``'s (a resnet18-HU with the JAX
package's random init, 3 pairs of 480×640 PNGs, a directory of 3 frames),
with the checkpoint saved both as ``.ede`` and, through the JAX package's
``state_dict_from_variables``, as a reference ``.pth`` under DataParallel's
``module.`` prefix. Each CLI runs in both packages on each file, the
port's with ``--device cpu``.

Tolerances: the two packages' f32 depth maps agree to ~1e-6 relative, so
an 8-bit image of them may differ by one grey level where a value lies
within rounding of a level's edge (matplotlib and the apps scale by the
map's min or max); points, which scale with the depth, to 1e-5 relative
(and 1e-6 m). A point's colour is its normalized pixel denormalized and
truncated to uint8: the normalized values differ in their last bits (XLA
divides by the std as a product with its reciprocal), and a pixel level
k comes back as k - ε or k + ε, so colours also to one level. The colour
half of a video frame is PIL's resize of the frame itself: equal.
"""

import contextlib
import io
import os

import numpy as np
import pytest

import jax
import torch

from efficientdepthestimation_tpu.checkpoints.pth_import import (
    state_dict_from_variables,
)
from efficientdepthestimation_tpu.checkpoints.serialization import (
    load_checkpoint,
)

from test_torch_apps import _two_threads, workspace  # noqa: F401 (fixtures)

LEVEL = 1  # grey levels
POINT_TOL = dict(rtol=1e-5, atol=1e-6)
FORMATS = ("ede", "pth")


@pytest.fixture(scope="module")
def checkpoints(workspace, tmp_path_factory):  # noqa: F811
    """{format: (checkpoint path, a directory holding only it)}."""
    root = tmp_path_factory.mktemp("torch_media_apps")
    model, variables, _ = load_checkpoint(workspace["ckpt"])
    sd = state_dict_from_variables(model, jax.tree_util.tree_map(
        np.asarray, variables))
    pth_dir = root / "pth"
    pth_dir.mkdir()
    pth = str(pth_dir / "RN18-HU.pth")
    torch.save({f"module.{k}": torch.from_numpy(np.array(v))
                for k, v in sd.items()}, pth)
    return {"ede": (workspace["ckpt"], workspace["ckpt_dir"]),
            "pth": (pth, str(pth_dir))}


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _png(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.int64)


def _close_levels(ours: np.ndarray, ref: np.ndarray, what: str):
    assert ours.shape == ref.shape, what
    assert np.abs(ours - ref).max() <= LEVEL, what


@pytest.mark.parametrize("fmt", FORMATS)
def test_demo_matches_jax(fmt, workspace, checkpoints, tmp_path):  # noqa: F811
    from efficientdepthestimation_tpu.apps import demo as jdemo
    from efficientdepthestimation_tpu_torch.apps import demo

    ckpt, _ = checkpoints[fmt]
    image = os.path.join(workspace["frames"], "000.png")
    _quiet(jdemo.main, ["-i", image, "-m", ckpt, "-o", str(tmp_path / "j")])
    _quiet(demo.main, ["-i", image, "-m", ckpt, "-o", str(tmp_path / "p"),
                       "--device", "cpu"])
    assert os.listdir(tmp_path / "p") == os.listdir(tmp_path / "j") == \
        ["000.png"]
    ours, ref = _png(tmp_path / "p" / "000.png"), _png(tmp_path / "j" /
                                                       "000.png")
    assert ours.shape == (114, 152, 4)  # matplotlib writes RGBA
    _close_levels(ours, ref, "demo PNG")


def test_demo_falls_back_to_the_path_substrings(tmp_path):
    """A raw ``.pth`` whose name is not ``{ENC}-{DEC}`` takes its
    architecture from the path's substrings (demo.py:25-31): resnet50-HU
    for 'model_resnet'."""
    from efficientdepthestimation_tpu_torch.apps import demo
    from efficientdepthestimation_tpu_torch.checkpoints.pth_import import (
        reference_state_dict,
    )
    from efficientdepthestimation_tpu_torch.models.common import randomize_
    from efficientdepthestimation_tpu_torch.models.registry import (
        build_model,
    )

    source = randomize_(build_model("resnet50", "hu2018"), 3)
    ckpt = str(tmp_path / "model_resnet.pth")
    torch.save(reference_state_dict(source), ckpt)
    with pytest.raises(ValueError):  # what the fallback catches
        demo.load_any_checkpoint(ckpt, device="cpu")
    model = demo.load_demo_model(ckpt, "cpu")
    for k, v in source.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize("fmt", FORMATS)
def test_point_clouds_match_jax(fmt, workspace, checkpoints,
                                tmp_path):  # noqa: F811
    from efficientdepthestimation_tpu.apps import point_clouds as jpc
    from efficientdepthestimation_tpu.utils.pointcloud import read_ply
    from efficientdepthestimation_tpu_torch.apps import point_clouds

    ckpt, _ = checkpoints[fmt]
    argv = ["-i", workspace["frames"], "-m", ckpt, "--max-frames", "2",
            "--mirror-z-axis"]
    _quiet(jpc.main, argv + ["-o", str(tmp_path / "j")])
    _quiet(point_clouds.main, argv + ["-o", str(tmp_path / "p"), "--device",
                                      "cpu"])
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) == ["0000.ply",
                                                           "0001.ply"]
    for name in names:
        points, colors = read_ply(str(tmp_path / "p" / name))
        ref_points, ref_colors = read_ply(str(tmp_path / "j" / name))
        assert points.shape == ref_points.shape == (228 * 304, 3)
        np.testing.assert_allclose(points, ref_points, **POINT_TOL)
        _close_levels(colors.astype(np.int64), ref_colors.astype(np.int64),
                      f"{name} colours")


@pytest.mark.parametrize("mirror_z", [False, True])
def test_unproject_depth_matches_jax(mirror_z):
    """The port's ``unproject_depth`` on seeded depth (a quarter of it 0,
    so dropped) and colours against JAX's, rows flipped as in the
    reference: points within ``POINT_TOL``, colours equal."""
    from efficientdepthestimation_tpu.utils.pointcloud import (
        unproject_depth as jax_unproject,
    )
    from efficientdepthestimation_tpu_torch.utils.pointcloud import (
        NYU_V2_INTRINSICS_HALF,
        unproject_depth,
    )

    rng = np.random.default_rng(11)
    depth = rng.uniform(0.5, 10.0, (24, 32)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.25] = 0.0
    colors = rng.random((24, 32, 3)).astype(np.float32)
    k = {n: NYU_V2_INTRINSICS_HALF[n] for n in ("fx", "fy", "cx", "cy")}
    points, rgb = unproject_depth(torch.from_numpy(depth),
                                  torch.from_numpy(colors),
                                  mirror_z=mirror_z, **k)
    ref_points, ref_rgb = jax_unproject(depth, colors, mirror_z=mirror_z, **k)
    assert points.shape == ref_points.shape == (int((depth > 0).sum()), 3)
    np.testing.assert_allclose(points.numpy(), ref_points, **POINT_TOL)
    np.testing.assert_array_equal(rgb.numpy(), ref_rgb)


def test_pcd2image_matches_jax(tmp_path):
    """The same PLY files (two decoders × one encoder × 6 clouds, ascii and
    binary) into both CLIs give the same collage, in both orientations."""
    from efficientdepthestimation_tpu.apps import pcd2image as jpcd
    from efficientdepthestimation_tpu_torch.apps import pcd2image
    from efficientdepthestimation_tpu_torch.utils.pointcloud import write_ply

    rng = np.random.default_rng(7)
    for d, decoder in enumerate(("hu2018", "lasinger2019")):
        folder = tmp_path / "plys" / decoder / "rn18"
        folder.mkdir(parents=True)
        for i in range(6):
            points = rng.normal(0, 1, (500, 3)).astype(np.float32)
            colors = rng.integers(0, 256, (500, 3), dtype=np.uint8)
            write_ply(str(folder / f"{i:04d}.ply"), points, colors,
                      binary=bool((i + d) % 2))
    for orientation in ("column", "row"):
        argv = ["-i", str(tmp_path / "plys"), "--size", "48", "-o",
                orientation]
        ref = _quiet(jpcd.main, argv + ["--output", str(tmp_path / "j.png")])
        ours = _quiet(pcd2image.main,
                      argv + ["--output", str(tmp_path / "p.png")])
        a, b = _png(ours), _png(ref)
        assert a.shape == ((96, 288, 3) if orientation == "column"
                           else (288, 96, 3))
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", FORMATS)
def test_depth_video_matches_jax(fmt, workspace, checkpoints, tmp_path,
                                 monkeypatch):  # noqa: F811
    """The frames each package hands its video writer (captured at
    ``AsyncVideoWriter.submit``): the colour half equal, the depth half
    within one level; the port's file holds them all at 3840×1080, in the
    JAX package's container and codec (the native MJPEG-in-AVI writer,
    FourCC ``MJPG``)."""
    import cv2

    from efficientdepthestimation_tpu.apps import depth_video as jvideo
    from efficientdepthestimation_tpu.utils import async_writer as jwriter
    from efficientdepthestimation_tpu_torch.apps import depth_video
    from efficientdepthestimation_tpu_torch.utils import async_writer

    frames = {"j": [], "p": []}
    for key, cls in (("j", jwriter.AsyncVideoWriter),
                     ("p", async_writer.AsyncVideoWriter)):
        def submit(self, frame, index=None, _real=cls.submit, _key=key):
            frames[_key].append(frame.copy())
            return _real(self, frame, index)

        monkeypatch.setattr(cls, "submit", submit)
    ckpt, _ = checkpoints[fmt]
    argv = ["-i", workspace["frames"], "-m", ckpt, "--batch-size", "2"]
    _quiet(jvideo.main, argv + ["-o", str(tmp_path / "j")])
    out = _quiet(depth_video.main, argv + ["-o", str(tmp_path / "p"),
                                           "--device", "cpu"])
    assert out == str(tmp_path / "p" / "RN18-HU.mp4")
    assert len(frames["p"]) == len(frames["j"]) == 3
    for ours, ref in zip(frames["p"], frames["j"]):
        assert ours.shape == ref.shape == (1080, 3840, 3)
        assert ours.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(ours[:, :1920], ref[:, :1920])
        _close_levels(ours[:, 1920:].astype(np.int64),
                      ref[:, 1920:].astype(np.int64), "depth half")
    cap = cv2.VideoCapture(out)
    try:
        assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 3
        assert cap.get(cv2.CAP_PROP_FRAME_WIDTH) == 3840
        assert cap.get(cv2.CAP_PROP_FRAME_HEIGHT) == 1080
    finally:
        cap.release()
    assert _fourcc(out) == _fourcc(str(tmp_path / "j" / "RN18-HU.mp4")) \
        == "MJPG"


def _fourcc(path: str) -> str:
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        code = int(cap.get(cv2.CAP_PROP_FOURCC))
    finally:
        cap.release()
    return "".join(chr((code >> 8 * i) & 0xFF) for i in range(4))


def test_video_writer_orders_frames_and_defers_native(tmp_path):
    """Frames submitted out of order are written in index order; with
    ``native=True`` they go to the native MJPEG-in-AVI writer (BGR frames
    swapped to RGB), whose file cv2 reads back in that order, and
    ``native=False`` defers to cv2's writer with the given fourcc."""
    import cv2

    from efficientdepthestimation_tpu_torch.utils.async_writer import (
        AsyncVideoWriter,
    )

    written = []

    class Recorder:
        def write(self, frame):
            written.append(int(frame[0, 0, 0]))

        def release(self):
            written.append("released")

    with AsyncVideoWriter(str(tmp_path / "v.avi"), (8, 4),
                          native=False) as video:
        video.writer.release()
        video.writer = Recorder()
        video._write = video.writer.write
        for i in (2, 0, 3, 1):
            video.submit(np.full((4, 8, 3), i, np.uint8), index=i)
        assert written == [0, 1, 2, 3]
        video.submit(np.full((4, 8, 3), 9, np.uint8), index=9)
    assert written == [0, 1, 2, 3, 9, "released"]

    # BGR frames: blue rises with the index, red falls, green is constant
    path = str(tmp_path / "n.avi")
    levels = (40, 90, 140, 190, 240)
    with AsyncVideoWriter(path, (48, 32), fps=24.0, native=True) as video:
        for i in (3, 1, 0, 4, 2):
            video.submit(np.broadcast_to(np.array(
                [levels[i], 128, 280 - levels[i]], np.uint8),
                (32, 48, 3)).copy(), index=i)
    assert _fourcc(path) == "MJPG"
    cap = cv2.VideoCapture(path)
    try:
        assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 5
        assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(24.0)
        read = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            read.append(frame.reshape(-1, 3).mean(0))
    finally:
        cap.release()
    assert len(read) == 5
    for got, level in zip(read, levels):
        # flat colours through JPEG at quality 90: within 4 levels
        np.testing.assert_allclose(got, [level, 128, 280 - level], atol=4)


@pytest.mark.parametrize("fmt", FORMATS)
def test_examples_match_jax(fmt, workspace, checkpoints,
                            tmp_path):  # noqa: F811
    from efficientdepthestimation_tpu.apps import examples as jexamples
    from efficientdepthestimation_tpu_torch.apps import examples

    _, ckpt_dir = checkpoints[fmt]
    argv = ["-c", ckpt_dir, "--test-csv", workspace["csv"], "-b", "2"]
    ref = _quiet(jexamples.main, argv + ["-o", str(tmp_path / "j")])
    ours = _quiet(examples.main, argv + ["-o", str(tmp_path / "p"),
                                         "--device", "cpu"])
    assert list(ours) == list(ref) == ["RN18-HU"]
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        f"sample{i:02d}_{n}.png" for i in range(2) for n in ("RN18-HU", "gt")]
    for name in names:
        _close_levels(_png(tmp_path / "p" / name), _png(tmp_path / "j" / name),
                      name)


@pytest.mark.parametrize("fmt", FORMATS)
def test_inference_matches_jax(fmt, workspace, checkpoints):  # noqa: F811
    """A positive peak, ``static`` on the CPU in both packages."""
    from efficientdepthestimation_tpu.apps import inference as jinference
    from efficientdepthestimation_tpu_torch.apps import inference

    ckpt, _ = checkpoints[fmt]
    argv = ["--model", ckpt, "--test-csv", workspace["csv"], "--batch-size",
            "2"]
    for main, extra in ((jinference.main, []),
                        (inference.main, ["--device", "cpu"])):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            peak = main(argv + extra)
        assert peak > 0
        assert printed.getvalue().strip().endswith(f"({peak} bytes, static)")


def test_eval_clis_on_pth_match_jax(workspace, checkpoints,
                                    tmp_path):  # noqa: F811
    """``test_nyu`` and ``inference_benchmark`` over a directory that
    holds the ``.pth``: the same 16-bit depth maps within 1 mm as JAX's
    (a value within rounding of an integer mm may truncate to the other
    side), and the same model, columns and ``static`` memory source."""
    from efficientdepthestimation_tpu.apps import (
        inference_benchmark as jbench,
    )
    from efficientdepthestimation_tpu.apps import test_nyu as jtest_nyu
    from efficientdepthestimation_tpu_torch.apps import (
        inference_benchmark,
        test_nyu,
    )

    _, ckpt_dir = checkpoints["pth"]
    argv = ["-c", ckpt_dir, "--test-csv", workspace["csv"], "-b", "2"]
    _quiet(jtest_nyu.main, argv + ["-o", str(tmp_path / "j")])
    _quiet(test_nyu.main, argv + ["-o", str(tmp_path / "p"), "--device",
                                  "cpu"])
    names = sorted(os.listdir(tmp_path / "p" / "RN18-HU"))
    assert names == sorted(os.listdir(tmp_path / "j" / "RN18-HU"))
    assert len(names) == 6
    for name in names[1::2]:
        _close_levels(_png(tmp_path / "p" / "RN18-HU" / name),
                      _png(tmp_path / "j" / "RN18-HU" / name), name)

    argv = ["-c", ckpt_dir, "-f", workspace["frames"], "-n", "1", "-b", "2"]
    ref = _quiet(jbench.main, argv + ["-o", str(tmp_path / "jb")])
    ours = _quiet(inference_benchmark.main,
                  argv + ["-o", str(tmp_path / "pb"), "--device", "cpu"])
    assert list(ours) == list(ref.index) == ["RN18-HU"]
    assert list(ours["RN18-HU"]) == list(ref.columns)
    assert ours["RN18-HU"][("memory_source", "first")] == "static"
    assert ours["RN18-HU"][("memory_usage", "mean")] > 0
