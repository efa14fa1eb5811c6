"""The port's native host I/O (``efficientdepthestimation_tpu_torch.native``)
against the JAX package's, on the same seeded numpy arrays.

The C++ is the same and so are the system libraries (libpng, libjpeg,
zlib), so every file the port's encoders write must be byte-equal to the
JAX package's, and every batch its decoder returns equal to the JAX
decoder's, PIL's where PIL reads the file losslessly, and within ±1 level
of PIL on JPEG (the IDCT of PIL's bundled libjpeg may round otherwise).
Also: the datasets' ``load_batch`` and ``batch_iterator`` against JAX's,
the writers' and the renderer's native routes, and a concurrent build.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from efficientdepthestimation_tpu_torch import native
from efficientdepthestimation_tpu_torch.native import build as nbuild
from efficientdepthestimation_tpu_torch.native import encoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CSRC = os.path.join(ROOT, "efficientdepthestimation_tpu", "native",
                        "csrc")


def _prebuild_jax_library(source: str, library: str) -> None:
    """Build one of the JAX package's native libraries where its loader
    looks for it, with its own g++ command, through a file of this
    process renamed into place, so that no other test process can load a
    half-written library (the JAX loader compiles in place, ROADMAP C2)."""
    path = os.path.join(JAX_CSRC, library)
    if os.path.exists(path):
        return
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                    os.path.join(JAX_CSRC, source), "-o", tmp, "-lpng",
                    "-ljpeg", "-lz", "-lpthread"], check=True,
                   capture_output=True)
    os.replace(tmp, path)


@pytest.fixture(scope="module")
def jnative():
    """The JAX package's native module, both libraries built; the port's
    libraries built too."""
    assert native.is_available(), native.build_error()
    assert encoder.is_available(), encoder.build_error()
    _prebuild_jax_library("batch_loader.cpp", "libede_loader.so")
    _prebuild_jax_library("encode.cpp", "libede_encoder.so")
    from efficientdepthestimation_tpu import native as jax_native

    assert jax_native.is_available() and jax_native.encoder.is_available()
    return jax_native


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------- decoder

def test_rgb_png_matches_pil_and_jax(jnative, tmp_path, rng):
    paths, refs = [], []
    for i in range(3):
        arr = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(arr).save(paths[-1])
        refs.append(arr)
    out = native.decode_rgb_batch(paths, 48, 64)
    assert out.dtype == np.uint8 and out.shape == (3, 48, 64, 3)
    np.testing.assert_array_equal(out, np.stack(refs))
    np.testing.assert_array_equal(out, jnative.decode_rgb_batch(paths, 48,
                                                                64))
    # into a caller's buffer, on one thread
    buf = np.zeros_like(out)
    assert native.decode_rgb_batch(paths, 48, 64, threads=1, out=buf) is buf
    np.testing.assert_array_equal(buf, out)


def test_rgba_and_gray_png_as_rgb(jnative, tmp_path, rng):
    rgba = rng.integers(0, 256, (16, 24, 4), dtype=np.uint8)
    gray = rng.integers(0, 256, (16, 24), dtype=np.uint8)
    p1, p2 = str(tmp_path / "a.png"), str(tmp_path / "g.png")
    Image.fromarray(rgba).save(p1)
    Image.fromarray(gray).save(p2)
    out = native.decode_rgb_batch([p1, p2], 16, 24)
    np.testing.assert_array_equal(out[0], rgba[..., :3])
    np.testing.assert_array_equal(out[1], np.stack([gray] * 3, -1))
    np.testing.assert_array_equal(out, jnative.decode_rgb_batch([p1, p2], 16,
                                                                24))


def test_jpeg_within_one_level_of_pil(jnative, tmp_path, rng):
    arr = rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
    p = str(tmp_path / "x.jpg")
    Image.fromarray(arr).save(p, quality=95)
    ref = np.asarray(Image.open(p)).astype(int)
    out = native.decode_rgb_batch([p], 32, 40)
    # the same DCT stream; the IDCT's rounding may differ by one level
    assert np.abs(out[0].astype(int) - ref).max() <= 1
    np.testing.assert_array_equal(out, jnative.decode_rgb_batch([p], 32, 40))


@pytest.mark.parametrize("bits", [16, 8])
def test_depth_png(jnative, tmp_path, rng, bits):
    """16-bit grey PNGs exactly; 8-bit ones widened to uint16."""
    if bits == 16:
        arr = rng.integers(0, 10000, (24, 32)).astype(np.uint16)
        Image.fromarray(arr).save(tmp_path / "d.png")  # I;16
    else:
        arr = rng.integers(0, 256, (24, 32), dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / "d.png")
    p = [str(tmp_path / "d.png")]
    out = native.decode_depth16_batch(p, 24, 32)
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out[0], arr.astype(np.uint16))
    np.testing.assert_array_equal(out, jnative.decode_depth16_batch(p, 24,
                                                                    32))


def test_decode_failures_raise(jnative, tmp_path, rng):
    good = str(tmp_path / "ok.png")
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(
        good)
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(
        tmp_path / "rgb_depth.png")
    for mod in (native, jnative):
        with pytest.raises(IOError, match="missing"):
            mod.decode_rgb_batch([good, str(tmp_path / "missing.png")], 8, 8)
        with pytest.raises(IOError):
            mod.decode_rgb_batch([good], 9, 9)  # not the expected size
        with pytest.raises(IOError):  # depth must be grey
            mod.decode_depth16_batch([str(tmp_path / "rgb_depth.png")], 8, 8)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.decode_rgb_batch([good], 8, 8,
                                out=np.zeros((1, 8, 8, 3), np.uint16))


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """A train split (8-bit depth PNGs) and a test split (16-bit), 5 pairs
    each at 48×64, with one CSV each, relative paths."""
    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("native_pairs")
    csvs = {}
    for split, is_test in (("train", False), ("test", True)):
        rows = []
        for i in range(5):
            image = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
            if is_test:
                depth = rng.integers(0, 10000, (48, 64)).astype(np.uint16)
            else:
                depth = rng.integers(0, 256, (48, 64), dtype=np.uint8)
            Image.fromarray(image).save(root / f"{split}_rgb{i}.png")
            Image.fromarray(depth).save(root / f"{split}_d{i}.png")
            rows.append(f"{split}_rgb{i}.png,{split}_d{i}.png\n")
        csvs[split] = root / f"{split}.csv"
        csvs[split].write_text("".join(rows))
    return {k: str(v) for k, v in csvs.items()}


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("split", ["train", "test"])
def test_load_batch_matches_jax_and_pil(jnative, pairs, split, cache):
    from efficientdepthestimation_tpu.data import datasets as jdata
    from efficientdepthestimation_tpu_torch.data import datasets as pdata

    is_test = split == "test"
    ours = pdata.DepthPairDataset(pairs[split], is_test=is_test,
                                  image_hw=(48, 64), cache_in_ram=cache)
    ref = jdata.DepthPairDataset(pairs[split], is_test=is_test,
                                 image_hw=(48, 64), cache_in_ram=cache)
    pil = pdata.DepthPairDataset(pairs[split], is_test=is_test,
                                 use_native=False)
    indices = np.array([3, 0, 4, 4])
    for _ in range(2):  # the second pass, cached or not
        images, depths = ours.load_batch(indices)
        j_images, j_depths = ref.load_batch(indices)
        assert images.dtype == np.uint8 and images.shape == (4, 48, 64, 3)
        assert depths.dtype == (np.uint16 if is_test else np.uint8)
        assert depths.dtype == j_depths.dtype
        np.testing.assert_array_equal(images, j_images)
        np.testing.assert_array_equal(depths, j_depths)
        np.testing.assert_array_equal(
            images, np.stack([pil[int(i)][0] for i in indices]))
        np.testing.assert_array_equal(
            depths, np.stack([pil[int(i)][1] for i in indices]))
    assert sorted(ours._cache) == ([0, 3, 4] if cache else [])
    assert pil.load_batch(indices) is None  # use_native=False


@pytest.mark.parametrize("split", ["train", "test"])
def test_batch_iterator_matches_jax(jnative, pairs, split):
    """Batch for batch, shuffled with a padded tail and after a skip: the
    native route in both packages, and the port's PIL route."""
    from efficientdepthestimation_tpu.data import datasets as jdata
    from efficientdepthestimation_tpu_torch.data import datasets as pdata

    is_test = split == "test"
    kw = dict(shuffle=True, seed=3, pad_last=True)
    for skip in (0, 1):
        ours = list(pdata.batch_iterator(
            pdata.DepthPairDataset(pairs[split], is_test=is_test,
                                   image_hw=(48, 64)), 2, skip_batches=skip,
            **kw))
        ref = list(jdata.batch_iterator(
            jdata.DepthPairDataset(pairs[split], is_test=is_test,
                                   image_hw=(48, 64)), 2, skip_batches=skip,
            **kw))
        pil = list(pdata.batch_iterator(
            pdata.DepthPairDataset(pairs[split], is_test=is_test,
                                   use_native=False), 2, skip_batches=skip,
            **kw))
        assert len(ours) == len(ref) == len(pil) == 3 - skip
        for a, b, c in zip(ours, ref, pil):
            assert a["num_valid"] == b["num_valid"] == c["num_valid"]
            for key in ("image", "depth"):
                assert a[key].dtype == b[key].dtype == c[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
                np.testing.assert_array_equal(a[key], c[key])


def test_load_batch_falls_back_to_pil(pairs, monkeypatch):
    """Files of another size than ``image_hw``, or no library: ``load_batch``
    returns None and ``batch_iterator`` decodes with PIL."""
    from efficientdepthestimation_tpu_torch.data import datasets as pdata

    wrong = pdata.DepthPairDataset(pairs["test"], is_test=True)  # 480×640
    assert wrong.load_batch([0, 1]) is None
    batches = list(pdata.batch_iterator(wrong, 2))
    assert [b["image"].shape for b in batches] == [(2, 48, 64, 3)] * 2 + [
        (1, 48, 64, 3)]
    monkeypatch.setattr(native, "is_available", lambda: False)
    ds = pdata.DepthPairDataset(pairs["test"], is_test=True,
                                image_hw=(48, 64))
    assert ds.load_batch([0]) is None


# ---------------------------------------------------------------- encoder

PNG_ARRAYS = {
    "gray8": ((37, 53), np.uint8),
    "gray8_hw1": ((37, 53, 1), np.uint8),
    "rgb8": ((37, 53, 3), np.uint8),
    "rgba8": ((37, 53, 4), np.uint8),
    "gray16": ((37, 53), np.uint16),
}


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("kind", list(PNG_ARRAYS))
def test_encode_png_byte_equal_to_jax(jnative, tmp_path, kind, level):
    shape, dtype = PNG_ARRAYS[kind]
    rng = np.random.default_rng(level)
    arr = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    ours, ref = tmp_path / "p.png", tmp_path / "j.png"
    encoder.encode_png(str(ours), arr, compress_level=level)
    jnative.encoder.encode_png(str(ref), arr, compress_level=level)
    assert _bytes(ours) == _bytes(ref)
    back = np.asarray(Image.open(ours))
    np.testing.assert_array_equal(back, arr.reshape(back.shape))


def test_encode_png_refuses_what_it_cannot_write(jnative, tmp_path):
    for arr, what in ((np.zeros((4, 4), np.float32), "dtype"),
                      (np.zeros((4, 4, 3), np.uint16), "grayscale-only"),
                      (np.zeros((4, 4, 2), np.uint8), "HW3"),
                      (np.zeros((2, 4, 4, 3), np.uint8), "HW3")):
        with pytest.raises(ValueError, match=what):
            encoder.encode_png(str(tmp_path / "x.png"), arr)
    with pytest.raises(IOError):
        encoder.encode_png(str(tmp_path / "no" / "x.png"),
                           np.zeros((4, 4), np.uint8))


@pytest.mark.parametrize("quality", [75, 90, 95])
@pytest.mark.parametrize("channels", [1, 3])
def test_encode_jpeg_byte_equal_to_jax(jnative, tmp_path, channels, quality):
    yy, xx = np.mgrid[0:40, 0:56]
    rgb = np.stack([xx * 4, yy * 6, (xx + yy) * 2], -1).astype(np.uint8)
    arr = rgb if channels == 3 else rgb[..., 1]
    ours, ref = tmp_path / "p.jpg", tmp_path / "j.jpg"
    encoder.encode_jpeg(str(ours), arr, quality=quality)
    jnative.encoder.encode_jpeg(str(ref), arr, quality=quality)
    assert _bytes(ours) == _bytes(ref)
    back = np.asarray(Image.open(ours))
    assert back.shape == arr.shape
    assert np.abs(back.astype(int) - arr.astype(int)).mean() < 3
    with pytest.raises(ValueError):
        encoder.encode_jpeg(str(ours), np.zeros((4, 4, 4), np.uint8))


def _smooth_frames(n: int, h: int = 48, w: int = 64) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([np.stack([((xx + 3 * i) % w) * 4, yy * 5,
                               np.full_like(xx, 20 * i)], -1)
                     for i in range(n)]).astype(np.uint8)


def _read_video(path: str) -> tuple[np.ndarray, float]:
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        fps = cap.get(cv2.CAP_PROP_FPS)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame[:, :, ::-1])  # BGR -> RGB
    finally:
        cap.release()
    return np.stack(frames), fps


def test_write_mjpeg_avi_byte_equal_to_jax(jnative, tmp_path):
    frames = _smooth_frames(10)
    ours, ref = str(tmp_path / "p.avi"), str(tmp_path / "j.avi")
    encoder.write_mjpeg_avi(ours, frames, fps=24, quality=92)
    jnative.encoder.write_mjpeg_avi(ref, frames, fps=24, quality=92)
    assert _bytes(ours) == _bytes(ref)
    read, fps = _read_video(ours)
    assert read.shape == frames.shape and fps == pytest.approx(24.0)
    # MJPEG at quality 92 on smooth content (JAX's bound)
    assert np.abs(read.astype(int) - frames.astype(int)).mean() < 5
    with pytest.raises(ValueError):
        encoder.write_mjpeg_avi(ours, frames[..., 0])


def test_native_video_writer_byte_equal_to_jax(jnative, tmp_path):
    frames = _smooth_frames(7, 32, 48)
    paths = {}
    for key, cls in (("p", encoder.NativeVideoWriter),
                     ("j", jnative.encoder.NativeVideoWriter)):
        paths[key] = str(tmp_path / key / "stream.avi")  # a new directory
        with cls(paths[key], (48, 32), fps=30) as writer:
            for frame in frames:
                writer.write(frame)
    assert _bytes(paths["p"]) == _bytes(paths["j"])
    read, fps = _read_video(paths["p"])
    assert len(read) == 7 and fps == pytest.approx(30.0)
    writer = encoder.NativeVideoWriter(str(tmp_path / "x.avi"), (48, 32))
    with pytest.raises(ValueError, match="RGB frame"):
        writer.write(frames[0, :16])
    writer.release()
    with pytest.raises(IOError, match="closed"):
        writer.write(frames[0])


# ---------------------------------------------------------------- writers

def test_async_image_writer_matches_jax(jnative, tmp_path, rng):
    """PNG (uint8 RGB, uint16 grey) and JPG (uint8 grey, RGB) through the
    native encoders, byte-equal to the JAX writer's; a float array through
    PIL."""
    from efficientdepthestimation_tpu.utils import AsyncImageWriter as JWriter
    from efficientdepthestimation_tpu_torch.utils.async_writer import (
        AsyncImageWriter,
    )

    arrays = {"rgb.png": rng.integers(0, 256, (32, 48, 3), dtype=np.uint8),
              "d16.png": rng.integers(0, 65536, (32, 48)).astype(np.uint16),
              "g.jpg": rng.integers(0, 256, (32, 48), dtype=np.uint8),
              "c.jpeg": rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)}
    for key, cls in (("p", AsyncImageWriter), ("j", JWriter)):
        (tmp_path / key).mkdir()
        with cls(num_workers=2) as writer:
            for name, arr in arrays.items():
                writer.submit(arr, str(tmp_path / key / name))
    for name, arr in arrays.items():
        ours = _bytes(tmp_path / "p" / name)
        assert ours == _bytes(tmp_path / "j" / name), name
        encoder_out = tmp_path / f"direct-{name}"
        if name.endswith(".png"):
            encoder.encode_png(str(encoder_out), arr)
            np.testing.assert_array_equal(
                np.asarray(Image.open(tmp_path / "p" / name)), arr)
        else:
            encoder.encode_jpeg(str(encoder_out), arr)
        assert ours == _bytes(encoder_out), name
    f32 = rng.random((8, 8)).astype(np.float32)
    with AsyncImageWriter(num_workers=1) as writer:
        writer.submit(f32, str(tmp_path / "f.tiff"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "f.tiff")),
                                  f32)


@pytest.mark.parametrize("native_arg", [None, True])
def test_async_video_writer_matches_jax(jnative, tmp_path, native_arg):
    """BGR frames submitted out of order: the native route's file is
    byte-equal to the JAX writer's (both swap to RGB)."""
    from efficientdepthestimation_tpu.utils import AsyncVideoWriter as JWriter
    from efficientdepthestimation_tpu_torch.utils.async_writer import (
        AsyncVideoWriter,
    )

    frames = _smooth_frames(5, 32, 48)[..., ::-1]  # BGR
    order = (1, 0, 2, 4, 3)
    paths = {}
    for key, cls in (("p", AsyncVideoWriter), ("j", JWriter)):
        paths[key] = str(tmp_path / f"{key}.avi")
        writer = cls(paths[key], (48, 32), fps=24.0, native=native_arg)
        for i in order:
            writer.submit(frames[i], index=i)
        writer.cleanup()
    assert _bytes(paths["p"]) == _bytes(paths["j"])
    read, _ = _read_video(paths["p"])
    assert np.abs(read[..., ::-1].astype(int)
                  - frames.astype(int)).mean() < 5


# ---------------------------------------------------- test_nyu and renderer

def test_test_nyu_writers_byte_equal_to_jax(jnative, tmp_path, rng):
    """``write_depth`` (16-bit PNG) and ``write_preview`` (JPEG at libjpeg's
    quality 90) of the same arrays: the JAX package's bytes."""
    from efficientdepthestimation_tpu.apps import test_nyu as jtest_nyu
    from efficientdepthestimation_tpu_torch.apps import test_nyu

    depth_mm = rng.uniform(0.0, 9999.0, (48, 64)).astype(np.float32)
    for fn in ("write_depth", "write_preview"):
        arr = depth_mm if fn == "write_depth" else depth_mm / 10000.0
        ext = "png" if fn == "write_depth" else "jpg"
        ours, ref = tmp_path / f"p.{ext}", tmp_path / f"j.{ext}"
        getattr(test_nyu, fn)(arr, str(ours))
        getattr(jtest_nyu, fn)(arr, str(ref))
        assert _bytes(ours) == _bytes(ref), fn
    with Image.open(ours) as img:
        assert img.quantization[0][:4] == [3, 2, 2, 3]  # quality 90


def test_rendered_sweep_native_and_pil_routes(tmp_path):
    """``create_rendered_images`` on the CPU: the native route writes an
    MJPEG AVI of every view (cv2 reads it within JAX's mean bound of 5 of
    the rendered frames) and PNG stills equal to the PIL route's."""
    import torch

    from efficientdepthestimation_tpu_torch.benchmark import renderer

    h, w, fps = 24, 32, 2
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    image = np.stack([xx / w, yy / h, (xx + yy) / (h + w)], -1)
    depth = 1.0 + 0.5 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    samples = [{"image": image, "depth": depth},
               {"image": image[::-1].copy(), "depth": depth[:, ::-1].copy()}]
    routes = {}
    for route in ("native", "pil"):
        out = str(tmp_path / route)
        if route == "pil":
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(encoder, "is_available", lambda: False)
                renderer.create_rendered_images(out, samples, fps=fps,
                                                device="cpu")
        else:
            renderer.create_rendered_images(out, samples, fps=fps,
                                            device="cpu")
        routes[route] = out
    views = torch.from_numpy(renderer.sweep_views(fps))
    image01, depth01 = renderer.sweep_inputs(samples[0])
    frames = renderer.render_novel_views_mesh(
        torch.from_numpy(image01), torch.from_numpy(depth01), views,
        fov_y_deg=18.0, displacement_factor=4.0, mesh_density=8)
    frames = (torch.clamp(frames, 0.0, 1.0) * 255.0).to(torch.uint8).numpy()
    read, rate = _read_video(os.path.join(routes["native"], "video",
                                          "000000.avi"))
    assert read.shape == frames.shape == (len(views), h, w, 3)
    assert rate == pytest.approx(fps)
    assert np.abs(read.astype(int) - frames.astype(int)).mean() < 5
    with open(os.path.join(routes["native"], "video", "000000.avi"),
              "rb") as f:
        head = f.read(512)
    assert head[:4] == b"RIFF" and b"MJPG" in head
    for i in range(len(samples)):
        stills = sorted(os.listdir(os.path.join(routes["native"], "image",
                                                f"{i:06d}")))
        assert stills == sorted(os.listdir(os.path.join(
            routes["pil"], "image", f"{i:06d}")))
        assert stills == [f"{k:06d}.png" for k in range(
            renderer.INITIAL_DELAY, len(views), fps)]
        for name in stills:
            a = np.asarray(Image.open(os.path.join(
                routes["native"], "image", f"{i:06d}", name)))
            b = np.asarray(Image.open(os.path.join(
                routes["pil"], "image", f"{i:06d}", name)))
            np.testing.assert_array_equal(a, b)
            if i == 0:
                np.testing.assert_array_equal(a, frames[int(name[:6])])
    assert not [f for f in os.listdir(os.path.join(routes["native"],
                                                   "video"))
                if f.startswith(".tmp")]


# ------------------------------------------------------------------ build

def test_build_failure_is_recorded(tmp_path, monkeypatch):
    """A source that does not compile: ``get()`` gives None (callers take
    PIL or cv2), the compiler's message is kept and warned, and nothing
    half-built is left."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(nbuild, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "build")
    lib = nbuild.Library("broken", lambda _: None)
    with pytest.warns(UserWarning, match="native broken build failed"):
        assert lib.get() is None
    assert "g++ failed for broken.cpp" in lib.error and "error" in lib.error
    assert lib.get() is None  # not retried
    assert os.listdir(tmp_path / "build") == []


def test_library_named_by_source_and_flags(tmp_path, monkeypatch):
    (tmp_path / "a.cpp").write_text('extern "C" int f() { return 1; }\n')
    monkeypatch.setattr(nbuild, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "build")
    first = nbuild.target("a")
    assert first.parent == tmp_path / "build"
    assert first.name.startswith("liba-") and first.suffix == ".so"
    monkeypatch.setattr(nbuild, "GXX_FLAGS", nbuild.GXX_FLAGS + ("-g",))
    assert nbuild.target("a") != first
    (tmp_path / "a.cpp").write_text('extern "C" int f() { return 2; }\n')
    monkeypatch.setattr(nbuild, "GXX_FLAGS", nbuild.GXX_FLAGS[:-1])
    assert nbuild.target("a") != first


def test_build_renames_a_file_of_its_own_into_place(tmp_path, monkeypatch):
    """The compiler writes a file named for this process and thread; the
    library's path appears only by the rename, whole; a second build finds
    it and runs no compiler."""
    (tmp_path / "a.cpp").write_text('extern "C" int f() { return 7; }\n')
    monkeypatch.setattr(nbuild, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "build")
    so, calls, real_run = nbuild.target("a"), [], subprocess.run

    def run(cmd, **kwargs):
        out = cmd[cmd.index("-o") + 1]
        calls.append(out)
        assert out != str(so) and str(os.getpid()) in out
        assert not so.exists()
        return real_run(cmd, **kwargs)

    monkeypatch.setattr(nbuild.subprocess, "run", run)
    assert nbuild.build("a") == so and len(calls) == 1
    assert os.listdir(so.parent) == [so.name]
    assert nbuild.build("a") == so and len(calls) == 1
    import ctypes

    assert ctypes.CDLL(str(so)).f() == 7


_CONCURRENT_BUILD = """
import sys
from pathlib import Path
from efficientdepthestimation_tpu_torch.native import build, encoder, loader
build.BUILD_DIR = Path(sys.argv[1])
assert loader.is_available() and encoder.is_available(), (
    loader.build_error(), encoder.build_error())
import numpy as np
frame = np.arange(8 * 12 * 3, dtype=np.uint8).reshape(8, 12, 3)
encoder.encode_png(sys.argv[2], frame)
out = loader.decode_rgb_batch([sys.argv[2]], 8, 12)
assert (out[0] == frame).all()
print(loader._LIBRARY.get()._name, encoder._LIBRARY.get()._name)
"""


def test_two_processes_build_into_one_fresh_directory(tmp_path):
    """Two processes build both libraries into one empty build directory
    at the same time; each loads a whole library and uses it, and no
    temporary file is left (each writes its own and renames it)."""
    build_dir = tmp_path / "build"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CONCURRENT_BUILD, str(build_dir),
         str(tmp_path / f"{i}.png")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for i in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err[-2000:]
    names = {os.path.basename(n) for out, _ in outs for n in out.split()}
    assert sorted(os.listdir(build_dir)) == sorted(names)
    assert len(names) == 2
