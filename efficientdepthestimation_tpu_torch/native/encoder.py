"""ctypes bindings for the C++ image and video encoders (``csrc/encode.cpp``).

Counterpart of ``efficientdepthestimation_tpu/native/encoder.py``, the
write side of ``native.loader``: PNG through libpng at a caller-chosen zlib
level, JPEG and MJPEG-in-AVI through libjpeg (libjpeg-turbo's SIMD where
installed), batch frame encodes on a C++ thread pool. The library is built
at first use (``native.build``). The files carry no timestamp, so the same
arrays and system libraries give the same bytes as the JAX package's.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from efficientdepthestimation_tpu_torch.native.build import Library

__all__ = ["build_library", "build_error", "is_available", "encode_png",
           "encode_jpeg", "write_mjpeg_avi", "NativeVideoWriter"]

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _declare(lib: ctypes.CDLL) -> None:
    i64, cint = ctypes.c_int64, ctypes.c_int
    signatures = {
        "ede_encode_png": ([ctypes.c_char_p, _U8P, i64, i64, cint, cint,
                            cint], cint),
        "ede_encode_jpeg": ([ctypes.c_char_p, _U8P, i64, i64, cint, cint],
                            cint),
        "ede_write_mjpeg_avi": ([ctypes.c_char_p, _U8P, i64, i64, i64, cint,
                                 cint, cint], cint),
        "ede_avi_open": ([ctypes.c_char_p, i64, i64, cint, cint],
                         ctypes.c_void_p),
        "ede_avi_append": ([ctypes.c_void_p, _U8P], cint),
        "ede_avi_close": ([ctypes.c_void_p], cint),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype


_LIBRARY = Library("encode", _declare)


def build_library(force: bool = False) -> str | None:
    """Compile the encoder (g++ -O3, links png/jpeg/z/pthread); its path,
    or None if the build failed (``build_error()`` says why)."""
    return _LIBRARY.build(force)


def build_error() -> str | None:
    """The compiler's or loader's message if the library is unavailable."""
    return _LIBRARY.error


def is_available() -> bool:
    return _LIBRARY.get() is not None


def _lib() -> ctypes.CDLL:
    lib = _LIBRARY.get()
    if lib is None:
        raise RuntimeError("native encoder unavailable")
    return lib


def _pixels(image: np.ndarray):
    return image.ctypes.data_as(_U8P)


def encode_png(path: str, image: np.ndarray, compress_level: int = 6) -> None:
    """uint8 HW / HW1 / HW3 / HW4, or uint16 HW (16-bit grayscale PNG)."""
    lib = _lib()
    image = np.ascontiguousarray(image)
    bit16 = image.dtype == np.uint16
    if not bit16 and image.dtype != np.uint8:
        raise ValueError(f"unsupported dtype {image.dtype}")
    if image.ndim not in (2, 3) or (image.ndim == 3
                                    and image.shape[2] not in (1, 3, 4)):
        raise ValueError(f"expected HW, HW1, HW3 or HW4, got {image.shape}")
    channels = 1 if image.ndim == 2 else image.shape[2]
    if bit16 and channels != 1:
        raise ValueError("16-bit PNG is grayscale-only")
    ok = lib.ede_encode_png(path.encode(), _pixels(image), image.shape[0],
                            image.shape[1], channels, int(bit16),
                            int(compress_level))
    if not ok:
        raise IOError(f"native PNG encode failed: {path}")


def encode_jpeg(path: str, image: np.ndarray, quality: int = 90) -> None:
    """uint8 HW3 RGB or uint8 HW grayscale."""
    lib = _lib()
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) \
            or (image.ndim == 3 and image.shape[2] != 3):
        raise ValueError("expected uint8 HW3 RGB or HW grayscale")
    channels = 1 if image.ndim == 2 else 3
    ok = lib.ede_encode_jpeg(path.encode(), _pixels(image), image.shape[0],
                             image.shape[1], int(quality), channels)
    if not ok:
        raise IOError(f"native JPEG encode failed: {path}")


def write_mjpeg_avi(path: str, frames_rgb: np.ndarray, fps: int = 24,
                    quality: int = 90, threads: int | None = None) -> None:
    """(N, H, W, 3) uint8 RGB → one MJPEG .avi (RIFF AVI 1.0)."""
    lib = _lib()
    frames_rgb = np.ascontiguousarray(frames_rgb)
    if frames_rgb.dtype != np.uint8 or frames_rgb.ndim != 4 \
            or frames_rgb.shape[3] != 3:
        raise ValueError("expected uint8 NHW3 RGB frames")
    n, h, w, _ = frames_rgb.shape
    threads = threads or min(os.cpu_count() or 1, n)
    ok = lib.ede_write_mjpeg_avi(path.encode(), _pixels(frames_rgb), n, h, w,
                                 int(fps), int(quality), int(threads))
    if not ok:
        raise IOError(f"native MJPEG/AVI encode failed: {path}")


class NativeVideoWriter:
    """Streaming MJPEG/AVI writer: open → append RGB frames → close.

    The container fields that depend on the frame count are patched at
    close, so a video of any length streams without being held in memory
    (depth_video's 3840×1080 side-by-side frames)."""

    def __init__(self, path: str, size_wh: tuple[int, int], fps: int = 24,
                 quality: int = 90):
        self._lib = _lib()
        self._w, self._h = int(size_wh[0]), int(size_wh[1])
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._handle = self._lib.ede_avi_open(path.encode(), self._h,
                                              self._w, int(fps),
                                              int(quality))
        if not self._handle:
            raise IOError(f"native AVI open failed: {path}")

    def write(self, frame_rgb: np.ndarray) -> None:
        frame_rgb = np.ascontiguousarray(frame_rgb)
        if frame_rgb.dtype != np.uint8 \
                or frame_rgb.shape != (self._h, self._w, 3):
            raise ValueError(
                f"expected uint8 ({self._h}, {self._w}, 3) RGB frame, got "
                f"{frame_rgb.dtype} {frame_rgb.shape}")
        if not self._handle:
            raise IOError("native AVI writer is closed")
        if not self._lib.ede_avi_append(self._handle, _pixels(frame_rgb)):
            raise IOError("native AVI append failed")

    def release(self) -> None:
        if self._handle:
            ok = self._lib.ede_avi_close(self._handle)
            self._handle = None
            if not ok:
                raise IOError("native AVI close failed")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.release()
