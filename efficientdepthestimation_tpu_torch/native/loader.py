"""ctypes bindings for the C++ batch image decoder (``csrc/batch_loader.cpp``).

Counterpart of ``efficientdepthestimation_tpu/native/loader.py``: PNG and
JPEG files decoded on a C++ thread pool into one contiguous numpy batch,
in place of a PIL decode a sample. The library is built at first use
(``native.build``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from efficientdepthestimation_tpu_torch.native.build import Library

__all__ = ["build_library", "build_error", "is_available",
           "decode_rgb_batch", "decode_depth16_batch"]


def _declare(lib: ctypes.CDLL) -> None:
    for name, pixel in (("ede_decode_rgb_batch", ctypes.c_uint8),
                        ("ede_decode_depth16_batch", ctypes.c_uint16)):
        fn = getattr(lib, name)
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.POINTER(pixel), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        fn.restype = None


_LIBRARY = Library("batch_loader", _declare)


def build_library(force: bool = False) -> str | None:
    """Compile the decoder (g++ -O3, links png/jpeg/z/pthread); its path,
    or None if the build failed (``build_error()`` says why)."""
    return _LIBRARY.build(force)


def build_error() -> str | None:
    """The compiler's or loader's message if the library is unavailable."""
    return _LIBRARY.error


def is_available() -> bool:
    return _LIBRARY.get() is not None


def _paths_array(paths: list[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def _decode(fn_name: str, paths: list[str], out: np.ndarray | None,
            shape: tuple[int, ...], pixel, height: int, width: int,
            threads: int | None) -> np.ndarray:
    lib = _LIBRARY.get()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    n = len(paths)
    dtype = np.dtype(pixel)
    if out is None:
        out = np.empty(shape, dtype)
    elif out.shape != shape or out.dtype != dtype \
            or not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError(f"out must be a writeable C-contiguous {dtype} "
                         f"array of shape {shape}")
    status = (ctypes.c_int * n)()
    threads = threads or min(os.cpu_count() or 1, n)
    getattr(lib, fn_name)(
        _paths_array(paths), n, out.ctypes.data_as(ctypes.POINTER(pixel)),
        height, width, threads, status)
    failed = [paths[i] for i in range(n) if not status[i]]
    if failed:
        raise IOError(f"native decode failed for: {failed[:3]}")
    return out


def decode_rgb_batch(paths: list[str], height: int, width: int,
                     threads: int | None = None,
                     out: np.ndarray | None = None) -> np.ndarray:
    """Decode PNG/JPEG files → (N, H, W, 3) uint8. Raises on any failure."""
    return _decode("ede_decode_rgb_batch", paths, out,
                   (len(paths), height, width, 3), ctypes.c_uint8, height,
                   width, threads)


def decode_depth16_batch(paths: list[str], height: int, width: int,
                         threads: int | None = None,
                         out: np.ndarray | None = None) -> np.ndarray:
    """Decode grayscale PNGs → (N, H, W) uint16 (8-bit inputs widened)."""
    return _decode("ede_decode_depth16_batch", paths, out,
                   (len(paths), height, width), ctypes.c_uint16, height,
                   width, threads)
