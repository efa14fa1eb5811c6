"""Asynchronous image and video writers (host I/O).

Copies of ``AsyncImageWriter`` and ``AsyncVideoWriter`` from
``efficientdepthestimation_tpu/utils/async_writer.py``, the writers the
reference uses to overlap disk writes with inference
(ReSIDE/test_nyu.py:19-22,82-97; Benchmark/benchmark.py:947-962). Images
and video go through the native C++ encoders (``native.encoder``) where
the library is built, as in the JAX package; otherwise images are encoded
by PIL and video by cv2, each imported where it is first used.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Callable

import numpy as np

__all__ = ["AsyncImageWriter", "AsyncVideoWriter"]


class AsyncImageWriter:
    """Writes images on a worker pool; ``write`` may be overridden, or a
    ``writer`` passed per image.

    ``.png`` of uint8 (HW, HW1, HW3, HW4) or uint16 HW, and ``.jpg`` of
    uint8 HW or HW3, go through the native encoders where the library is
    built (libpng at zlib level 6, libjpeg at quality 90); anything else,
    or a native write that fails, through PIL."""

    def __init__(self, num_workers: int = 4):
        self.pool = cf.ThreadPoolExecutor(max_workers=num_workers)
        self._futures: list[cf.Future] = []

    def write(self, image: np.ndarray, path: str):
        from efficientdepthestimation_tpu_torch.native import encoder

        image = np.asarray(image)
        lower = path.lower()
        if encoder.is_available():
            try:
                if lower.endswith(".png") and (
                        image.dtype == np.uint8
                        or (image.dtype == np.uint16 and image.ndim == 2)):
                    return encoder.encode_png(path, image)
                if lower.endswith((".jpg", ".jpeg")) \
                        and image.dtype == np.uint8 \
                        and (image.ndim == 2 or (image.ndim == 3
                                                 and image.shape[2] == 3)):
                    return encoder.encode_jpeg(path, image)
            except (IOError, ValueError):
                pass  # PIL below
        from PIL import Image

        Image.fromarray(image).save(path)

    def submit(self, image: np.ndarray, path: str,
               writer: Callable | None = None):
        fn = writer or self.write
        self._futures.append(self.pool.submit(fn, image, path))

    def cleanup(self):
        try:
            for fut in self._futures:
                fut.result()
        finally:
            self._futures.clear()
            self.pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.cleanup()


class AsyncVideoWriter:
    """Orders frames by index and streams them to a video writer.

    ``native=None`` takes the native streaming MJPEG/AVI writer
    (``native.encoder.NativeVideoWriter``) where the library is built, else
    a cv2 ``VideoWriter`` with the given fourcc, the reference's DIVX path
    (depth_video.py:88-91); ``True`` asks for the native writer (and raises
    if it is not built), ``False`` for cv2. Frames are **BGR**, the cv2
    convention of the reference and the callers; the native route swaps
    them to RGB.
    """

    def __init__(self, path: str, size_wh: tuple[int, int], fps: float = 24.0,
                 fourcc: str = "DIVX", native: bool | None = None):
        from efficientdepthestimation_tpu_torch.native import encoder

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if native is None:
            native = encoder.is_available()
        if native:
            self.writer = encoder.NativeVideoWriter(path, size_wh,
                                                    fps=round(fps))
            self._write = lambda f: self.writer.write(
                np.ascontiguousarray(f[:, :, ::-1]))  # BGR -> RGB
        else:
            import cv2

            self.writer = cv2.VideoWriter(
                path, cv2.VideoWriter_fourcc(*fourcc), fps, size_wh)
            self._write = self.writer.write
        self._next = 0
        self._pending: dict[int, np.ndarray] = {}

    def submit(self, frame: np.ndarray, index: int | None = None):
        index = self._next if index is None else index
        self._pending[index] = frame
        while self._next in self._pending:
            self._write(self._pending.pop(self._next))
            self._next += 1

    def cleanup(self):
        for index in sorted(self._pending):
            self._write(self._pending.pop(index))
        self.writer.release()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.cleanup()
