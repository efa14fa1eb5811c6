"""Asynchronous image and video writers (host I/O).

Copies of ``AsyncImageWriter`` and ``AsyncVideoWriter`` from
``efficientdepthestimation_tpu/utils/async_writer.py``, the writers the
reference uses to overlap disk writes with inference
(ReSIDE/test_nyu.py:19-22,82-97; Benchmark/benchmark.py:947-962). Images
are encoded by PIL and video by cv2, each imported where it is first
used; the JAX package's native PNG/JPEG/MJPEG encoders are ROADMAP A14.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Callable

import numpy as np

__all__ = ["AsyncImageWriter", "AsyncVideoWriter"]


class AsyncImageWriter:
    """Writes images on a worker pool; ``write`` may be overridden, or a
    ``writer`` passed per image."""

    def __init__(self, num_workers: int = 4):
        self.pool = cf.ThreadPoolExecutor(max_workers=num_workers)
        self._futures: list[cf.Future] = []

    def write(self, image: np.ndarray, path: str):
        from PIL import Image

        Image.fromarray(np.asarray(image)).save(path)

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
    """Orders frames by index and streams them to a cv2 ``VideoWriter``
    with the given fourcc, the reference's DIVX path (depth_video.py:88-91).
    Frames are **BGR**, the cv2 convention of the reference and the callers.

    ``native=None`` takes the cv2 route: the JAX package's native streaming
    MJPEG writer, which ``None`` picks there where it is built, is not
    ported (ROADMAP A14), and ``native=True`` raises naming that item.
    """

    def __init__(self, path: str, size_wh: tuple[int, int], fps: float = 24.0,
                 fourcc: str = "DIVX", native: bool | None = None):
        if native:
            raise NotImplementedError("the native video writer is not "
                                      "ported yet: ROADMAP item A14")
        import cv2

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*fourcc), fps, size_wh)
        self._next = 0
        self._pending: dict[int, np.ndarray] = {}

    def submit(self, frame: np.ndarray, index: int | None = None):
        index = self._next if index is None else index
        self._pending[index] = frame
        while self._next in self._pending:
            self.writer.write(self._pending.pop(self._next))
            self._next += 1

    def cleanup(self):
        for index in sorted(self._pending):
            self.writer.write(self._pending.pop(index))
        self.writer.release()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.cleanup()
