"""Asynchronous image writer (thread-pooled host I/O).

A copy of ``AsyncImageWriter`` from
``efficientdepthestimation_tpu/utils/async_writer.py``, the writer the
reference uses to overlap disk writes with inference
(ReSIDE/test_nyu.py:19-22,82-97). It encodes with PIL, imported where a
file is written; the JAX package's native PNG/JPEG encoders are ROADMAP A14,
and ``AsyncVideoWriter`` comes with the video apps (A9).
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Callable

import numpy as np

__all__ = ["AsyncImageWriter"]


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
