"""Host-side datasets and batching: decode PNGs to raw numpy arrays; the
math happens on the device (``data/transforms.py``).

Counterpart of ``efficientdepthestimation_tpu/data/datasets.py``. A dataset
is anything with ``len`` and ``__getitem__`` returning ``(image, depth)``
arrays (or a lone image): ``DepthPairDataset`` (a PNG/CSV split),
``VideoFrameDataset`` (a directory of frames), or an in-memory list such as
``data.synthetic_nyu.synthetic_train_set``. Files are decoded with PIL,
imported where a file is read; the JAX package's native C++ batch decoder
(``load_batch``) is ROADMAP A14. PNG is lossless, so the arrays are the same
either way.
"""

from __future__ import annotations

import concurrent.futures as cf
import csv
import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

__all__ = ["DepthPairDataset", "VideoFrameDataset", "batch_iterator"]


def _load_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def _load_depth(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr


@dataclass
class DepthPairDataset:
    """CSV of (image path, depth path) rows (ReSIDE/loaddata.py:7-29);
    relative paths are read from the CSV's own directory.

    ``is_test`` names the depth-encoding convention of the split: 16-bit mm
    PNGs for the test split, 8-bit (×25.5/m) PNGs for training
    (nyu_transform.py:170-175); PIL returns each as stored. ``image_hw`` is
    the frame size of the split (the native batch decoder of A14 needs it).
    ``cache_in_ram`` keeps decoded pairs after first touch, so that epochs
    after the first skip the decode (~1.2 GB per 1000 NYU-sized pairs).
    """

    csv_file: str
    is_test: bool = False
    image_hw: tuple[int, int] = (480, 640)
    cache_in_ram: bool = False

    def __post_init__(self):
        root = os.path.dirname(os.path.abspath(self.csv_file))
        self.rows: list[tuple[str, str]] = []
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        with open(self.csv_file, newline="") as f:
            for row in csv.reader(f):
                if not row:
                    continue
                image, depth = row[0].strip(), row[1].strip()
                if not os.path.isabs(image):
                    image = os.path.join(root, image)
                if not os.path.isabs(depth):
                    depth = os.path.join(root, depth)
                self.rows.append((image, depth))

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        if self.cache_in_ram and idx in self._cache:
            return self._cache[idx]
        image_path, depth_path = self.rows[idx]
        pair = _load_rgb(image_path), _load_depth(depth_path)
        if self.cache_in_ram:
            self._cache[idx] = pair
        return pair


@dataclass
class VideoFrameDataset:
    """Sorted directory of frames (inference_benchmark.py:91-107)."""

    frames_dir: str
    extensions: tuple[str, ...] = (".png", ".jpg", ".jpeg", ".bmp")

    def __post_init__(self):
        self.files = sorted(
            os.path.join(self.frames_dir, f)
            for f in os.listdir(self.frames_dir)
            if f.lower().endswith(self.extensions)
        )

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        return _load_rgb(self.files[idx])


def batch_iterator(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    num_workers: int = 4,
    drop_last: bool = False,
    pad_last: bool = False,
    skip_batches: int = 0,
) -> Iterator[dict]:
    """Yield stacked numpy batches, fetching samples on a thread pool.

    ``pad_last`` repeats the final sample so every batch has the same shape;
    the true count is reported as ``num_valid``. ``skip_batches``
    fast-forwards past the first N batches without fetching them: with the
    same (shuffle, seed) the remaining batches are those of a full pass,
    which is what an exact mid-epoch resume needs.
    """
    indices = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(indices)
    indices = indices[skip_batches * batch_size:]

    def fetch(i):
        return dataset[int(i)]

    with cf.ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        for start in range(0, len(indices), batch_size):
            chunk = indices[start:start + batch_size]
            if len(chunk) < batch_size:
                if drop_last:
                    return
                if pad_last:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], batch_size - len(chunk))]
                    )
            num_valid = min(batch_size, len(indices) - start)
            samples = list(pool.map(fetch, chunk))
            if isinstance(samples[0], tuple):
                images = np.stack([s[0] for s in samples])
                depths = np.stack([s[1] for s in samples])
                yield {"image": images, "depth": depths,
                       "num_valid": num_valid}
            else:
                yield {"image": np.stack(samples), "num_valid": num_valid}
