"""Benchmark datasets + host transforms (Benchmark/benchmark.py:157-487).

Counterpart of ``efficientdepthestimation_tpu/benchmark/datasets.py``.
Three dataset shapes (CSV pairs with optional ``camera.json`` intrinsics,
flat image folder with ``.raw`` support, nested per-sample folders), the
MiDaS aspect-keeping ``Resize`` with ``ensure_multiple_of``, and the
ratio-aware ``CenterCrop``. All host-side (cv2/PIL/numpy), imported where
an image is read or resized; these feed the device pipeline as raw arrays.
The CSV is read with the ``csv`` module, which gives the same two columns
as the JAX package's ``pandas.read_csv(header=None)``.
"""

from __future__ import annotations

import csv
import json
import os
import warnings
from pathlib import Path

import numpy as np

from efficientdepthestimation_tpu_torch.utils import image_io

__all__ = ["MidasResize", "RatioCenterCrop", "DepthDataset",
           "ImageFolderDataset", "NestedImageFolderDataset", "nyu_eval_sample"]


class MidasResize:
    """Aspect-keeping resize with lower/upper/minimal bound modes and
    ``ensure_multiple_of`` (benchmark.py:157-308). Operates on numpy samples
    {'image', 'depth'[, 'disparity', 'mask']}; image via the given cv2
    interpolation, targets via nearest."""

    def __init__(self, width, height, resize_target=True, keep_aspect_ratio=False,
                 ensure_multiple_of=1, resize_method="lower_bound",
                 image_interpolation_method=None):
        import cv2

        self.width = width
        self.height = height
        self.resize_target = resize_target
        self.keep_aspect_ratio = keep_aspect_ratio
        self.multiple_of = ensure_multiple_of
        self.resize_method = resize_method
        self.image_interpolation = (cv2.INTER_AREA if image_interpolation_method
                                    is None else image_interpolation_method)

    def constrain_to_multiple_of(self, x, min_val=0, max_val=None):
        y = int(np.round(x / self.multiple_of) * self.multiple_of)
        if max_val is not None and y > max_val:
            y = int(np.floor(x / self.multiple_of) * self.multiple_of)
        if y < min_val:
            y = int(np.ceil(x / self.multiple_of) * self.multiple_of)
        return y

    def get_size(self, width, height):
        scale_height = self.height / height
        scale_width = self.width / width

        if self.keep_aspect_ratio:
            if self.resize_method == "lower_bound":
                scale = max(scale_width, scale_height)
            elif self.resize_method == "upper_bound":
                scale = min(scale_width, scale_height)
            elif self.resize_method == "minimal":
                scale = (scale_width if abs(1 - scale_width) < abs(1 - scale_height)
                         else scale_height)
            else:
                raise ValueError(f"resize_method {self.resize_method} not implemented")
            scale_width = scale_height = scale

        if self.resize_method == "lower_bound":
            new_height = self.constrain_to_multiple_of(scale_height * height,
                                                       min_val=self.height)
            new_width = self.constrain_to_multiple_of(scale_width * width,
                                                      min_val=self.width)
        elif self.resize_method == "upper_bound":
            new_height = self.constrain_to_multiple_of(scale_height * height,
                                                       max_val=self.height)
            new_width = self.constrain_to_multiple_of(scale_width * width,
                                                      max_val=self.width)
        elif self.resize_method == "minimal":
            new_height = self.constrain_to_multiple_of(scale_height * height)
            new_width = self.constrain_to_multiple_of(scale_width * width)
        else:
            raise ValueError(f"resize_method {self.resize_method} not implemented")
        return new_width, new_height

    def __call__(self, sample: dict) -> dict:
        import cv2

        sample = {k: np.asarray(v) for k, v in sample.items()}
        width, height = self.get_size(sample["image"].shape[1],
                                      sample["image"].shape[0])
        sample["image"] = cv2.resize(sample["image"], (width, height),
                                     interpolation=self.image_interpolation)
        if self.resize_target:
            for key in ("disparity", "depth"):
                if key in sample:
                    sample[key] = cv2.resize(sample[key], (width, height),
                                             interpolation=cv2.INTER_NEAREST)
            if "mask" in sample:
                mask = cv2.resize(sample["mask"].astype(np.float32),
                                  (width, height), interpolation=cv2.INTER_NEAREST)
                sample["mask"] = mask.astype(bool)
        return sample


class RatioCenterCrop:
    """Center crop to absolute ints or even-rounded float ratios
    (benchmark.py:311-349)."""

    def __init__(self, size):
        self.size = size
        assert all(isinstance(x, type(size[0])) for x in size), \
            "Sizes must all be the same type."
        if isinstance(size[0], float):
            assert all(0.0 < x < 1.0 for x in size), \
                "Float values must be a ratio between 0.0 and 1.0"

    def _crop(self, arr: np.ndarray) -> np.ndarray:
        h1, w1 = arr.shape[:2]
        tw, th = self.size
        if isinstance(tw, float) or isinstance(th, float):
            tw = 2 * round(tw * w1 / 2)
            th = 2 * round(th * h1 / 2)
        if (w1, h1) == (tw, th):
            return arr
        x1 = int(round((w1 - tw) / 2.0))
        y1 = int(round((h1 - th) / 2.0))
        return arr[y1:y1 + th, x1:x1 + tw]

    def __call__(self, sample: dict) -> dict:
        return {k: self._crop(np.asarray(v)) for k, v in sample.items()}


class DepthDataset:
    """CSV (image, depth) pairs with optional ``camera.json`` intrinsics
    (benchmark.py:352-407). Depths are 16-bit mm PNGs → metres."""

    def __init__(self, csv_file: str, transform=None, is_test: bool = True):
        with open(csv_file, newline="") as f:
            # pandas skips blank lines
            self.rows = [row for row in csv.reader(f) if row]
        self.transform = transform
        self.is_test = is_test
        self.root_dir = os.path.dirname(csv_file)
        try:
            with open(os.path.join(self.root_dir, "camera.json")) as f:
                params = json.load(f)
            self.camera_matrix = np.array([
                [params["fx"], 0.0, params["cx"]],
                [0.0, params["fy"], params["cy"]],
                [0.0, 0.0, 0.0],
            ])
            self.camera_intrinsics = params
        except FileNotFoundError:
            warnings.warn(f"Could not find 'camera.json' in {self.root_dir}")
            self.camera_matrix = np.eye(3, dtype=float)
            self.camera_intrinsics = {k: float("nan") for k in
                                      ("width", "height", "fx", "fy", "cx", "cy")}

    def _resolve(self, name: str) -> str:
        return name if os.path.isabs(name) else os.path.join(self.root_dir, name)

    def __getitem__(self, idx):
        from PIL import Image

        image_path, depth_path = self.rows[idx][:2]
        image = np.asarray(Image.open(self._resolve(image_path)).convert("RGB"))
        depth = np.asarray(Image.open(self._resolve(depth_path)))
        sample = {"image": image, "depth": depth}
        if self.transform:
            sample = self.transform(sample)
        image = np.asarray(sample["image"], np.float32) / 255.0
        depth = np.asarray(sample["depth"], np.float32)
        depth = depth / 1000.0 if self.is_test else depth / 255.0 * 10.0
        return {"image": image, "depth": depth[..., None] if depth.ndim == 2 else depth}

    def __len__(self):
        return len(self.rows)

    @property
    def image_paths(self):
        return [self._resolve(p) for p in sorted(r[0] for r in self.rows)]

    @property
    def depth_paths(self):
        return [self._resolve(p) for p in sorted(r[1] for r in self.rows)]


class ImageFolderDataset:
    """Flat sorted folder; ``.raw`` float32 files supported
    (benchmark.py:410-437)."""

    def __init__(self, base_dir: str, transform=None):
        assert os.path.isdir(base_dir), f"Could not find the folder: {base_dir}"
        self.base_dir = base_dir
        self.transform = transform
        filenames = sorted(os.listdir(base_dir))
        assert filenames, f"No files found in the folder: {base_dir}"
        self.image_paths = [os.path.join(base_dir, f) for f in filenames]

    def __getitem__(self, idx):
        path = self.image_paths[idx]
        if str(path).endswith(".raw"):
            image = image_io.load_raw_float32_image(str(path))
        else:
            from PIL import Image

            image = np.asarray(Image.open(path))
        if self.transform:
            image = self.transform(image)
        return image

    def __len__(self):
        return len(self.image_paths)


class NestedImageFolderDataset:
    """One subdirectory per sample, images inside (benchmark.py:440-487)."""

    def __init__(self, base_dir: str, transform=None,
                 allowed_extensions=(".png", ".jpeg", ".jpg")):
        assert os.path.isdir(base_dir), f"Could not find the folder: {base_dir}"
        self.base_dir = base_dir
        self.transform = transform
        self.image_paths = []
        for sub_dir in sorted(os.listdir(base_dir)):
            path = os.path.join(base_dir, sub_dir)
            if not os.path.isdir(path):
                continue
            for item in sorted(os.listdir(path)):
                item_path = Path(os.path.join(path, item))
                if item_path.is_file() and item_path.suffix in allowed_extensions:
                    self.image_paths.append(item_path)
        assert self.image_paths, f"Found no images in the folder: {base_dir}"

    def __getitem__(self, idx):
        path = self.image_paths[idx]
        if path.suffix == ".raw":
            image = image_io.load_raw_float32_image(str(path))
        else:
            from PIL import Image

            image = np.asarray(Image.open(path))
        if self.transform:
            image = self.transform(image)
        return image

    def __len__(self):
        return len(self.image_paths)


def nyu_eval_sample(ensure_multiple_of: int = 1):
    """The benchmark's NYU transform: ratio crop 0.95 → MiDaS resize to
    320×240 upper-bound INTER_CUBIC (benchmark.py:682-700)."""
    import cv2

    crop = RatioCenterCrop([0.95, 0.95])
    resize = MidasResize(320, 240, resize_target=True, keep_aspect_ratio=True,
                         ensure_multiple_of=ensure_multiple_of,
                         resize_method="upper_bound",
                         image_interpolation_method=cv2.INTER_CUBIC)

    def transform(sample):
        return resize(crop(sample))

    return transform
