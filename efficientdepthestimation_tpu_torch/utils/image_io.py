"""Host image I/O: EXIF-aware loading and the OpenCV ``freadimg``-compatible
``.raw`` float32 format.

A copy of ``efficientdepthestimation_tpu/utils/image_io.py`` (Benchmark/
image_io.py:55-180): the ``.raw`` layout is ``int32 h, int32 w, int32
cv_type, uint64 pixel_size`` followed by the pixel payload in column-major
(Fortran) order, cv_type = CV_32F + (channels-1 << 3). PIL and cv2 are
imported where an image is read or written.
"""

from __future__ import annotations

import os
import struct

import numpy as np

__all__ = [
    "load_image",
    "load_image_angle",
    "load_raw_float32_image",
    "save_raw_float32_image",
    "save_image",
]

_CV_32F = 5
_CV_CN_SHIFT = 3
_CV_CN_MAX = 512


def load_image_angle(file_name: str, max_size: int | None = None,
                     min_size: int | None = None, angle: float = 0,
                     align: int = 1):
    """Load an RGB image in [0,1] f32, correcting EXIF orientation (tag 274)."""
    from PIL import Image

    with Image.open(file_name) as img:
        exif = img.getexif() if hasattr(img, "getexif") else None
        orientation = exif.get(274) if exif else None
        if orientation == 8:
            angle = 90
        elif orientation == 6:
            angle = 270
        elif orientation == 3:
            angle = 180
        if angle != 0:
            img = img.rotate(angle, expand=True)
        arr = np.float32(img) / 255.0

    if max_size is not None:
        import cv2

        if min_size is not None:
            arr = cv2.resize(arr, (max_size, min_size), interpolation=cv2.INTER_AREA)
        else:
            h, w = arr.shape[:2]
            scale = max_size / max(h, w)
            if scale < 1:
                new_w = align * (int(w * scale) // align)
                new_h = align * (int(h * scale) // align)
                arr = cv2.resize(arr, (new_w, new_h), interpolation=cv2.INTER_AREA)
    return arr, angle


def load_image(file_name: str, max_size: int | None = None, align: int = 1):
    arr, _ = load_image_angle(file_name, max_size, align=align)
    return arr


def load_raw_float32_image(file_name: str) -> np.ndarray:
    with open(file_name, "rb") as f:
        h = struct.unpack("i", f.read(4))[0]
        w = struct.unpack("i", f.read(4))[0]
        cv_type = struct.unpack("i", f.read(4))[0]
        pixel_size = struct.unpack("Q", f.read(8))[0]
        d = ((cv_type - _CV_32F) >> _CV_CN_SHIFT) + 1
        if d < 1 or d != pixel_size // 4:
            raise ValueError(
                f"Incompatible pixel_size({pixel_size}) and cv_type({cv_type})"
            )
        if d > _CV_CN_MAX:
            raise ValueError("Cannot load image with more than 512 channels")
        data = np.frombuffer(f.read(), dtype=np.float32)
    # payload was written channel-major/column-major; invert the transpose
    if d == 1:
        return data.reshape(h, w)
    return data.reshape(h, w, d)


def save_raw_float32_image(file_name: str, image: np.ndarray) -> None:
    image = np.asarray(image)
    if image.ndim == 2:
        h, w = image.shape
        d = 1
        payload = np.transpose(image).astype(np.float32)
    else:
        h, w, d = image.shape
        payload = np.transpose(image, (2, 1, 0)).astype(np.float32)
    if d > _CV_CN_MAX:
        raise ValueError("Cannot save image with more than 512 channels")
    cv_type = _CV_32F + ((d - 1) << _CV_CN_SHIFT)
    with open(file_name, "wb") as f:
        f.write(struct.pack("i", h))
        f.write(struct.pack("i", w))
        f.write(struct.pack("i", cv_type))
        f.write(struct.pack("Q", d * 4))
        f.write(np.asfortranarray(payload).tobytes(order="F"))


def save_image(file_name: str, image: np.ndarray) -> None:
    """Dispatch on extension: ``.raw`` float32 binary, else 8-bit via PIL."""
    ext = os.path.splitext(file_name)[1].lower()
    if ext == ".raw":
        save_raw_float32_image(file_name, image)
    else:
        from PIL import Image

        arr = (255.0 * np.asarray(image)).astype(np.uint8)
        Image.fromarray(arr).save(file_name)
