"""Side-by-side RGB|depth video, the counterpart of ReSIDE/depth_video.py and
of ``efficientdepthestimation_tpu/apps/depth_video.py``.

Per frame: Scale(640×480) → CenterCrop(608×456) → normalize, then a
second division by 255 (the reference divides after ToTensor too; kept for
parity, depth_video.py:100) → model → align-corners upsample to 1920×1440
→ inverse-depth colouring 255/(1+d) → 180-pixel letterbox crop → hstack
with the LANCZOS-resized colour frame → video at 24 fps (depth_video.py:71-
124): MJPEG-in-AVI through the native writer where it is built, as the JAX
package writes it, else cv2 DIVX. On the CUDA card unless ``--device cpu``:

    python -m efficientdepthestimation_tpu_torch.apps.depth_video \\
        -i frames/ -m checkpoints/ENB0-HU.pth -o videos/
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
    make_infer_fn,
    resolve_device,
)
from efficientdepthestimation_tpu_torch.data.transforms import (
    center_crop,
    normalize_imagenet,
)
from efficientdepthestimation_tpu_torch.ops.resize import pil_resize
from efficientdepthestimation_tpu_torch.utils.async_writer import (
    AsyncVideoWriter,
)

__all__ = ["WIDTH", "HEIGHT", "BORDER", "CROP_HW", "preprocess",
           "depth_frames", "compose_frame", "main"]

WIDTH, HEIGHT = 1920, 1440  # the depth and colour halves of a frame
BORDER = 180  # rows cropped at the top and the bottom
CROP_HW = (int(480 * 0.95), int(640 * 0.95))


def preprocess(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (N, H, W, 3) frames → the model's f32 input (N, 456, 608, 3),
    on the frames' device: PIL bilinear Scale to 640×480 with uint8
    rounding, the centre crop, normalize, and the reference's second /255."""
    x = pil_resize(frames_u8.float(), (480, 640), "bilinear", True)
    x = center_crop(x, *CROP_HW)
    return (normalize_imagenet(x / 255.0) / 255.0).contiguous()


def depth_frames(infer, frames_u8: torch.Tensor) -> torch.Tensor:
    """f32 (N, HEIGHT, WIDTH) depth of uint8 frames: ``preprocess`` on the
    frames' device, then ``infer`` (``make_infer_fn(...,
    upsample_to=(HEIGHT, WIDTH))``), on its device."""
    return infer(preprocess(frames_u8))[..., 0]


def compose_frame(raw, depth: np.ndarray) -> np.ndarray:
    """One BGR video frame (HEIGHT − 2·BORDER, 2·WIDTH, 3) of a PIL RGB
    frame and its (HEIGHT, WIDTH) depth on the host: the LANCZOS colour
    resize and crop by PIL, and 255/(1 + d) cast to uint8 by numpy, as the
    JAX package does, beside it."""
    import cv2
    from PIL import Image

    color = raw.resize((WIDTH, HEIGHT), Image.LANCZOS)
    color = color.crop((0, BORDER, WIDTH, HEIGHT - BORDER))
    color = cv2.cvtColor(np.asarray(color), cv2.COLOR_RGB2BGR)
    d = (255.0 / (1.0 + depth)).astype(np.uint8)
    d = np.stack(3 * [d], axis=-1)[BORDER:HEIGHT - BORDER]
    return np.hstack((color, d))


def main(args: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description="RGB|depth side-by-side video")
    parser.add_argument("-i", "--image-path", required=True, type=str,
                        help="Directory of video frames.")
    parser.add_argument("-m", "--model-path", required=True, type=str)
    parser.add_argument("-o", "--output-path", default=".", type=str)
    parser.add_argument("--fps", default=24.0, type=float)
    parser.add_argument("--batch-size", default=8, type=int)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the kernels' plain versions)")
    args = parser.parse_args(args)
    device = resolve_device(args.device)

    from PIL import Image

    model = load_any_checkpoint(args.model_path, device=device)
    infer = make_infer_fn(model, upsample_to=(HEIGHT, WIDTH), device=device)

    checkpoint_name = os.path.splitext(os.path.basename(args.model_path))[0]
    os.makedirs(args.output_path, exist_ok=True)
    out_path = os.path.join(args.output_path, f"{checkpoint_name}.mp4")
    video = AsyncVideoWriter(out_path, (2 * WIDTH, HEIGHT - 2 * BORDER),
                             fps=args.fps, fourcc="DIVX")
    print(out_path)

    files = sorted(os.listdir(args.image_path))
    for start in range(0, len(files), args.batch_size):
        raws = []
        for name in files[start:start + args.batch_size]:
            with Image.open(os.path.join(args.image_path, name)) as img:
                raws.append(img.convert("RGB").copy())
        frames = torch.from_numpy(np.stack([np.asarray(r) for r in raws]))
        depth = depth_frames(infer, frames.to(device)).cpu().numpy()
        for k, raw in enumerate(raws):
            print(f"Frame {start + k + 1:03d}")
            video.submit(compose_frame(raw, depth[k]))
    video.cleanup()
    return out_path


if __name__ == "__main__":
    main()
