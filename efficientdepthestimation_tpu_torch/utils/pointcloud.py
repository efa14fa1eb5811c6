"""Point-cloud geometry: depth unprojection on the device, PLY I/O and a
point splatter on the host.

Counterpart of ``efficientdepthestimation_tpu/utils/pointcloud.py``, the
replacement of the Open3D calls in ReSIDE/point_clouds.py and pcd2image.py:
``unproject_depth`` is the pinhole back-projection of
``PointCloud.create_from_rgbd_image`` in torch, on the depth's device; the
PLY codec (binary and ascii) and ``render_point_cloud``, a z-buffered
orthographic splat for the collage tool, are the JAX package's numpy code,
copied, so that files and ties come out the same.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "NYU_V2_INTRINSICS_HALF",
    "unproject_depth",
    "write_ply",
    "read_ply",
    "render_point_cloud",
]

# NYU-v2 Kinect intrinsics halved for 320×240 (point_clouds.py:105-108)
NYU_V2_INTRINSICS_HALF = dict(
    width=640 // 2, height=480 // 2,
    fx=5.2921508098293293e02 / 2, fy=5.2921508098293293e02 / 2,
    cx=3.2894272028759258e02 / 2, cy=2.6748068171871557e02 / 2,
)


def unproject_depth(depth: torch.Tensor, colors: torch.Tensor | None = None,
                    *, fx, fy, cx, cy, mirror_z: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Depth map (H, W) [+ colors (H, W, 3) in 0..1] → (N, 3) f32 points
    and (N, 3) colors, on the depth's device.

    Pinhole back-projection in f32: X=(u−cx)·z/fx, Y=(v−cy)·z/fy, Z=z;
    rows are flipped first (Open3D images are y-up via ``flip_vertical`` in
    the reference, point_clouds.py:116-119, which every caller sets);
    ``mirror_z`` negates Z; zero-depth pixels are dropped.
    """
    h, w = depth.shape
    depth = depth.flip(0)
    if colors is not None:
        colors = colors.flip(0)
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    z = depth.float()
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    if mirror_z:
        z = -z
    points = torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], -1)
    valid = points[:, 2].abs() > 0
    rgb = None if colors is None else colors.reshape(-1, 3)[valid]
    return points[valid], rgb


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None,
              binary: bool = True) -> None:
    """Write an Open3D-compatible PLY (float32 xyz + uchar rgb)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    fmt = "binary_little_endian" if binary else "ascii"
    header = [
        "ply", f"format {fmt} 1.0", f"element vertex {n}",
        "property float x", "property float y", "property float z",
    ]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            if has_color:
                rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
                rec["xyz"] = points
                rec["rgb"] = colors
                f.write(rec.tobytes())
            else:
                f.write(points.tobytes())
        else:
            for i in range(n):
                row = " ".join(f"{v:g}" for v in points[i])
                if has_color:
                    row += " " + " ".join(str(int(c)) for c in colors[i])
                f.write((row + "\n").encode())


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    with open(path, "rb") as f:
        line = f.readline().strip()
        assert line == b"ply", f"not a PLY file: {path}"
        fmt = None
        n = 0
        props: list[tuple[str, str]] = []
        while True:
            line = f.readline().strip().decode()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element" and parts[1] == "vertex":
                n = int(parts[2])
            elif parts[0] == "property" and props is not None:
                props.append((parts[1], parts[2]))
        type_map = {"float": np.float32, "float32": np.float32,
                    "double": np.float64, "uchar": np.uint8, "uint8": np.uint8}
        if fmt == "ascii":
            data = np.loadtxt([f.readline() for _ in range(n)])
            data = np.atleast_2d(data)
            points = data[:, :3].astype(np.float32)
            colors = data[:, 3:6].astype(np.uint8) if data.shape[1] >= 6 else None
            return points, colors
        dtype = np.dtype([(name, type_map[t]) for t, name in props])
        rec = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype)
        points = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1).astype(np.float32)
        colors = None
        if "red" in rec.dtype.names:
            colors = np.stack([rec["red"], rec["green"], rec["blue"]], axis=-1)
        return points, colors


def render_point_cloud(points: np.ndarray, colors: np.ndarray | None,
                       size: tuple[int, int] = (256, 256),
                       rotation: np.ndarray | None = None,
                       zoom: float = 1.0,
                       background: float = 1.0) -> np.ndarray:
    """Z-buffered orthographic point splat (the pcd2image substitute).

    Centres the cloud, applies ``rotation`` (3×3), scales to fit, and splats
    nearest-point-wins into an (H, W, 3) float image.
    """
    h, w = size
    points = np.asarray(points, np.float32)
    if len(points) == 0:
        return np.full((h, w, 3), background, np.float32)
    if colors is None:
        colors = np.ones((len(points), 3), np.float32) * 0.5
    elif colors.dtype == np.uint8:
        colors = colors.astype(np.float32) / 255.0

    pts = points - points.mean(axis=0)
    if rotation is not None:
        pts = pts @ rotation.T
    scale = 0.5 * zoom * min(h, w) / max(np.abs(pts[:, :2]).max(), 1e-6)
    xs = (pts[:, 0] * scale + w / 2).astype(np.int32)
    ys = (-pts[:, 1] * scale + h / 2).astype(np.int32)
    zs = pts[:, 2]

    image = np.full((h, w, 3), background, np.float32)
    zbuf = np.full((h, w), np.inf, np.float32)
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    order = np.argsort(-zs)  # far→near so near overwrites
    for idx in order[inside[order]]:
        y, x = ys[idx], xs[idx]
        if zs[idx] < zbuf[y, x]:
            zbuf[y, x] = zs[idx]
            image[y, x] = colors[idx]
    return image
