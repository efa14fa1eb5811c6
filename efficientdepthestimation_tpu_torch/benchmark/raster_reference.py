"""Ground-truth triangle rasterizer for the novel-view renderer.

A copy of ``efficientdepthestimation_tpu/benchmark/raster_reference.py``.
The reference renders novel views through OpenGL: a textured
``(2^density+1)²`` grid mesh displaced by the depth map, drawn with a
perspective camera and a hardware z-buffer
(``Benchmark/benchmark.py:865-1037``; the DepthRenderer submodule provides
``Mesh.from_texture(texture, depth, density)`` + ``MeshRenderer``). The
port's renderer (:mod:`benchmark.renderer`) realises the same geometry by
supersampled surface interpolation + z-buffered point splatting, or by
ray marching, in torch on any device.

This module is the independent golden: a slow, obviously-correct,
host-side numpy rasterizer implementing exactly the GL pipeline —
triangulated displaced grid, perspective projection, z-buffered
barycentric coverage, perspective-correct texture interpolation. No torch,
no shared code with the fast path beyond the camera-animation matrices.
``tests/test_torch_renderer.py`` holds the port's engines against it at
the floors of ``tests/test_raster_golden.py``, and ``chip_smoke.py``
phase 12 holds the card's renders against it.

Geometry conventions (shared contract with ``renderer._quad_points``):

- textured quad at ``z = 0`` exactly filling the ``fov_y = 18°`` frustum
  from the resting camera at ``z = -10`` (world units; y up, x right,
  camera looks toward ``+z``);
- vertex ``(i, j)`` of the ``(gh, gw)`` grid sits at texture coordinate
  ``(u, v) = (j/(gw-1), i/(gh-1))`` — row 0 is the TOP of the image —
  and is displaced to ``z = depth01(u, v) · displacement_factor`` where
  ``depth01`` is sampled bilinearly (align-corners);
- each grid cell splits into two triangles along its main diagonal;
- screen: ``u = f·x/d + W/2``, ``v = -f·y/d + H/2`` with
  ``f = (H/2)/tan(fov_y/2)`` and ``d`` the camera-space depth; pixel
  ``(r, c)`` has centre ``(c + 0.5, r + 0.5)``.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["rasterize_views", "displaced_grid_mesh"]


def _sample_bilinear_align_corners(img: np.ndarray, u: np.ndarray,
                                   v: np.ndarray) -> np.ndarray:
    """Sample ``img`` (H, W[, C]) at normalized coords (align-corners)."""
    h, w = img.shape[:2]
    x = np.clip(u, 0.0, 1.0) * (w - 1)
    y = np.clip(v, 0.0, 1.0) * (h - 1)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 2) if w > 1 else np.zeros_like(x, np.int64)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 2) if h > 1 else np.zeros_like(y, np.int64)
    fx = (x - x0) if w > 1 else np.zeros_like(x)
    fy = (y - y0) if h > 1 else np.zeros_like(y)
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    a = img[y0, x0]
    b = img[y0, x1]
    c = img[y1, x0]
    d = img[y1, x1]
    return ((1 - fy) * ((1 - fx) * a + fx * b)
            + fy * ((1 - fx) * c + fx * d)).astype(np.float32)


def displaced_grid_mesh(depth01: np.ndarray, frame_hw: tuple[int, int],
                        fov_y_deg: float, displacement_factor: float,
                        mesh_density: int):
    """Build the displaced grid mesh → (vertices (N,3), uvs (N,2), tris (M,3)).

    Vertex grid is ``(2^density + 1)`` per side, capped at the image
    resolution (matching ``renderer.render_novel_views_mesh``).
    """
    h, w = frame_hw
    gh = min((1 << mesh_density) + 1, h)
    gw = min((1 << mesh_density) + 1, w)
    half_h = 10.0 * math.tan(math.radians(fov_y_deg) / 2.0)
    half_w = half_h * (w / h)

    us = np.linspace(0.0, 1.0, gw, dtype=np.float64)
    vs = np.linspace(0.0, 1.0, gh, dtype=np.float64)
    uu, vv = np.meshgrid(us, vs)  # (gh, gw)
    x = half_w * (2.0 * uu - 1.0)
    y = half_h * (1.0 - 2.0 * vv)  # row 0 (v=0) is the top → +y
    z = _sample_bilinear_align_corners(
        depth01.astype(np.float64), uu, vv) * displacement_factor
    vertices = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    uvs = np.stack([uu.ravel(), vv.ravel()], axis=1)

    # two triangles per cell, split along the main (TL-BR) diagonal
    idx = np.arange(gh * gw).reshape(gh, gw)
    tl = idx[:-1, :-1].ravel()
    tr = idx[:-1, 1:].ravel()
    bl = idx[1:, :-1].ravel()
    br = idx[1:, 1:].ravel()
    tris = np.concatenate([
        np.stack([tl, bl, br], axis=1),
        np.stack([tl, br, tr], axis=1),
    ], axis=0)
    return vertices, uvs, tris


def rasterize_views(image: np.ndarray, depth01: np.ndarray,
                    views: np.ndarray, fov_y_deg: float = 18.0,
                    displacement_factor: float = 4.0, mesh_density: int = 8,
                    out_hw: tuple[int, int] | None = None,
                    background: float = 0.0) -> np.ndarray:
    """Rasterize T novel views of the displaced textured mesh.

    image: (H, W, 3) float [0,1]; depth01: (H, W) float [0,1];
    views: (T, 4, 4) world→camera animation matrices (the fixed -10 z
    camera offset is applied internally, as in the fast path).
    Returns (T, H', W', 3) float32 in [0, 1].
    """
    h, w = image.shape[:2]
    out_h, out_w = out_hw or (h, w)
    image = image[..., :3].astype(np.float32)
    vertices, uvs, tris = displaced_grid_mesh(
        depth01, (h, w), fov_y_deg, displacement_factor, mesh_density)
    n_vert = len(vertices)
    verts_h = np.concatenate([vertices, np.ones((n_vert, 1))], axis=1)  # (N,4)

    cam_offset = np.eye(4)
    cam_offset[2, 3] = -10.0
    focal = (out_h / 2.0) / math.tan(math.radians(fov_y_deg) / 2.0)

    frames = np.zeros((len(views), out_h, out_w, 3), np.float32)
    frames += background
    for t, view in enumerate(views):
        cam = verts_h @ (cam_offset @ view).T  # (N, 4)
        depth_cam = -cam[:, 2]
        # screen-space vertex positions (pixel units)
        su = focal * cam[:, 0] / depth_cam + out_w / 2.0
        sv = -focal * cam[:, 1] / depth_cam + out_h / 2.0
        inv_d = 1.0 / depth_cam

        zbuf = np.full((out_h, out_w), np.inf, np.float64)
        frame = np.full((out_h, out_w, 3), background, np.float32)

        for i0, i1, i2 in tris:
            if depth_cam[i0] <= 0 or depth_cam[i1] <= 0 or depth_cam[i2] <= 0:
                continue  # behind the camera (never happens in the sweep)
            xs = np.array([su[i0], su[i1], su[i2]])
            ys = np.array([sv[i0], sv[i1], sv[i2]])
            # bounding box clipped to the viewport, over pixel centres
            min_x = max(int(math.floor(xs.min() - 0.5)), 0)
            max_x = min(int(math.ceil(xs.max() - 0.5)), out_w - 1)
            min_y = max(int(math.floor(ys.min() - 0.5)), 0)
            max_y = min(int(math.ceil(ys.max() - 0.5)), out_h - 1)
            if min_x > max_x or min_y > max_y:
                continue
            px, py = np.meshgrid(
                np.arange(min_x, max_x + 1, dtype=np.float64) + 0.5,
                np.arange(min_y, max_y + 1, dtype=np.float64) + 0.5)
            # barycentric coordinates (signed areas)
            x0, y0 = xs[0], ys[0]
            x1, y1 = xs[1], ys[1]
            x2, y2 = xs[2], ys[2]
            area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
            if area == 0.0:
                continue
            w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) / area
            w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) / area
            w2 = 1.0 - w0 - w1
            eps = -1e-9
            inside = (w0 >= eps) & (w1 >= eps) & (w2 >= eps)
            if not inside.any():
                continue
            # perspective-correct interpolation via 1/depth
            iz = w0 * inv_d[i0] + w1 * inv_d[i1] + w2 * inv_d[i2]
            z = 1.0 / iz
            yy, xx = np.nonzero(inside)
            ry = yy + min_y
            rx = xx + min_x
            zi = z[yy, xx]
            closer = zi < zbuf[ry, rx]
            if not closer.any():
                continue
            ry, rx = ry[closer], rx[closer]
            yy, xx = yy[closer], xx[closer]
            zbuf[ry, rx] = zi[closer]
            # perspective-correct uv
            uo = (w0 * uvs[i0, 0] * inv_d[i0] + w1 * uvs[i1, 0] * inv_d[i1]
                  + w2 * uvs[i2, 0] * inv_d[i2])
            vo = (w0 * uvs[i0, 1] * inv_d[i0] + w1 * uvs[i1, 1] * inv_d[i1]
                  + w2 * uvs[i2, 1] * inv_d[i2])
            u_tex = uo[yy, xx] * zi[closer]
            v_tex = vo[yy, xx] * zi[closer]
            frame[ry, rx] = _sample_bilinear_align_corners(image, u_tex, v_tex)
        frames[t] = frame
    return frames
