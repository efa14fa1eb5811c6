"""Novel-view synthesis from predicted depth, in torch on any device.

Counterpart of ``efficientdepthestimation_tpu/benchmark/renderer.py``, the
replacement for the reference's OpenGL mesh renderer (DepthRenderer, used
via Benchmark/benchmark.py:845-1039). Three engines render a batch of a
sample's camera sweep on the device of the image they are given:

  * ``render_novel_views_mesh`` (default) — the reference's *geometry*: a
    textured grid mesh at ``mesh_density`` displaced by the normalized depth
    × ``displacement_factor``, its triangles interpolated onto a grid
    ``supersample``× denser than the output, then forward-splatted with a
    z-buffer;
  * ``render_novel_views_raymarch`` — the same mesh, exactly, by marching
    each output pixel's ray to the heightfield;
  * ``render_novel_views`` — per-pixel DIBR point splat.

The JAX package renders a sweep in one vmapped, jitted call of XLA
scatters, gathers and ``lax`` loops; none of it is a Pallas kernel. Here
they are torch's own operators: the z-buffer is two ``scatter_reduce_``
``amin`` passes (an f32 depth, then an int32 packed key), the loops are
Python loops over a chunk of views. A chunk holds ``CHUNK_ELEMENTS`` //
(points or rays a view) views, so an array over the chunk is at most 64 MiB
of f32 whatever the resolution, and the peak stays about 1 GiB at the
benchmark's 691,200 splat points a view; each view's result is independent
of the chunk it is in.

Arithmetic follows the JAX package's f32 operations as XLA compiles them
for the CPU, where the tests compare the two: a quotient by a constant is a
product with its f32 reciprocal, and a product that feeds a sum is fused
into it (an FMA: the bilinear and triangle interpolations, the squared
distance to a pixel centre, the ray steps), which ``_fma`` rounds once as
well. The 4×4 camera products and their inverses are computed on the host
in f32, and the constant sample grids in numpy f32, so the card and the CPU
start from the same numbers. The hole fill's 3×3 box sums are shifted adds,
not a convolution, so no TF32 path can touch them.

The camera sweep reproduces the reference's animation schedule
(benchmark.py:875-887): rotate-bounce ±2.5° (Y) and ±0.5° (X) with phase
offset 0.5, translate-bounce 0.30 (X) and 0.15 (Y, offset 0.25), camera 10
units back with fov_y 18°, ``animation_length = fps / (0.5 / 2.5°)`` frames,
a 3-frame initial delay, one still PNG per second of animation plus a video
per sample.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from efficientdepthestimation_tpu_torch.ops.resize import device_constant
from efficientdepthestimation_tpu_torch.utils.timer import Timer

__all__ = [
    "RotateAxisBounce", "Translate", "Compose", "Axis",
    "reference_camera_animation", "sweep_views",
    "render_novel_views", "render_novel_views_mesh",
    "render_novel_views_raymarch", "create_rendered_images",
]

# Elements of one (views, points) array of a chunk: 2^24 f32 is 64 MiB.
CHUNK_ELEMENTS = 1 << 24
INITIAL_DELAY = 3  # frames before the first still (benchmark.py:535-542)
_INT32_MAX = torch.iinfo(torch.int32).max


class Axis:
    X, Y, Z = 0, 1, 2


# ---------------------------------------------------------------------------
# camera animation (time-parameterized, mirrors DepthRenderer.animation)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RotateAxisBounce:
    """Sinusoidal rotation bounce: angle(t) = A·sin(2π(speed·t + offset))."""

    angle: float  # radians amplitude
    axis: int = Axis.Y
    offset: float = 0.0
    speed: float = 1.0

    def transform_at(self, t: float) -> np.ndarray:
        theta = self.angle * math.sin(2.0 * math.pi * (self.speed * t + self.offset))
        c, s = math.cos(theta), math.sin(theta)
        m = np.eye(4)
        if self.axis == Axis.X:
            m[1:3, 1:3] = [[c, -s], [s, c]]
        elif self.axis == Axis.Y:
            m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
        else:
            m[0:2, 0:2] = [[c, -s], [s, c]]
        return m


@dataclasses.dataclass
class Translate:
    """Sinusoidal translation bounce along an axis."""

    distance: float
    axis: int = Axis.X
    offset: float = 0.0
    speed: float = 1.0

    def transform_at(self, t: float) -> np.ndarray:
        m = np.eye(4)
        m[self.axis, 3] = self.distance * math.sin(
            2.0 * math.pi * (self.speed * t + self.offset))
        return m


@dataclasses.dataclass
class Compose:
    animations: list

    def transform_at(self, t: float) -> np.ndarray:
        m = np.eye(4)
        for anim in self.animations:
            m = m @ anim.transform_at(t)
        return m


def reference_camera_animation(rotation_angle_deg: float = 2.5) -> Compose:
    """The exact schedule of benchmark.py:875-887."""
    loops_per_second = 0.5 / rotation_angle_deg
    return Compose([
        RotateAxisBounce(np.deg2rad(rotation_angle_deg), axis=Axis.Y,
                         offset=0.5, speed=-loops_per_second),
        RotateAxisBounce(np.deg2rad(rotation_angle_deg / 5.0), axis=Axis.X,
                         offset=0.5, speed=-loops_per_second),
        Translate(distance=0.30, speed=loops_per_second),
        Translate(distance=0.15, axis=Axis.Y, offset=0.25,
                  speed=loops_per_second),
    ])


def sweep_views(fps: int, rotation_angle: float = 2.5) -> np.ndarray:
    """The (T, 4, 4) f32 views of one sample's sweep: ``fps / (0.5 /
    rotation_angle)`` animation frames after ``INITIAL_DELAY`` (303 at 60
    fps), as ``create_rendered_images`` renders them."""
    n_anim = int(fps / (0.5 / rotation_angle))
    animation = reference_camera_animation(rotation_angle)
    times = np.arange(n_anim + INITIAL_DELAY) / fps
    return np.stack([animation.transform_at(t) for t in times]).astype(
        np.float32)


def _camera_matrices(views) -> torch.Tensor:
    """(T, 4, 4) f32 ``cam_offset @ view`` on the host, the fixed camera 10
    units back applied to each view."""
    views = torch.as_tensor(views).detach().to("cpu", torch.float32)
    cam_offset = torch.eye(4)
    cam_offset[2, 3] = -10.0
    return cam_offset @ views


def _to_device(array, device: torch.device) -> torch.Tensor:
    """A host array on ``device``, through pinned memory on a card, so the
    copy does not wait for the work already queued there."""
    t = torch.as_tensor(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


# ---------------------------------------------------------------------------
# constant sample grids, built in numpy f32 as the JAX package's XLA
# computes them, then kept on the device
# ---------------------------------------------------------------------------


def _arange(n: int) -> np.ndarray:
    return np.arange(n, dtype=np.float32)


def _inv(x: float) -> np.float32:
    """The f32 reciprocal XLA multiplies by in place of dividing by ``x``."""
    return np.float32(1.0) / np.float32(x)


def _linspace01(n: int) -> np.ndarray:
    """``jnp.linspace(0, 1, n)``: i · (1 / (n - 1)), the last exactly 1."""
    out = _arange(n) * _inv(max(n - 1, 1))
    out[-1] = 1.0
    return out


def _sample_centres(n: int) -> np.ndarray:
    """(i + 0.5) / n."""
    return (_arange(n) + np.float32(0.5)) * _inv(n)


def _quad_axis(n: int, half: float, flip: bool) -> np.ndarray:
    """Sample centres across the quad: ``half * (2 (i + 0.5) / n - 1)``, or
    ``half * (1 - 2 (i + 0.5) / n)`` for rows (y up, row 0 top)."""
    t = (np.float32(2.0) * (_arange(n) + np.float32(0.5))) * _inv(n)
    t = (np.float32(1.0) - t) if flip else (t - np.float32(1.0))
    return np.float32(half) * t


def _ray_axis(n: int, focal: float, flip: bool) -> np.ndarray:
    """Pixel-centre camera-space ray slopes, ``(i + 0.5 - n / 2) / focal``
    (negated for rows)."""
    t = _arange(n) + np.float32(0.5) - np.float32(n / 2.0)
    t = -t if flip else t
    return t * _inv(focal)


def _const(make, *args, device) -> torch.Tensor:
    return device_constant(make, *args, dtype=torch.float32, device=device)


def _half_extent(fov_y_deg: float, frame_hw) -> tuple[float, float]:
    h, w = frame_hw
    half_h = 10.0 * math.tan(math.radians(fov_y_deg) / 2.0)
    return half_h, half_h * (w / h)


# ---------------------------------------------------------------------------
# DIBR core
# ---------------------------------------------------------------------------


def _fma(a, b, c) -> torch.Tensor:
    """``a·b + c`` of f32 operands rounded once to f32, as a fused
    multiply-add computes it: the product of two f32 numbers is exact in
    f64, so the f64 sum rounded to f32 is the FMA's result (short of a
    double rounding, which needs the sum within 2^-29 of a halfway point)
    on any device."""
    def f64(x):
        return x.double() if torch.is_tensor(x) else float(x)

    return (f64(a) * f64(b) + f64(c)).float()


def _grid_sample_ac(img: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Align-corners bilinear sample of ``img`` (H, W[, C]) at normalized
    coords ``u`` (columns) / ``v`` (rows) of any one shape — texel (0,0) is
    u=v=0, texel (W-1, H-1) is u=v=1 (the GL texture convention the golden
    rasterizer uses)."""
    h, w = img.shape[:2]
    flat = img.reshape(h * w, *img.shape[2:])
    x = torch.clamp(u, 0.0, 1.0) * (w - 1)
    y = torch.clamp(v, 0.0, 1.0) * (h - 1)
    x0 = torch.clamp(torch.floor(x).long(), 0, max(w - 2, 0))
    y0 = torch.clamp(torch.floor(y).long(), 0, max(h - 2, 0))
    fx = x - x0
    fy = y - y0
    if img.dim() == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    a = flat[y0 * w + x0]
    b = flat[y0 * w + x1]
    c = flat[y1 * w + x0]
    d = flat[y1 * w + x1]
    # (1 - fy) * ((1 - fx) * a + fx * b) + fy * ((1 - fx) * c + fx * d)
    top = _fma(1 - fx, a, fx * b)
    bottom = _fma(1 - fx, c, fx * d)
    return _fma(1 - fy, top, fy * bottom)


def _triangulated_surface(vertex_z: torch.Tensor, u: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Sample the TRIANGULATED vertex grid at normalized coords ``u``, ``v``.

    Each grid cell is split along its TL→BR diagonal into two planar
    triangles (the triangulation a GL grid mesh renders); interpolation is
    linear within each triangle — not the bilinear patch, which differs in
    saddle cells.
    """
    gh, gw = vertex_z.shape
    flat = vertex_z.reshape(-1)
    gx = torch.clamp(u, 0.0, 1.0) * (gw - 1)
    gy = torch.clamp(v, 0.0, 1.0) * (gh - 1)
    ix = torch.clamp(torch.floor(gx).long(), 0, max(gw - 2, 0))
    iy = torch.clamp(torch.floor(gy).long(), 0, max(gh - 2, 0))
    fx = gx - ix
    fy = gy - iy
    ix1 = torch.clamp(ix + 1, max=gw - 1)
    iy1 = torch.clamp(iy + 1, max=gh - 1)
    tl = flat[iy * gw + ix]
    tr = flat[iy * gw + ix1]
    bl = flat[iy1 * gw + ix]
    br = flat[iy1 * gw + ix1]
    # tl + fy * (bl - tl) + fx * (br - bl): triangle (tl, bl, br)
    lower = _fma(fx, br - bl, _fma(fy, bl - tl, tl))
    # tl + fx * (tr - tl) + fy * (br - tr): triangle (tl, br, tr)
    upper = _fma(fy, br - tr, _fma(fx, tr - tl, tl))
    return torch.where(fx > fy, upper, lower)


def _vertex_grid(depth01: torch.Tensor, displacement_factor: float,
                 mesh_density: int) -> torch.Tensor:
    """The displaced mesh's vertex heights: 2^density cells a side, capped
    at the image resolution, sampled align-corners from the depth."""
    h, w = depth01.shape
    gh = min((1 << mesh_density) + 1, h)
    gw = min((1 << mesh_density) + 1, w)
    gu = _const(_linspace01, gw, device=depth01.device)[None, :].expand(gh, gw)
    gv = _const(_linspace01, gh, device=depth01.device)[:, None].expand(gh, gw)
    return _grid_sample_ac(depth01 * displacement_factor, gu, gv)


def render_novel_views(image: torch.Tensor, depth01: torch.Tensor, views,
                       fov_y_deg: float = 18.0,
                       displacement_factor: float = 4.0,
                       out_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """Render T novel views of one RGB(A) image displaced by its depth
    (per-pixel point splat — DIBR), on the image's device.

    image: (H, W, 3|4) float [0,1]; depth01: (H, W) float [0,1];
    views: (T, 4, 4) camera matrices (world→camera, before the fixed -10 z
    offset), on any device. Returns (T, H', W', 3) float images in [0, 1].
    """
    h, w = image.shape[:2]
    out_hw = out_hw or (h, w)
    return _splat_views(image[..., :3].reshape(-1, 3),
                        depth01 * displacement_factor, (h, w), views,
                        fov_y_deg, out_hw)


@torch.inference_mode()
def render_novel_views_mesh(image: torch.Tensor, depth01: torch.Tensor,
                            views, fov_y_deg: float = 18.0,
                            displacement_factor: float = 4.0,
                            mesh_density: int = 8,
                            out_hw: tuple[int, int] | None = None,
                            supersample: int = 3) -> torch.Tensor:
    """Displaced-MESH novel views — the reference's renderer geometry
    (benchmark.py:865-1037: textured grid mesh, density 8, displaced by
    depth).

    The mesh is a (2^density+1)² vertex grid over the textured quad, vertex
    ``(i, j)`` at texture corner ``(j/(gw-1), i/(gh-1))`` with z sampled
    align-corners from the depth map — exactly the geometry of
    :func:`raster_reference.displaced_grid_mesh`. The surface a GL
    rasterizer interpolates across the two triangles of each cell is realised
    by triangle-aware linear interpolation onto a ``supersample``×-denser-
    than-output sample grid (odd supersample ⇒ one sample lands exactly on
    every output pixel centre), then forward-splatted with a z-buffer.
    """
    h, w = image.shape[:2]
    out_h, out_w = out_hw or (h, w)
    device = image.device
    vertex_z = _vertex_grid(depth01, displacement_factor, mesh_density)
    sh, sw = supersample * out_h, supersample * out_w
    su = _const(_sample_centres, sw, device=device)[None, :].expand(sh, sw)
    sv = _const(_sample_centres, sh, device=device)[:, None].expand(sh, sw)
    surf_z = _triangulated_surface(vertex_z, su, sv)
    surf_rgb = _grid_sample_ac(image[..., :3], su, sv)
    return _splat_views(surf_rgb.reshape(-1, 3), surf_z, (h, w), views,
                        fov_y_deg, (out_h, out_w))


@torch.inference_mode()
def _splat_views(colors: torch.Tensor, z: torch.Tensor, frame_hw,
                 views, fov_y_deg: float, out_hw) -> torch.Tensor:
    """Forward-splat the quad's (sh, sw) samples, heights ``z`` and
    ``colors`` (sh·sw, 3), into each view with a z-buffer + hole fill.

    ``frame_hw`` is the *reference* image size that defines the quad extent
    (the quad exactly fills the frustum at z=0 from 10 units away); the
    sample grid may be denser (mesh supersampling)."""
    out_h, out_w = out_hw
    device = z.device
    sh, sw = z.shape
    n_points = sh * sw
    half_h, half_w = _half_extent(fov_y_deg, frame_hw)
    focal = (out_h / 2.0) / math.tan(math.radians(fov_y_deg) / 2.0)
    qx = _const(_quad_axis, sw, half_w, False, device=device)[None, :]
    qy = _const(_quad_axis, sh, half_h, True, device=device)[:, None]
    qx, qy = qx.expand(sh, sw).reshape(-1), qy.expand(sh, sw).reshape(-1)
    z = z.reshape(-1)

    idx_bits = max(1, (n_points - 1).bit_length())
    d2_bits = 30 - idx_bits  # ≥11 at typical splat counts (<=2^19)
    assert d2_bits >= 4, f"too many splat points to pack ({n_points})"
    point_idx = torch.arange(n_points, dtype=torch.int32, device=device)
    slots = out_h * out_w + 1  # one overflow slot a view for invalid points

    cams = _camera_matrices(views)
    chunk = max(1, CHUNK_ELEMENTS // n_points)
    frames = []
    for first in range(0, len(cams), chunk):
        m = _to_device(cams[first:first + chunk], device)
        t = len(m)

        def row(r):  # (t, P): row r of m @ (x, y, z, 1)
            c = [m[:, r, k, None] for k in range(4)]
            return c[0] * qx + c[1] * qy + c[2] * z + c[3]

        x, y, depth_cam = row(0), row(1), -row(2)
        u = focal * x / depth_cam + out_w / 2.0
        v = -focal * y / depth_cam + out_h / 2.0
        ui = torch.floor(u).long()
        vi = torch.floor(v).long()
        valid = ((ui >= 0) & (ui < out_w) & (vi >= 0) & (vi < out_h)
                 & (depth_cam > 0))
        base = torch.arange(t, device=device)[:, None] * slots
        flat = torch.where(valid, vi * out_w + ui, out_h * out_w) + base

        # pass 1: z-buffer via scatter-min
        zbuf = torch.full((t * slots,), math.inf, device=device)
        zbuf.scatter_reduce_(0, flat.reshape(-1), torch.where(
            valid, depth_cam, math.inf).reshape(-1), "amin")
        # pass 2: among front-surface samples (relative z tolerance keeps the
        # whole front triangle in play even when it is steeply sloped), the
        # one closest to the pixel CENTRE, as a GL rasterizer samples: one
        # int32 scatter-min of a packed (d2_bucket << idx_bits | point
        # index) key, ties to the lowest point index, then a colour gather.
        on_front = valid & (depth_cam <= zbuf[flat] * (1.0 + 1e-3))
        du, dv = u - (ui + 0.5), v - (vi + 0.5)
        d2 = _fma(du, du, dv * dv)  # du² + dv²
        # d2 ≤ 0.5 for a sample binned to its own pixel → bucket over [0, 0.5]
        d2_bucket = torch.clamp((d2 * (1 << (d2_bits + 1))).int(),
                                max=(1 << d2_bits) - 1)
        key = torch.where(on_front, (d2_bucket << idx_bits) | point_idx,
                          _INT32_MAX)
        kbuf = torch.full((t * slots,), _INT32_MAX, dtype=torch.int32,
                          device=device)
        kbuf.scatter_reduce_(0, flat.reshape(-1), key.reshape(-1), "amin")
        kbuf = kbuf.reshape(t, slots)[:, :-1]
        filled = kbuf != _INT32_MAX
        winner = torch.where(filled, kbuf & ((1 << idx_bits) - 1), 0)
        frame = torch.where(filled[..., None], colors[winner.long()], 0.0)
        frame = frame.reshape(t, out_h, out_w, 3).permute(0, 3, 1, 2)
        filled = filled.reshape(t, 1, out_h, out_w)

        # hole fill: two sharp 3×3 dilation-average passes for 1–2 px seams,
        # then a push–pull pyramid for the wide gaps stretched triangles
        # leave at strong parallax
        frame, filled = _fill(frame, filled)
        frame, filled = _fill(frame, filled)
        frame = _pyramid_fill(frame, filled)
        frames.append(torch.clamp(frame, 0.0, 1.0).permute(0, 2, 3, 1))
    return torch.cat(frames)


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3×3 box sum of each (H, W) plane, zero padding."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))
    rows = p[..., :, 0:w] + p[..., :, 1:w + 1] + p[..., :, 2:w + 2]
    return rows[..., 0:h, :] + rows[..., 1:h + 1, :] + rows[..., 2:h + 2, :]


def _fill(frame: torch.Tensor, filled: torch.Tensor):
    """One dilation-average pass: an unfilled pixel takes the mean colour
    of its filled 3×3 neighbours. frame (T, 3, H, W), filled (T, 1, H, W)."""
    num = _box3(frame * filled)
    den = _box3(filled.to(frame.dtype))
    fallback = num / torch.clamp(den, min=1.0)
    return torch.where(filled, frame, fallback), filled | (den > 0)


def _pyramid_fill(frame: torch.Tensor, filled: torch.Tensor) -> torch.Tensor:
    """Push–pull fill: unfilled pixels take the nearest-scale average of
    filled content, so arbitrarily wide gaps get plausible (smeared) color
    instead of black. Filled pixels are untouched. frame (T, 3, H, W),
    filled (T, 1, H, W).

    The JAX package's ``jax.image.resize(..., "linear")`` antialiases on
    the way down, as ``F.interpolate(antialias=True)`` does; on the way up
    both are plain bilinear."""
    fw = torch.cat([frame * filled, filled.to(frame.dtype)], 1)
    levels = []
    h, w = fw.shape[-2:]
    while min(h, w) > 2:
        levels.append(fw)
        h, w = (h + 1) // 2, (w + 1) // 2
        fw = F.interpolate(fw, size=(h, w), mode="bilinear",
                           align_corners=False, antialias=True)
    img = fw[:, :3] / torch.clamp(fw[:, 3:], min=1e-8)
    for level in reversed(levels):
        img = F.interpolate(img, size=level.shape[-2:], mode="bilinear",
                            align_corners=False)
        f_l, w_l = level[:, :3], level[:, 3:]
        img = torch.where(w_l > 1e-6, f_l / torch.clamp(w_l, min=1e-8), img)
    return torch.where(filled, frame, img)


@torch.inference_mode()
def render_novel_views_raymarch(image: torch.Tensor, depth01: torch.Tensor,
                                views, fov_y_deg: float = 18.0,
                                displacement_factor: float = 4.0,
                                mesh_density: int = 8,
                                out_hw: tuple[int, int] | None = None,
                                march_steps: int = 64,
                                refine_steps: int = 10) -> torch.Tensor:
    """EXACT novel views of the displaced triangulated grid by per-pixel ray
    marching — the high-fidelity engine behind ``method='mesh'``.

    The displaced mesh is a heightfield z = S(x, y) over the textured quad,
    so every output pixel's ray is intersected with the surface directly:
    ``march_steps`` uniform samples of the camera-depth interval where the
    ray crosses the displacement slab bracket the first ray–surface
    crossing, and ``refine_steps`` bisection iterations converge to float
    precision. Visibility and the interpolated texture across stretched
    occlusion triangles then match the golden triangle rasterizer by
    construction (no splat coverage gaps, no hole filling).
    """
    h, w = image.shape[:2]
    out_h, out_w = out_hw or (h, w)
    device = image.device
    image = image[..., :3]
    vertex_z = _vertex_grid(depth01, displacement_factor, mesh_density)
    zmax = float(displacement_factor)
    half_h, half_w = _half_extent(fov_y_deg, (h, w))
    focal = (out_h / 2.0) / math.tan(math.radians(fov_y_deg) / 2.0)
    inv_half_w, inv_half_h = float(_inv(half_w)), float(_inv(half_h))

    # pixel-centre camera-space ray directions, z = -1 (depth = -z_cam)
    dir_x = _const(_ray_axis, out_w, focal, False, device=device)[None, :]
    dir_y = _const(_ray_axis, out_h, focal, True, device=device)[:, None]

    def surface(x, y):
        """Heights of the mesh under world (x, y); outside the quad far
        below it (a marching ray never hits it)."""
        u = (x * inv_half_w + 1.0) * 0.5
        v = (1.0 - y * inv_half_h) * 0.5
        inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
        z = _triangulated_surface(vertex_z, torch.clamp(u, 0.0, 1.0),
                                  torch.clamp(v, 0.0, 1.0))
        return torch.where(inside, z, -1e9)

    minvs = torch.linalg.inv(_camera_matrices(views))
    chunk = max(1, CHUNK_ELEMENTS // (out_h * out_w))
    frames = []
    for first in range(0, len(minvs), chunk):
        minv = _to_device(minvs[first:first + chunk], device)
        t = len(minv)
        origin = [minv[:, k, 3, None, None] for k in range(3)]
        # d_world = dirs_cam @ minv[:3, :3].T, dirs_cam = (dir_x, dir_y, -1)
        d_world = [_fma(minv[:, k, 2, None, None], -1.0, _fma(
            minv[:, k, 1, None, None], dir_y,
            dir_x * minv[:, k, 0, None, None])) for k in range(3)]
        # camera-depth interval where the ray is inside the displacement
        # slab z_world ∈ [0, zmax] (dz < 0 for every on-screen ray)
        d0 = (zmax - origin[2]) / d_world[2]
        d1 = (0.0 - origin[2]) / d_world[2]

        def g_at(d):
            p = [_fma(d, d_world[k], origin[k]) for k in range(3)]
            return p[2] - surface(p[0], p[1])

        # march: the first sign change of g (the ray passes under the surface)
        found = torch.zeros(d0.shape, dtype=torch.bool, device=device)
        lo, hi, prev_d = d0, d1, d0
        for k in range(march_steps):
            d = _fma(d1 - d0, np.float32(k) * _inv(march_steps - 1), d0)
            hit_now = (g_at(d) <= 0.0) & ~found
            lo = torch.where(hit_now, prev_d, lo)
            hi = torch.where(hit_now, d, hi)
            found = found | hit_now
            prev_d = d

        # bisection refine to the exact crossing
        for _ in range(refine_steps):
            mid = 0.5 * (lo + hi)
            below = g_at(mid) <= 0.0
            lo, hi = torch.where(below, lo, mid), torch.where(below, mid, hi)
        d_hit = 0.5 * (lo + hi)

        px = _fma(d_hit, d_world[0], origin[0])
        py = _fma(d_hit, d_world[1], origin[1])
        u = (px * inv_half_w + 1.0) * 0.5
        v = (1.0 - py * inv_half_h) * 0.5
        rgb = _grid_sample_ac(image, torch.clamp(u, 0.0, 1.0),
                              torch.clamp(v, 0.0, 1.0))
        frames.append(torch.where(found[..., None], rgb, 0.0))
    return torch.cat(frames)


# ---------------------------------------------------------------------------
# harness-facing sweep
# ---------------------------------------------------------------------------

RENDERERS = {"mesh": render_novel_views_mesh,
             "raymarch": render_novel_views_raymarch,
             "splat": render_novel_views}


def create_rendered_images(output_dir: str, image_loader, depth_loader=None,
                           fps: int = 60, mesh_density: int = 8,
                           displacement_factor: float = 4.0,
                           rotation_angle: float = 2.5,
                           method: str = "mesh", device=None):
    """Render the animated sweep for every sample (benchmark.py:845-1039) on
    ``device`` (default: the CUDA card, which must then be present).

    ``image_loader`` iterates dicts {'image': (H,W,3) float [0,1],
    'depth': (H,W[,1])}; ``depth_loader`` (optional) provides replacement
    depth maps (uint8/float arrays). Writes video/{i:06d}.avi plus
    image/{i:06d}/*.png (one still per second of animation, after a 3-frame
    initial delay), and caches by file count.

    ``method``: 'mesh' (default) renders the displaced grid mesh at
    ``mesh_density`` via supersampled triangle interpolation + splatting;
    'raymarch' renders the SAME geometry exactly (per-pixel ray–heightfield
    intersection); 'splat' is the per-pixel DIBR point splat
    (mesh_density unused).

    Sample i+1 renders on the device while a thread pool encodes sample i
    (the reference's AsyncImageWriter/AsyncVideoWriter overlap,
    Benchmark/benchmark.py:947-962); the frames are quantized to uint8 on
    the device and copied to the host inside the encode thread. The JAX
    package's native MJPEG/PNG encoder is not ported yet (ROADMAP A14):
    videos are cv2 DIVX and stills PIL PNG, as its fallback writes them.
    """
    import cv2

    from efficientdepthestimation_tpu_torch.apps.common import resolve_device

    device = resolve_device(device)
    timer = Timer()
    timer.start()

    video_dir = os.path.join(output_dir, "video")
    frame_dir = os.path.join(output_dir, "image")
    os.makedirs(video_dir, exist_ok=True)
    os.makedirs(frame_dir, exist_ok=True)

    samples = list(image_loader)
    num_frames = len(samples)
    if (len(os.listdir(video_dir)) == num_frames
            and len(os.listdir(frame_dir)) == num_frames):
        print("Found cached results, skipping...")
        timer.stop()
        return timer.elapsed

    depths = None if depth_loader is None else list(depth_loader)
    views = torch.from_numpy(sweep_views(fps, rotation_angle))
    expected_stills = 1 + (len(views) - INITIAL_DELAY - 1) // fps
    render = RENDERERS.get(method, render_novel_views)
    kwargs = dict(fov_y_deg=18.0, displacement_factor=displacement_factor)
    if render is not render_novel_views:
        kwargs["mesh_density"] = mesh_density

    def dispatch_render(i):
        """Host-side prep + device render; returns the uint8 frames on the
        device without waiting for them."""
        sample = samples[i]
        image = np.asarray(sample["image"], np.float32)
        if image.max() > 1.5:
            image = image / 255.0
        h, w = image.shape[:2]

        if depths is not None:
            depth = np.asarray(depths[i], np.float32)
        else:
            depth = np.asarray(sample["depth"], np.float32)
        depth = np.squeeze(depth)
        if depth.shape != (h, w):
            depth = cv2.resize(depth, (w, h), interpolation=cv2.INTER_CUBIC)
        dmin, dmax = depth.min(), depth.max()
        depth01 = (depth - dmin) / (dmax - dmin + np.finfo(np.float32).tiny)

        frames = render(_to_device(image, device),
                        _to_device(depth01.astype(np.float32), device),
                        views, **kwargs)
        # quantize on the device: 4x less to copy than float32
        return (torch.clamp(frames, 0.0, 1.0) * 255.0).to(torch.uint8), w, h

    def encode_sample(i, frames_dev, w, h):
        """Host encode (worker thread): waits for the device here, not in the
        dispatch loop. The video lands under a temp name and is renamed only
        after release(), so the per-sample resume cache never trusts a
        truncated file from a mid-encode crash."""
        from PIL import Image

        frames_u8 = frames_dev.cpu().numpy()
        sample_frame_dir = os.path.join(frame_dir, f"{i:06d}")
        os.makedirs(sample_frame_dir, exist_ok=True)
        video_path = os.path.join(video_dir, f"{i:06d}.avi")
        tmp_path = os.path.join(video_dir, f".tmp-{i:06d}.avi")
        writer = cv2.VideoWriter(
            tmp_path, cv2.VideoWriter_fourcc(*"DIVX"), fps, (w, h))
        for k, frame in enumerate(frames_u8):
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            if k >= INITIAL_DELAY and (k - INITIAL_DELAY) % fps == 0:
                Image.fromarray(frame).save(
                    os.path.join(sample_frame_dir, f"{k:06d}.png"))
        writer.release()
        os.replace(tmp_path, video_path)

    import concurrent.futures as cf

    encode_workers = max(1, min(4, (os.cpu_count() or 2) - 1))
    max_inflight = encode_workers + 1  # bounds device-side frame buffers
    inflight: list[cf.Future] = []
    with cf.ThreadPoolExecutor(max_workers=encode_workers) as pool:
        for i in range(num_frames):
            # per-sample cache: a crash/preemption mid-sweep resumes here
            # instead of redoing every finished sample (phase-level caching
            # is the reference's own crash-resume mechanism,
            # benchmark.py:724-733)
            video_path = os.path.join(video_dir, f"{i:06d}.avi")
            sample_frame_dir = os.path.join(frame_dir, f"{i:06d}")
            if (os.path.isfile(video_path) and os.path.isdir(sample_frame_dir)
                    and len(os.listdir(sample_frame_dir)) >= expected_stills):
                continue
            frames_dev, w, h = dispatch_render(i)
            inflight.append(pool.submit(encode_sample, i, frames_dev, w, h))
            while len(inflight) >= max_inflight:
                inflight.pop(0).result()
            print(f"\rProgress: [{i:02d}/{num_frames:02d}] {timer.elapsed}",
                  end="")
        for fut in inflight:
            fut.result()
    print()
    timer.stop()
    return timer.elapsed
