"""Resampling with PyTorch ``align_corners=True`` and PIL semantics.

Both resizes are separable, so each is two small matrix products with
interpolation matrices built on the host from float64 arithmetic (the same
functions as ``efficientdepthestimation_tpu/ops/resize.py``). PIL's antialiased
resampler is not ``F.interpolate(antialias=True)``; the matrices reproduce it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch._guards import detect_fake_mode

from efficientdepthestimation_tpu_torch.parallel import spatial

__all__ = [
    "bilinear_align_corners_matrix",
    "resize_bilinear_align_corners",
    "resize_whole",
    "band_matrix",
    "upsample_align_corners",
    "resize_nearest_torch",
    "nearest_torch_indices",
    "pil_resize_matrix",
    "pil_nearest_indices",
    "pil_resize",
    "device_constant",
]


@functools.lru_cache(maxsize=None)
def bilinear_align_corners_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) matrix for 1-D align_corners=True bilinear.

    torch maps output index ``i`` to source coordinate
    ``i * (in_size - 1) / (out_size - 1)`` (and 0 when out_size == 1).
    """
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    if out_size == 1:
        mat[0, 0] = 1.0
        return mat.astype(np.float32)
    scale = (in_size - 1) / (out_size - 1)
    src = np.arange(out_size, dtype=np.float64) * scale
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = src - lo
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo), 1.0 - frac)
    np.add.at(mat, (rows, hi), frac)
    return mat.astype(np.float32)


def _pil_filter(name: str):
    name = name.lower()
    if name == "bilinear":
        def triangle(x):
            x = np.abs(x)
            return np.where(x < 1.0, 1.0 - x, 0.0)

        return triangle, 1.0
    if name == "bicubic":
        a = -0.5  # Keys cubic, Pillow's default

        def cubic(x):
            x = np.abs(x)
            return np.where(
                x < 1.0,
                ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
            )

        return cubic, 2.0
    if name == "box":
        def box(x):
            return np.where((x > -0.5) & (x <= 0.5), 1.0, 0.0)

        return box, 0.5
    raise ValueError(f"Unsupported PIL filter '{name}'")


@functools.lru_cache(maxsize=None)
def pil_resize_matrix(in_size: int, out_size: int,
                      filter: str = "bilinear") -> np.ndarray:
    """Dense (out_size, in_size) matrix reproducing PIL's 1-D resampler.

    PIL widens the filter support by the scale factor when downsampling
    (antialiasing) and normalizes weights per output pixel.
    """
    fn, support = _pil_filter(filter)
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        j = np.arange(lo, hi)
        w = fn((j + 0.5 - center) / filterscale)
        total = w.sum()
        if total != 0:
            w = w / total
        mat[i, lo:hi] = w
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def pil_nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Source index per output pixel for PIL NEAREST resampling."""
    scale = in_size / out_size
    idx = ((np.arange(out_size) + 0.5) * scale).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def device_constant(make, *args, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``make(*args)`` as a tensor on ``device``, built and copied once.

    A host-to-device copy of a pageable array inside the serving loop can
    stall the host on the stream, so each constant is kept on the device.
    It is made outside inference mode even when first asked for inside it,
    so that a later forward with autograd may still use it. Within a
    fake-tensor trace (``torch.export``, ``torch.library.opcheck``) it is
    made anew, a constant of the traced graph, and kept out of the cache;
    symbolic sizes are taken at their traced values.
    """
    args = tuple(int(a) if isinstance(a, torch.SymInt) else a for a in args)
    if detect_fake_mode() is not None:
        return torch.as_tensor(make(*args), dtype=dtype, device=device)
    return _cached_constant(make, *args, dtype=dtype, device=device)


@functools.lru_cache(maxsize=64)
def _cached_constant(make, *args, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.as_tensor(make(*args), dtype=dtype, device=device)


def _apply_separable(x: torch.Tensor, h_mat, w_mat) -> torch.Tensor:
    """Apply 1-D resampling matrices along H and W of an NHWC tensor."""
    x = torch.einsum("Hh,nhwc->nHwc", h_mat, x)
    return torch.einsum("Ww,nhwc->nhWc", w_mat, x).contiguous()


def resize_bilinear_align_corners(x: torch.Tensor,
                                  size: tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize matching torch ``align_corners=True``.

    Of a band of rows (``parallel.spatial.row_sharded``): this rank's rows
    of the output, its rows of the global matrix applied to the source rows
    they read, fetched from their owners."""
    ctx = spatial.active()
    if ctx is not None:
        return _resize_band(ctx, x, size)
    return resize_whole(x, size)


def resize_whole(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``resize_bilinear_align_corners`` of ``x`` as a whole tensor, under
    any context: for an op that was handed its rows."""
    h_out, w_out = int(size[0]), int(size[1])
    _, h_in, w_in, _ = x.shape
    if (h_in, w_in) == (h_out, w_out):
        return x
    kw = dict(dtype=x.dtype, device=x.device)
    return _apply_separable(
        x,
        device_constant(bilinear_align_corners_matrix, h_in, h_out, **kw),
        device_constant(bilinear_align_corners_matrix, w_in, w_out, **kw),
    )


def band_matrix(in_size: int, out_size: int, start: int, stop: int,
                lo: int, hi: int) -> np.ndarray:
    """Rows ``[start, stop)`` and source columns ``[lo, hi)`` of
    ``bilinear_align_corners_matrix(in_size, out_size)``."""
    return bilinear_align_corners_matrix(in_size, out_size)[start:stop,
                                                            lo:hi]


def _resize_band(ctx, x: torch.Tensor, size) -> torch.Tensor:
    h_out, w_out = int(size[0]), int(size[1])
    h_in, w_in = ctx.height(x), x.shape[2]
    if (h_in, w_in) == (h_out, w_out):
        return x
    rows = ctx.fetch(x, h_in, h_out, lambda a, b: spatial.resize_rows(
        a, b, h_in, h_out))
    start, stop = ctx.rows(h_out)
    lo, hi = spatial.resize_rows(start, stop, h_in, h_out)
    kw = dict(dtype=x.dtype, device=x.device)
    ctx.note(h_out, w_out)
    return _apply_separable(
        rows,
        device_constant(band_matrix, h_in, h_out, start, stop, lo, hi, **kw),
        device_constant(bilinear_align_corners_matrix, w_in, w_out, **kw),
    )


def upsample_align_corners(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Upsample NHWC by an integer factor with align_corners=True semantics."""
    h, w = spatial.global_hw(x)
    return resize_bilinear_align_corners(x, (h * factor, w * factor))


@functools.lru_cache(maxsize=None)
def nearest_torch_indices(in_size: int, out_size: int) -> np.ndarray:
    """Source index per output pixel of ``F.interpolate(mode='nearest')``:
    ``floor(i · in / out)``, in float64 as the JAX package computes it."""
    idx = (np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def resize_nearest_torch(x: torch.Tensor,
                         size: tuple[int, int]) -> torch.Tensor:
    """NHWC nearest resize matching torch ``interpolate(mode='nearest')``."""
    h_out, w_out = int(size[0]), int(size[1])
    _, h_in, w_in, _ = x.shape
    if (h_in, w_in) == (h_out, w_out):
        return x
    kw = dict(dtype=torch.int64, device=x.device)
    rows = device_constant(nearest_torch_indices, h_in, h_out, **kw)
    cols = device_constant(nearest_torch_indices, w_in, w_out, **kw)
    return x[:, rows][:, :, cols]


#: The JAX and jaxlib versions whose XLA CPU dot ``xla_cpu_sum_order``
#: was read off. The order is that backend's GEMM kernels and blocking, not
#: a property of the resize: another XLA version may sum otherwise, and
#: then the port's uint8 levels part from JAX's at ties again (the C8 and
#: C9 tests fail and name both versions).
XLA_CPU_RULE_FITTED_ON = "jax 0.9.0, jaxlib 0.9.0"


def xla_cpu_fuses_sum(out_size: int) -> bool:
    """Whether the JAX package's f32 resize on the CPU adds each tap to its
    partial sum with one rounding (a fused multiply-add), in one running
    sum, rather than in four (``xla_cpu_sum_order``).

    XLA's CPU dot of (M, K) by the (K, out) matrix takes this kernel when
    ``(out - 1) % 64 >= 48`` (measured at M from 24 to 11,520 rows). The
    rule was read off one XLA version (``XLA_CPU_RULE_FITTED_ON``) and is
    tied to it.
    """
    return (out_size - 1) % 64 >= 48


def xla_cpu_sum_order(out_size: int) -> tuple[int, int]:
    """``(lanes, block)`` of the JAX package's f32 resize pass on the CPU,
    an XLA dot over the source index k.

    The dot cuts k into blocks of ``block`` from 0, sums each block on its
    own and adds the blocks' sums in ascending order, one rounding each.
    Within a block, source k goes to running sum ``k % lanes``, each a
    fused multiply-add in ascending k from zero; four lanes are then
    combined as ``(s0 + s1) + (s2 + s3)``. Where ``xla_cpu_fuses_sum`` holds,
    one lane in blocks of 512, else four lanes in blocks of 2048. Read off
    ``XLA_CPU_RULE_FITTED_ON`` bit for bit: 2 to 42 taps, K from 100 to
    5,200, out from 49 to 427.
    """
    return (1, 512) if xla_cpu_fuses_sum(out_size) else (4, 2048)


@functools.lru_cache(maxsize=None)
def pil_sum_program(in_size: int, out_size: int, filter: str = "bilinear"
                    ) -> tuple[np.ndarray, np.ndarray]:
    """``pil_resize_matrix`` as the sums of ``xla_cpu_sum_order``.

    Returns ``(indices, weights)``, each (blocks, lanes, steps, out_size):
    step j of lane r in the b-th block an output touches reads source
    ``indices[b, r, j]`` with weight ``weights[b, r, j]`` (0 past the
    output's taps there, its index then a valid one). The steps of a lane
    ascend in k.
    """
    mat = pil_resize_matrix(in_size, out_size, filter)
    lanes, block = xla_cpu_sum_order(out_size)
    nz = mat != 0
    lo = np.where(nz.any(1), nz.argmax(1), 0)
    hi = np.where(nz.any(1), in_size - nz[:, ::-1].argmax(1), 1)
    first = lo // block
    blocks = int((((hi - 1) // block) - first).max()) + 1
    slots = [[[] for _ in range(lanes)] for _ in range(blocks)]
    for n in range(out_size):
        per = [[[] for _ in range(lanes)] for _ in range(blocks)]
        for k in range(lo[n], hi[n]):
            per[k // block - first[n]][k % lanes].append(k)
        for b in range(blocks):
            for r in range(lanes):
                slots[b][r].append(per[b][r])
    steps = max(len(ks) for lane in slots for sums in lane for ks in sums)
    indices = np.tile(lo, (blocks, lanes, steps, 1))
    weights = np.zeros((blocks, lanes, steps, out_size), np.float32)
    for b in range(blocks):
        for r in range(lanes):
            for n, ks in enumerate(slots[b][r]):
                indices[b, r, :len(ks), n] = ks
                weights[b, r, :len(ks), n] = mat[n, ks]
    return indices.astype(np.int64), weights


def _pil_sum_indices(in_size: int, out_size: int, filter: str) -> np.ndarray:
    return pil_sum_program(in_size, out_size, filter)[0]


def _pil_sum_weights(in_size: int, out_size: int, filter: str) -> np.ndarray:
    return pil_sum_program(in_size, out_size, filter)[1]


def _pil_pass(x: torch.Tensor, in_size: int, out_size: int, axis: int,
              filter: str) -> torch.Tensor:
    """One pass of ``pil_resize`` along ``axis`` (1 or 2), rounded as the
    JAX package's XLA dot rounds it on the CPU (``xla_cpu_sum_order``): each
    tap a gather and elementwise IEEE operations, so that the CPU and the
    card give the same bits. A fused step is done in f64, where an f32
    product is exact, and rounded once to f32.
    """
    weights = pil_sum_program(in_size, out_size, filter)[1]
    blocks, lanes, steps, _ = weights.shape
    shape = [1] * x.dim()
    shape[axis] = out_size
    kw = dict(device=x.device)
    idx = device_constant(_pil_sum_indices, in_size, out_size, filter,
                          dtype=torch.int64, **kw)
    w = device_constant(_pil_sum_weights, in_size, out_size, filter,
                        dtype=torch.float64, **kw)
    total = None
    for b in range(blocks):
        sums = []
        for r in range(lanes):
            acc = None
            for j in range(steps):
                if not weights[b, r, j].any():
                    continue
                term = (w[b, r, j].reshape(shape)
                        * x.index_select(axis, idx[b, r, j]).double())
                acc = (term if acc is None else acc.double() + term).to(
                    x.dtype)
            sums.append(acc)
        if lanes == 1:
            part = sums[0]
        else:  # a lane no output of the block reads sums to zero
            zero = torch.zeros_like(next(s for s in sums if s is not None))
            s0, s1, s2, s3 = (zero if s is None else s for s in sums)
            part = (s0 + s1) + (s2 + s3)
        total = part if total is None else total + part
    return total


def pil_resize(x: torch.Tensor, size: tuple[int, int],
               filter: str = "bilinear",
               quantize_uint8: bool = False) -> torch.Tensor:
    """NHWC resize matching ``PIL.Image.resize`` (float path).

    ``quantize_uint8`` rounds half to even and clips to [0, 255] after
    resampling, matching the uint8 storage PIL applies between stages. A
    value that lies on a rounding tie within f32 error rounds to the side
    that the JAX package's summation order gives it, so each pass is then
    summed tap by tap as that package sums it on the CPU (``_pil_pass``),
    not by a matrix product whose order is the library's.
    """
    h_out, w_out = int(size[0]), int(size[1])
    _, h_in, w_in, _ = x.shape
    if (h_in, w_in) != (h_out, w_out):
        if filter.lower() == "nearest":
            kw = dict(dtype=torch.int64, device=x.device)
            rows = device_constant(pil_nearest_indices, h_in, h_out, **kw)
            cols = device_constant(pil_nearest_indices, w_in, w_out, **kw)
            x = x[:, rows][:, :, cols]
        elif quantize_uint8 and x.dtype == torch.float32:
            if h_in != h_out:
                x = _pil_pass(x, h_in, h_out, 1, filter)
            if w_in != w_out:
                x = _pil_pass(x, w_in, w_out, 2, filter)
            x = x.contiguous()
        else:
            kw = dict(dtype=x.dtype, device=x.device)
            x = _apply_separable(
                x,
                device_constant(pil_resize_matrix, h_in, h_out, filter, **kw),
                device_constant(pil_resize_matrix, w_in, w_out, filter, **kw),
            )
    if quantize_uint8:
        x = torch.clamp(torch.round(x), 0.0, 255.0)
    return x
