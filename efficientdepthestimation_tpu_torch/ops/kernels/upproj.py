"""Direct-path UpProjection: conv5×5 ∘ align-corners upsample in one kernel.

Counterpart of ``efficientdepthestimation_tpu/ops/pallas/upproj.py``.
``upsample_conv`` calls the registered op ``ede::upsample_conv``. Its CUDA
implementation launches the hand-written kernel in ``csrc/upsample_conv.cu``
(bf16 on the tensor cores, with the output tile from ``mma_tile``; f32 on
the CUDA cores), so the upsampled intermediate never reaches device memory;
its CPU implementation is the plain PyTorch version
``upsample_conv_plain``. PyTorch's dispatcher picks one by the tensors'
device, and neither falls back to the other. The op's autograd formula
(``register_autograd``) is ``upsample_conv_vjp``, the VJP of the plain
composition ``conv2d(resize(x), K)`` in x's dtype, as JAX's ``_bwd`` takes
it (``upproj.py:197-200``); its fake implementation gives the output shape
for ``torch.export``.

``upsample_conv_window`` (the op ``ede::upsample_conv_window``) computes a
row window of the same function for spatial serving, where each rank owns a
band of output rows: rows ``[row0, row0 + rows)`` of the ``size`` output
from the source rows ``[src0, src0 + x.shape[1])`` of a source of ``hs``
rows that they read. Align corners maps global row indices, so the kernel
takes the window's global coordinates rather than a slice of the output.
The window is eval only: asking for its gradient raises. Under
``parallel.spatial.row_sharded``, ``upsample_conv`` fetches its band's
source rows and calls the window.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from efficientdepthestimation_tpu_torch.ops.kernels import build
from efficientdepthestimation_tpu_torch.ops.resize import (
    _apply_separable,
    band_matrix,
    bilinear_align_corners_matrix,
    device_constant,
    resize_whole,
)
from efficientdepthestimation_tpu_torch.parallel import spatial

__all__ = ["upsample_conv", "upsample_conv_plain", "upsample_conv_vjp",
           "upsample_conv_window", "upsample_conv_window_plain", "mma_tile"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TAPS = 5


@functools.lru_cache(maxsize=None)
def mma_tile(h: int, w: int, c: int, o: int) -> tuple[int, int]:
    """(th, tw): the bf16 kernel's output tile for an (h, w) output, as the
    kernel's source picks it (``choose_tile`` in csrc/upsample_conv.cu),
    once a shape."""
    tile = (ctypes.c_int * 2)()
    if _lib().ede_upsample_conv_tile(h, w, c, o, tile):
        raise ValueError(f"upsample_conv: no tile fits C={c}, O={o}")
    return tile[0], tile[1]


def upsample_conv_plain(x: torch.Tensor, kernels: torch.Tensor,
                        size: tuple[int, int]) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the upsample in f32 rounded
    once to x's dtype, then the conv in f32, then the cast."""
    up = resize_whole(x.float(), size).to(x.dtype).float()
    w = kernels.float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(up.permute(0, 3, 1, 2), w, padding=kernels.shape[0] // 2)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def upsample_conv_window_plain(x: torch.Tensor, kernels: torch.Tensor,
                               size: tuple[int, int],
                               window: tuple[int, int, int, int]
                               ) -> torch.Tensor:
    """The window kernel's function in plain PyTorch: rows ``[row0, row0 +
    rows)`` of ``upsample_conv_plain`` of the whole source, for ``window``
    = (src0, hs, row0, rows) and ``x`` the source rows ``[src0, src0 +
    x.shape[1])``: the upsampled rows the window reads (within the conv's
    reach), from the global matrix's rows, then the conv with the image's
    zero padding where they meet its edges."""
    src0, hs, row0, rows = window
    h, w = int(size[0]), int(size[1])
    r = kernels.shape[0] // 2
    u0, u1 = max(row0 - r, 0), min(row0 + rows + r, h)
    kw = dict(dtype=torch.float32, device=x.device)
    a = device_constant(band_matrix, hs, h, u0, u1, src0,
                        src0 + x.shape[1], **kw)
    b = device_constant(bilinear_align_corners_matrix, x.shape[2], w, **kw)
    up = _apply_separable(x.float(), a, b).to(x.dtype).float()
    up = F.pad(up, (0, 0, 0, 0, r - (row0 - u0), r - (u1 - row0 - rows)))
    k = kernels.float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(up.permute(0, 3, 1, 2), k, padding=(0, r))
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("upsample_conv")
    fn = lib.ede_upsample_conv
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.ede_upsample_conv_window
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ede_upsample_conv_tile.argtypes = ([ctypes.c_int] * 4
                                           + [ctypes.POINTER(ctypes.c_int)])
    lib.ede_upsample_conv_tile.restype = ctypes.c_int
    return lib


def upsample_conv_vjp(x: torch.Tensor, kernels: torch.Tensor,
                      size: tuple[int, int], g: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dkernels) of ``conv2d(resize_bilinear_align_corners(x, size),
    kernels, pad=2)`` for the cotangent ``g`` (N, H, W, O), in x's dtype:
    the conv's input and weight gradients, then the transposed resize."""
    up = resize_whole(x, size).permute(0, 3, 1, 2)
    w = kernels.to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    g = g.to(x.dtype).permute(0, 3, 1, 2)
    pad = kernels.shape[0] // 2
    d_up = torch.nn.grad.conv2d_input(up.shape, w, g, padding=pad)
    d_w = torch.nn.grad.conv2d_weight(up, w.shape, g, padding=pad)
    d_up = d_up.permute(0, 2, 3, 1)
    _, hs, ws, _ = x.shape
    h, w_out = int(size[0]), int(size[1])
    if (hs, ws) != (h, w_out):
        kw = dict(dtype=x.dtype, device=x.device)
        a = device_constant(bilinear_align_corners_matrix, hs, h, **kw)
        b = device_constant(bilinear_align_corners_matrix, ws, w_out, **kw)
        d_up = torch.einsum("Ww,nhWc->nhwc", b,
                            torch.einsum("Hh,nHwc->nhwc", a, d_up))
    return (d_up.contiguous(),
            d_w.permute(2, 3, 1, 0).to(kernels.dtype).contiguous())


def _check(x: torch.Tensor, kernels: torch.Tensor) -> None:
    if x.dtype not in _DTYPES or kernels.dtype != x.dtype:
        raise TypeError("upsample_conv: x must be f32 or bf16 and kernels "
                        f"of the same dtype, got {x.dtype}, {kernels.dtype}")
    if x.dim() != 4 or kernels.dim() != 4:
        raise ValueError("upsample_conv: x must be (N,hs,ws,C) and kernels "
                         "(5,5,C,O)")
    if tuple(kernels.shape[:3]) != (_TAPS, _TAPS, x.shape[3]):
        raise ValueError(f"upsample_conv: kernels {tuple(kernels.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    if kernels.device != x.device:
        raise ValueError(f"upsample_conv: kernels must be on {x.device}")
    if not (x.is_contiguous() and kernels.is_contiguous()):
        raise ValueError("upsample_conv: tensors must be contiguous")


def _launch(x: torch.Tensor, kernels: torch.Tensor, h: int, w: int,
            window: tuple[int, int, int, int]) -> torch.Tensor:
    """One launch of the kernel for rows ``[row0, row0 + rows)`` of the
    (h, w) output, ``window`` = (src0, hs, row0, rows)."""
    n, hl, ws, c = x.shape
    o = kernels.shape[-1]
    src0, hs, row0, rows = window
    if min(n, c, o, h, w, rows) <= 0:
        raise ValueError(f"upsample_conv: empty shape x {tuple(x.shape)}, "
                         f"size {(h, w)}, rows {rows}")
    th, tw = mma_tile(rows, w, c, o) if x.dtype == torch.bfloat16 else (0, 0)
    y = torch.empty((n, rows, w, o), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ede_upsample_conv_window(
            _DTYPES[x.dtype], x.data_ptr(), kernels.data_ptr(), y.data_ptr(),
            n, hl, src0, hs, ws, c, h, w, o, row0, rows, th, tw, stream)
    build.check(lib, err, "upsample_conv")
    upsample_conv.launches += 1
    return y


def _upsample_conv_cuda(x: torch.Tensor, kernels: torch.Tensor,
                        size: list[int]) -> torch.Tensor:
    """The op's CUDA implementation: one launch of the kernel. A plain
    function, so that the op's dispatch cost can be timed against a call
    of it."""
    _check(x, kernels)
    h, w = int(size[0]), int(size[1])
    return _launch(x, kernels, h, w, (0, x.shape[1], 0, h))


_upsample_conv_op = torch.library.custom_op(
    "ede::upsample_conv", _upsample_conv_cuda, mutates_args=(),
    device_types="cuda")


@_upsample_conv_op.register_kernel("cpu")
def _upsample_conv_cpu(x, kernels, size):
    return upsample_conv_plain(x, kernels, tuple(size))


@_upsample_conv_op.register_fake
def _upsample_conv_fake(x, kernels, size):
    return x.new_empty((x.shape[0], size[0], size[1], kernels.shape[-1]))


def _setup_context(ctx, inputs, output):
    x, kernels, size = inputs
    ctx.save_for_backward(x, kernels)
    ctx.size = tuple(size)


def _backward(ctx, g):
    x, kernels = ctx.saved_tensors
    dx, dk = upsample_conv_vjp(x, kernels, ctx.size, g)
    return dx, dk, None


_upsample_conv_op.register_autograd(_backward, setup_context=_setup_context)


def _window_cuda(x: torch.Tensor, kernels: torch.Tensor, size: list[int],
                 window: list[int]) -> torch.Tensor:
    """The window op's CUDA implementation: one launch of the kernel."""
    _check(x, kernels)
    return _launch(x, kernels, int(size[0]), int(size[1]), tuple(window))


_window_op = torch.library.custom_op(
    "ede::upsample_conv_window", _window_cuda, mutates_args=(),
    device_types="cuda")


@_window_op.register_kernel("cpu")
def _window_cpu(x, kernels, size, window):
    return upsample_conv_window_plain(x, kernels, tuple(size), tuple(window))


@_window_op.register_fake
def _window_fake(x, kernels, size, window):
    return x.new_empty((x.shape[0], window[3], size[1], kernels.shape[-1]))


def _window_backward(ctx, g):
    raise NotImplementedError(
        "upsample_conv_window has no gradient: spatial serving is eval only")


_window_op.register_autograd(_window_backward,
                             setup_context=lambda ctx, inputs, output: None)


def upsample_conv_window(x: torch.Tensor, kernels: torch.Tensor,
                         size: tuple[int, int],
                         window: tuple[int, int, int, int]) -> torch.Tensor:
    """Rows ``[row0, row0 + rows)`` of ``upsample_conv(source, kernels,
    size)``, ``window`` = (src0, hs, row0, rows), from ``x`` = rows
    ``[src0, src0 + x.shape[1])`` of the ``hs``-row source, which must hold
    every source row the window reads (``parallel.spatial.
    upsample_conv_rows``). Returns (N, rows, W, O). Eval only."""
    build.check_device("upsample_conv", x.device)
    src0, hs, row0, rows = (int(v) for v in window)
    h = int(size[0])
    lo, hi = spatial.upsample_conv_rows(row0, row0 + rows, hs, h,
                                        kernels.shape[0])
    if not (0 <= row0 and rows > 0 and row0 + rows <= h and src0 <= lo
            and hi <= src0 + x.shape[1] <= hs):
        raise ValueError(f"upsample_conv_window: rows [{row0}, "
                         f"{row0 + rows}) of {h} read source rows [{lo}, "
                         f"{hi}) of {hs}; x holds [{src0}, "
                         f"{src0 + x.shape[1]})")
    return _window_op(x, kernels, [h, int(size[1])], [src0, hs, row0, rows])


def upsample_conv(x: torch.Tensor, kernels: torch.Tensor,
                  size: tuple[int, int]) -> torch.Tensor:
    """``conv2d(resize_bilinear_align_corners(x, size), kernels, pad=2)``.

    x: (N, hs, ws, C) bf16 or f32; kernels: HWIO (5, 5, C, O) in x's dtype,
    both UpProjection branches stacked on O. Returns (N, H, W, O) in x's
    dtype, summed in f32. Differentiable in x and kernels. ``launches``
    counts the kernel's launches (CPU calls do not count).

    Of a band of rows (``parallel.spatial.row_sharded``): this rank's rows
    of it, through ``upsample_conv_window`` on the source rows they read,
    fetched from their owners. A rank that owns no output rows launches
    nothing.
    """
    build.check_device("upsample_conv", x.device)
    ctx = spatial.active()
    if ctx is None:
        return _upsample_conv_op(x, kernels, [int(size[0]), int(size[1])])
    h, w = int(size[0]), int(size[1])
    hs = ctx.height(x)

    def reads(start, stop):
        return spatial.upsample_conv_rows(start, stop, hs, h,
                                          kernels.shape[0])

    x = ctx.fetch(x, hs, h, reads)
    start, stop = ctx.rows(h)
    ctx.note(h, w)
    if stop == start:
        return x.new_zeros((x.shape[0], 0, w, kernels.shape[-1]))
    return upsample_conv_window(x.contiguous(), kernels, (h, w),
                                (reads(start, stop)[0], hs, start,
                                 stop - start))


upsample_conv.launches = 0
