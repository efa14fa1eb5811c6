"""Spatial (row-sharded) serving: the rows of every activation across ranks.

JAX's spatial mode (``make_infer_fn(mesh=..., spatial=True)``) constrains
the preprocessed images to a sharding of their rows over every device, and
GSPMD partitions each conv, pool and resize after it, exchanging the halo
rows a device's outputs read from its neighbours. PyTorch has no
partitioner, so the port writes that partition out:

* **Bands.** At every op whose output rows depend on other rows (a conv
  or pool of height > 1 or stride > 1, an align-corners resize), each rank
  owns a contiguous block of the op's *output* rows, split as GSPMD splits
  a ragged dimension: ``ceil(H / n)`` rows a rank, in rank order, so the
  last ranks may own fewer rows or none (``owned_rows``).
* **Halos.** A rank computes only its own rows. It reads exactly the input
  rows they need (``window_rows``, ``resize_rows``, ``upsample_conv_rows``),
  fetching the ones it does not own from the ranks that do
  (``RowSharded.fetch``); rows outside the image are the op's padding.
* **Reductions.** A spatial sum (the squeeze-excite means, a global average
  pool) is the sum of the bands' sums, all-reduced, over the global plane.

The ops (``ops.conv``, ``ops.resize``, ``ops.fused``, the kernels' wrappers
and the models' size bookkeeping) read the context ``row_sharded`` opens:
inside it a 4-D activation is this rank's band of a level whose global
height the context knows from the level's width (``RowSharded.height``).
Every rank runs the same ops in the same order, so every rank enters every
collective, also one whose band at some level is empty.

The exchange is one ``all_reduce`` (a sum) of a buffer of the halo rows
that any rank needs, each filled by its owner and zero elsewhere: the sum
is the owner's value exactly. ``all_reduce`` is what the gloo backend also
takes on CUDA tensors (two ranks sharing one card); NCCL takes it on a
machine of several cards.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
import torch.distributed as dist

__all__ = ["owned_rows", "window_rows", "window_out_height", "resize_rows",
           "upsample_conv_rows", "RowSharded", "row_sharded", "active",
           "global_hw"]


def owned_rows(h: int, world: int, rank: int) -> tuple[int, int]:
    """``[start, stop)``: the rows of ``h`` that ``rank`` of ``world`` owns,
    ``ceil(h / world)`` a rank in rank order (empty past the last row)."""
    per = -(-h // world)
    start = min(rank * per, h)
    return start, min(start + per, h)


def window_out_height(in_h: int, k: int, stride: int, pad_top: int,
                      pad_bottom: int, ceil_mode: bool = False) -> int:
    """Output rows of a window op (conv or pool) on ``in_h`` rows, with
    PyTorch's ``ceil_mode`` rule: a last window must start inside the input
    or its top padding."""
    span = in_h + pad_top + pad_bottom - k
    if not ceil_mode:
        return span // stride + 1
    out = -(-span // stride) + 1
    if (out - 1) * stride >= in_h + pad_top:
        out -= 1
    return out


def window_rows(start: int, stop: int, k: int, stride: int, pad_top: int,
                in_h: int) -> tuple[int, int, int, int]:
    """``(lo, hi, above, below)``: output rows ``[start, stop)`` of a window
    op (height ``k``, ``stride``, ``pad_top`` rows of padding above the
    image) read input rows ``[lo, hi)`` and ``above``/``below`` rows of
    padding, so that the op on those rows, padded so, gives exactly
    ``stop - start`` rows. Empty for an empty block."""
    if stop <= start:
        return 0, 0, 0, 0
    first = start * stride - pad_top
    last = (stop - 1) * stride - pad_top + k  # one past the last row read
    lo, hi = max(first, 0), min(last, in_h)
    return lo, max(hi, lo), lo - first, last - max(hi, lo)


@functools.lru_cache(maxsize=4096)
def resize_rows(start: int, stop: int, in_h: int, out_h: int
                ) -> tuple[int, int]:
    """``[lo, hi)``: the source rows that align-corners rows ``[start,
    stop)`` of an ``in_h`` → ``out_h`` resize read. Each output row reads
    ``floor(src)`` and the row below it (clamped to the image), also where
    that row's weight is 0 (``src`` on a source row): the upsample-conv
    kernel loads both, so a window must hold both. Empty for an empty
    block."""
    if stop <= start:
        return 0, 0
    step = (in_h - 1) / (out_h - 1) if out_h > 1 else 0.0

    def lo_of(i: int) -> int:  # float64, as the kernel and the matrix
        return min(max(math.floor(i * step), 0), in_h - 1)

    return lo_of(start), min(lo_of(stop - 1) + 1, in_h - 1) + 1


@functools.lru_cache(maxsize=4096)
def upsample_conv_rows(start: int, stop: int, in_h: int, out_h: int,
                       taps: int = 5) -> tuple[int, int]:
    """``[lo, hi)``: the source rows that rows ``[start, stop)`` of
    ``conv_taps×taps(resize(x, out_h), pad=taps//2)`` read: the resize rows
    of the upsampled rows within ``taps // 2`` of the block."""
    if stop <= start:
        return 0, 0
    r = taps // 2
    return resize_rows(max(start - r, 0), min(stop + r, out_h), in_h, out_h)


@functools.lru_cache(maxsize=4096)
def _plan(in_h: int, world: int, rank: int, needs: tuple
          ) -> tuple[tuple[int, ...], tuple[int, ...], tuple[int, ...],
                     tuple[int, ...]]:
    """The exchange of ``needs`` (each rank's ``[lo, hi)`` of ``in_h``
    rows): the halo rows any rank needs and does not own; of them, the
    buffer slots this rank fills and its local rows that fill them; and the
    index of each row this rank needs in ``cat([band, buffer])``."""
    own = [owned_rows(in_h, world, q) for q in range(world)]
    halo = sorted({row for q, (lo, hi) in enumerate(needs)
                   for row in range(lo, hi)
                   if not own[q][0] <= row < own[q][1]})
    s0, s1 = own[rank]
    slots = tuple(i for i, row in enumerate(halo) if s0 <= row < s1)
    sources = tuple(halo[i] - s0 for i in slots)
    slot_of = {row: i for i, row in enumerate(halo)}
    lo, hi = needs[rank]
    index = tuple(row - s0 if s0 <= row < s1 else (s1 - s0) + slot_of[row]
                  for row in range(lo, hi))
    return tuple(halo), slots, sources, index


@functools.lru_cache(maxsize=4096)
def _index(values: tuple[int, ...], device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.int64, device=device)


@dataclasses.dataclass
class RowSharded:
    """Serving row-sharded over ``group`` (a ``torch.distributed`` process
    group, None for a world of one) as ``rank`` of ``world``. ``heights``
    maps the width of each level seen so far to its global height."""

    group: object
    world: int
    rank: int
    heights: dict = dataclasses.field(default_factory=dict)
    #: collectives issued (exchanges and reductions)
    collectives: int = 0
    #: for each fetch of an op's input, ``(in_h, out_h, start, stop, lo,
    #: hi)``: its output rows ``[start, stop)`` and the input rows ``[lo,
    #: hi)`` this rank read for them
    fetched: list = dataclasses.field(default_factory=list)

    def note(self, h: int, w: int) -> None:
        """Record a level of global height ``h`` and width ``w``. Two
        levels of one width and different heights could not be told apart
        from their bands, so that raises."""
        seen = self.heights.setdefault(int(w), int(h))
        if seen != h:
            raise ValueError(f"spatial serving: two levels of width {w} have "
                             f"heights {seen} and {h}; a band cannot tell "
                             "them apart")

    def height(self, x: torch.Tensor) -> int:
        """The global height of the level of band ``x`` (N, rows, W, C)."""
        w = int(x.shape[2])
        if w not in self.heights:
            raise ValueError(f"spatial serving: no level of width {w} is "
                             "known; an op made it without noting it")
        h = self.heights[w]
        start, stop = self.rows(h)
        if x.shape[1] != stop - start:
            raise ValueError(f"spatial serving: a band of {x.shape[1]} rows "
                             f"at height {h}, where rank {self.rank} owns "
                             f"{stop - start}")
        return h

    def rows(self, h: int) -> tuple[int, int]:
        """``[start, stop)``: this rank's rows of a level of height ``h``."""
        return owned_rows(h, self.world, self.rank)

    def band(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole (N, H, W, C) tensor, its level
        noted."""
        self.note(x.shape[1], x.shape[2])
        start, stop = self.rows(x.shape[1])
        return x[:, start:stop]

    def fetch(self, x: torch.Tensor, in_h: int, out_h: int,
              reads) -> torch.Tensor:
        """The input rows of this rank's block of an op's ``out_h`` output
        rows, from band ``x`` of its ``in_h`` input rows: ``reads(start,
        stop)`` gives the ``[lo, hi)`` that a block ``[start, stop)``
        reads. Every rank calls it for the same op, and the rows a rank
        does not own come from their owners in one ``all_reduce`` of the
        halo rows that any rank needs (none when no rank needs one)."""
        needs = tuple(tuple(reads(*owned_rows(out_h, self.world, q)))
                      for q in range(self.world))
        halo, slots, sources, index = _plan(in_h, self.world, self.rank,
                                            needs)
        lo, hi = needs[self.rank]
        start, stop = self.rows(out_h)
        self.fetched.append((in_h, out_h, start, stop, lo, hi))
        if halo:
            n, _, w, c = x.shape
            buf = x.new_zeros((n, len(halo), w, c))
            if slots:
                buf[:, _index(slots, x.device)] = x[:, _index(sources,
                                                              x.device)]
            self._all_reduce(buf)
        if hi <= lo:
            return x[:, :0]
        if not halo:
            s0 = self.rows(in_h)[0]
            return x[:, lo - s0:hi - s0]
        return torch.cat([x, buf], dim=1)[:, _index(index, x.device)]

    def window(self, x: torch.Tensor, k: int, stride: int, pad_top: int,
               pad_bottom: int, ceil_mode: bool = False
               ) -> tuple[torch.Tensor, int, int, int]:
        """The input of this rank's output rows of a window op (height
        ``k``, ``stride``, ``pad_top``/``pad_bottom`` rows of padding,
        ``ceil_mode`` as PyTorch's pools) on band ``x``: ``(rows, above,
        below, out_h)``, the input rows its block reads, fetched, the rows
        of padding to add above and below them, and the op's global output
        height. The op on ``rows`` so padded gives this rank's block."""
        in_h = self.height(x)
        out_h = window_out_height(in_h, k, stride, pad_top, pad_bottom,
                                  ceil_mode)
        rows = self.fetch(x, in_h, out_h, lambda a, b: window_rows(
            a, b, k, stride, pad_top, in_h)[:2])
        _, _, above, below = window_rows(*self.rows(out_h), k, stride,
                                         pad_top, in_h)
        return rows, above, below, out_h

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, out of place."""
        t = t.clone()
        self._all_reduce(t)
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s maximum over the ranks, out of place."""
        t = t.clone()
        self._all_reduce(t, dist.ReduceOp.MAX)
        return t

    def _all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> None:
        self.collectives += 1
        if self.group is not None:
            dist.all_reduce(t, op=op, group=self.group)


_ACTIVE: RowSharded | None = None


@contextlib.contextmanager
def row_sharded(mesh):
    """Within the block, activations are bands of rows over ``mesh``'s
    ranks (a ``parallel.Mesh``): the ops exchange halos and all-reduce
    spatial sums. Yields the context. A world of one owns every row and
    issues no collective."""
    global _ACTIVE
    ctx = RowSharded(group=mesh.group, world=mesh.world_size, rank=mesh.rank)
    saved, _ACTIVE = _ACTIVE, ctx
    try:
        yield ctx
    finally:
        _ACTIVE = saved


def active() -> RowSharded | None:
    """The row-sharded context in force, or None."""
    return _ACTIVE


def global_hw(x: torch.Tensor) -> tuple[int, int]:
    """(H, W) of NHWC ``x``'s level: its own under no context, else the
    global height of the level of its band."""
    if _ACTIVE is None:
        return int(x.shape[1]), int(x.shape[2])
    return _ACTIVE.height(x), int(x.shape[2])
