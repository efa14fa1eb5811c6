"""Spatial (row-sharded) serving of the port, and the eval preprocess at the
sizes where it once parted from JAX's.

* **Band geometry**, in one process: each row-dependent op (conv, max and
  average pool, align-corners resize, both upsample-conv routes, the
  depthwise kernel's plain version) on a rank's band, its halo sliced from
  the whole input (``Sliced``), against the op on the whole input sliced to
  the rank's rows; and the input rows it fetched against the rows its
  outputs depend on, found by autograd. 1-8 ranks, ranks without rows
  among them.
* **The window** of the upsample-conv op against the whole-image op sliced,
  its ``opcheck``, and its gradient, which raises.
* **Serving across processes** (``_torch_spatial_runner.py``, gloo ranks
  on the CPU, one launch for every multi-rank case): ENB0-HU from its
  ``.ede`` at batch 1, 228×304, upsampled to 480×640, on 2, 3 and 8 ranks
  against one process at rtol and atol 1e-5, as JAX's
  ``tests/test_apps.py:353-374`` holds its spatial mode, and on 8 ranks
  against JAX's own spatial output on its 8 CPU devices; ENB0-LR, RN18-HU,
  DN121-HU, SENet-154 (a block a stage) and the serving options on 3 ranks
  at 64×96; what each rank read; ``inference_benchmark --spatial`` on 2.
* **C8**: ``eval_preprocess_image_only`` against JAX's on uint8 frames
  whose Scale-240 factor is not 2.
"""

import contextlib
import functools
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import jaxlib
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from efficientdepthestimation_tpu.apps.common import (
    load_any_checkpoint as jax_load_any_checkpoint,
)
from efficientdepthestimation_tpu.apps.common import (
    make_infer_fn as jax_make_infer_fn,
)
from efficientdepthestimation_tpu.data.transforms import (
    eval_preprocess_image_only as jax_eval_preprocess,
)
from efficientdepthestimation_tpu.parallel import (
    create_mesh as jax_create_mesh,
)
from efficientdepthestimation_tpu.parallel.mesh import (
    spatial_sharding as jax_spatial_sharding,
)

from efficientdepthestimation_tpu_torch.apps.common import make_infer_fn
from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
    save_checkpoint,
)
from efficientdepthestimation_tpu_torch.data.transforms import (
    eval_preprocess_image_only,
)
from efficientdepthestimation_tpu_torch.ops import conv as conv_ops
from efficientdepthestimation_tpu_torch.ops.fused import upsample_conv_stacked
from efficientdepthestimation_tpu_torch.ops.kernels.depthwise import (
    depthwise_bn_swish,
)
from efficientdepthestimation_tpu_torch.ops.kernels.upproj import (
    upsample_conv,
    upsample_conv_window,
)
from efficientdepthestimation_tpu_torch.ops.resize import (
    XLA_CPU_RULE_FITTED_ON,
    bilinear_align_corners_matrix,
    resize_bilinear_align_corners,
)
from efficientdepthestimation_tpu_torch.parallel import spatial
from efficientdepthestimation_tpu_torch.parallel.mesh import (
    Mesh,
    spatial_sharding,
)

import spatial_cases as cases
from torch_tmp_cleanup import delete_tmp_path  # noqa: F401  (autouse)
from torch_tmp_cleanup import removed_after

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
RUNNER = os.path.join(TESTS, "_torch_spatial_runner.py")
LAUNCH_TIMEOUT_S = 300
COLLECTIVE_TIMEOUT_S = 120
WORLDS = tuple(range(1, 9))
# the worlds whose rows read are also found by autograd (a backward a rank)
READ_WORLDS = (1, 2, 3, 5, 8)
PREPROCESS_ATOL = 7e-5  # chip_smoke.py's
SERVE_TOL = dict(rtol=1e-5, atol=1e-5)  # JAX's tests/test_apps.py:373
# bf16 against bf16 in one process: both round the same f32 sums, but a
# band's halo sums may round to the other side of a bf16 step
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two PyTorch threads in the test process: the suite runs its files in
    parallel workers, and the runner's eight ranks beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def runner_threads(case: str):
    """An int8 case's one-process reference at the runner's one thread: the
    thread count changes the CPU conv's f32 blocking, and where a quantized
    conv's input sits at an int8 rounding step that ulp moves it a step
    (RN50-HU's int8 output moves by 0.0102 of 0.85 from 1 to 2 threads in
    one process on the CPU)."""
    n = torch.get_num_threads()
    if "int8" in case:
        torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def rank_of(world: int, rank: int) -> Mesh:
    return Mesh(group=None, world_size=world, rank=rank,
                shape={"data": world, "model": 1}, data_index=rank,
                device=torch.device("cpu"))


# ---------------------------------------------------------------- geometry


class Sliced(spatial.RowSharded):
    """Rank ``rank`` of ``world`` in one process: an op's halo is sliced
    from ``whole``, the op's whole input, and a reduction is the band's
    own."""

    def __init__(self, world: int, rank: int, whole: torch.Tensor):
        super().__init__(group=None, world=world, rank=rank)
        self.whole = whole
        self.note(whole.shape[1], whole.shape[2])

    def fetch(self, x, in_h, out_h, reads):
        start, stop = self.rows(out_h)
        lo, hi = reads(start, stop)
        self.fetched.append((in_h, out_h, start, stop, lo, hi))
        return self.whole[:, lo:hi] if hi > lo else self.whole[:, :0]


def on_band(op, whole: torch.Tensor, world: int, rank: int):
    """``op`` of rank ``rank``'s band of ``whole`` under ``Sliced``; returns
    the output and the rows the op fetched."""
    ctx = Sliced(world, rank, whole)
    start, stop = ctx.rows(whole.shape[1])
    saved, spatial._ACTIVE = spatial._ACTIVE, ctx
    try:
        out = op(whole[:, start:stop])
    finally:
        spatial._ACTIVE = saved
    return out, ctx.fetched


def read_rows(op, whole: torch.Tensor, start: int, stop: int
              ) -> tuple[int, int]:
    """The first and one past the last input row that output rows
    ``[start, stop)`` of ``op`` depend on (non-zero gradient)."""
    x = whole.detach().clone().requires_grad_(True)
    out = op(x)[:, start:stop]
    weights = torch.rand(out.shape, dtype=out.dtype,
                         generator=torch.Generator().manual_seed(0)) + 0.5
    (grad,) = torch.autograd.grad((out * weights).sum(), x)
    rows = torch.nonzero(grad.abs().sum(dim=(0, 2, 3))).flatten()
    return int(rows[0]), int(rows[-1]) + 1


def with_zero_tap(reads: tuple[int, int], in_h: int, out_h: int,
                  stop: int, reach: int = 0) -> tuple[int, int]:
    """``reads`` (the source rows that output rows below ``stop`` depend
    on) widened to the row below the last upsampled row's first source row,
    within the image: the upsample-conv kernel loads it also where its
    weight is 0. The last upsampled row is the one ``reach`` rows below the
    block (the conv's halo)."""
    last = min(stop + reach, out_h) - 1
    first = int(np.nonzero(bilinear_align_corners_matrix(in_h, out_h)[
        last])[0][0])
    return reads[0], max(reads[1], min(first + 1, in_h - 1) + 1)


def check_bands(op, whole: torch.Tensor, out_h: int, exact_reads=True,
                widen=None, **tol):
    """Every rank of every world of ``WORLDS``: ``op`` on its band equals
    ``op`` of ``whole`` at its rows; in ``READ_WORLDS`` it fetched exactly
    the rows those depend on (``exact_reads``; else the rows of their
    windows), widened by ``widen(reads, stop)`` where given."""
    want = op(whole)
    assert want.shape[1] == out_h
    for world in WORLDS:
        for rank in range(world):
            got, fetched = on_band(op, whole, world, rank)
            start, stop = spatial.owned_rows(out_h, world, rank)
            torch.testing.assert_close(got, want[:, start:stop], **tol)
            if out_h == whole.shape[1] and not fetched:
                continue  # a row-local op (a 1×1 conv) reads its own rows
            assert len(fetched) == 1
            in_h, h, a, b, lo, hi = fetched[0]
            assert (in_h, h, a, b) == (whole.shape[1], out_h, start, stop)
            if stop > start and exact_reads and world in READ_WORLDS:
                reads = read_rows(op, whole, start, stop)
                if widen is not None:
                    reads = widen(reads, stop)
                assert (lo, hi) == reads
            assert (stop > start) == (hi > lo)


@pytest.mark.parametrize("h", [1, 7, 8, 9, 29, 57, 228, 480])
def test_owned_rows_split_as_gspmd_pads(h):
    """``ceil(h / world)`` rows a rank in rank order, covering every row
    once; JAX's sharding of a dimension the devices divide agrees."""
    for world in range(1, 9):
        blocks = [spatial.owned_rows(h, world, r) for r in range(world)]
        assert [row for a, b in blocks for row in range(a, b)] == \
            list(range(h))
        assert all(b - a == min(-(-h // world), h - a) for a, b in blocks)
        rows = [spatial_sharding(rank_of(world, r)).rows(h)
                for r in range(world)]
        assert [(s.start, s.stop) for s in rows] == blocks
    if h % 8 == 0:
        index = jax_spatial_sharding(jax_create_mesh()).devices_indices_map(
            (1, h, 4, 3))
        jax_blocks = [index[d][1] for d in sorted(index, key=lambda d: d.id)]
        assert [(s.start, s.stop) for s in jax_blocks] == \
            [spatial.owned_rows(h, 8, r) for r in range(8)]


# (k, stride, (top, bottom)): the TF-same asymmetric pads of EfficientNet
# (same_padding_static), torch's symmetric ones, a 1×1 stride-2 projection
CONVS = [(1, 1, (0, 0)), (1, 2, (0, 0)), (3, 1, (1, 1)), (3, 2, (0, 1)),
         (3, 2, (1, 1)), (5, 1, (2, 2)), (5, 2, (1, 2)), (7, 2, (3, 3))]


@pytest.mark.parametrize("k,stride,pads", CONVS)
@pytest.mark.parametrize("h", [13, 29])
def test_conv_band_matches_sliced_conv(k, stride, pads, h):
    gen = torch.Generator().manual_seed(k * 10 + stride)
    x = torch.randn(2, h, 9, 3, generator=gen, dtype=torch.float64)
    w = torch.randn(4, 3, k, k, generator=gen, dtype=torch.float64)
    padding = (pads, (k // 2, k // 2))

    def op(t):
        return conv_ops.conv2d(t, w, stride=stride, padding=padding)

    check_bands(op, x, spatial.window_out_height(h, k, stride, *pads))


@pytest.mark.parametrize("k,stride,pad,ceil", [(3, 2, 1, False),
                                               (3, 2, 0, True),
                                               (2, 2, 0, True)])
@pytest.mark.parametrize("h", [8, 13, 16, 29])
def test_max_pool_band_matches_sliced_pool(k, stride, pad, ceil, h):
    """ResNet's and DenseNet's stem pool, SENet's ceil-mode pool: the rows'
    -inf padding is the op's, also where a ceil-mode window runs past it."""
    x = torch.randn(1, h, 11, 2, generator=torch.Generator().manual_seed(h),
                    dtype=torch.float64)

    def op(t):
        return conv_ops.max_pool(t, k, stride, padding=pad, ceil_mode=ceil)

    out_h = spatial.window_out_height(h, k, stride, pad, pad, ceil)
    check_bands(op, x, out_h, exact_reads=False, rtol=0, atol=0)
    for world in WORLDS:
        for rank in range(world):
            _, ((_, _, a, b, lo, hi),) = on_band(op, x, world, rank)
            if b > a:
                assert (lo, hi) == (max(a * stride - pad, 0),
                                    min((b - 1) * stride - pad + k, h))


@pytest.mark.parametrize("h", [8, 15])
def test_avg_pool_band_matches_sliced_pool(h):
    """DenseNet's 2×2 transition pool."""
    x = torch.randn(1, h, 10, 2, generator=torch.Generator().manual_seed(h),
                    dtype=torch.float64)
    check_bands(lambda t: conv_ops.avg_pool(t, 2, 2), x, h // 2)


@pytest.mark.parametrize("in_h,out_h", [(8, 15), (15, 8), (29, 57),
                                        (57, 114), (114, 480), (16, 6)])
def test_resize_band_matches_sliced_resize(in_h, out_h):
    """Align corners, up (the decoders, the output upsample) and down."""
    x = torch.randn(1, in_h, 6, 2, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    check_bands(lambda t: resize_bilinear_align_corners(t, (out_h, 11)), x,
                out_h, widen=lambda reads, stop: with_zero_tap(
                    reads, in_h, out_h, stop))


UPSAMPLES = [(4, 8), (8, 15), (15, 29), (29, 57), (57, 114)]


@pytest.mark.parametrize("in_h,out_h", UPSAMPLES)
def test_upsample_conv_stacked_band_matches_sliced(in_h, out_h):
    """The einsum route of a Hu2018 head: conv5×5 ∘ upsample."""
    gen = torch.Generator().manual_seed(in_h)
    x = torch.randn(1, in_h, 5, 3, generator=gen, dtype=torch.float64)
    k = torch.randn(5, 5, 3, 4, generator=gen, dtype=torch.float64)
    check_bands(lambda t: upsample_conv_stacked(t, k, (out_h, 9)), x, out_h,
                widen=lambda reads, stop: with_zero_tap(reads, in_h, out_h,
                                                        stop, reach=2))


@pytest.mark.parametrize("in_h,out_h", UPSAMPLES)
def test_upsample_conv_band_matches_sliced(in_h, out_h):
    """The kernel's route, through the window op (its plain version here):
    the rows it reads are those the einsum route's outputs depend on and
    the zero-weight row the kernel loads."""
    gen = torch.Generator().manual_seed(in_h)
    x = torch.randn(1, in_h, 5, 3, generator=gen)
    k = torch.randn(5, 5, 3, 4, generator=gen)
    want = upsample_conv(x, k, (out_h, 9))
    for world in WORLDS:
        for rank in range(world):
            got, fetched = on_band(lambda t: upsample_conv(t, k, (out_h, 9)),
                                   x, world, rank)
            start, stop = spatial.owned_rows(out_h, world, rank)
            torch.testing.assert_close(got, want[:, start:stop], rtol=1e-5,
                                       atol=1e-5)
            if stop > start and world in READ_WORLDS:
                assert fetched[0][4:] == with_zero_tap(read_rows(
                    lambda t: upsample_conv_stacked(t, k.double(),
                                                    (out_h, 9)),
                    x.double(), start, stop), in_h, out_h, stop, reach=2)


@pytest.mark.parametrize("in_h,out_h", UPSAMPLES)
def test_window_rows_hold_both_source_rows_of_every_upsampled_row(in_h,
                                                                    out_h):
    """Each upsampled row interpolates between its source row and the one
    below it (clamped to the image), and the kernel loads both, also at a
    weight of 0 (a step of 0.5 puts every other row on a source row). A
    window's source rows hold both for every upsampled row in its reach,
    so the kernel never reads past the slice it is given: ENB0's 15 → 29
    on 2 ranks reads rows [0, 10) on rank 0, where the weights alone need
    [0, 9)."""
    step = (in_h - 1) / (out_h - 1)
    for world in WORLDS:
        for rank in range(world):
            start, stop = spatial.owned_rows(out_h, world, rank)
            if stop == start:
                continue
            lo, hi = spatial.upsample_conv_rows(start, stop, in_h, out_h)
            for row in range(max(start - 2, 0), min(stop + 2, out_h)):
                first = int(np.floor(row * step))
                assert lo <= first and min(first + 1, in_h - 1) < hi
    assert spatial.upsample_conv_rows(0, 15, 15, 29) == (0, 10)


@pytest.mark.parametrize("k,stride,pads", [(3, 1, (1, 1)), (3, 2, (0, 1)),
                                           (5, 1, (2, 2)), (5, 2, (1, 2))])
def test_depthwise_band_matches_sliced(k, stride, pads):
    """The depthwise kernel's wrapper on a band (its plain version here):
    the band's rows of y, and of the sums the band's own part, which the
    serving path all-reduces."""
    gen = torch.Generator().manual_seed(k + stride)
    x = torch.randn(2, 19, 7, 4, generator=gen)
    taps = torch.randn(k, k, 4, generator=gen)
    scale, bias = torch.rand(4, generator=gen) + 0.5, torch.randn(
        4, generator=gen)
    padding = (pads, (k // 2, k // 2))
    want, _ = depthwise_bn_swish(x, taps, scale, bias, stride, padding)
    for world in WORLDS:
        for rank in range(world):
            (y, sums), fetched = on_band(lambda t: depthwise_bn_swish(
                t, taps, scale, bias, stride, padding), x, world, rank)
            start, stop = spatial.owned_rows(want.shape[1], world, rank)
            torch.testing.assert_close(y, want[:, start:stop])
            torch.testing.assert_close(sums, y.sum(dim=(1, 2)))
            if stop > start and world in READ_WORLDS:
                assert fetched[0][4:] == read_rows(
                    lambda t: F.conv2d(
                        F.pad(t, (0, 0, *padding[1], *pads)).permute(
                            0, 3, 1, 2),
                        taps.double().permute(2, 0, 1)[:, None], stride=stride,
                        groups=4).permute(0, 2, 3, 1),
                    x.double(), start, stop)


# ------------------------------------------------------------------ window


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_h,out_h,row0,rows", [
    (8, 15, 0, 15), (8, 15, 0, 4), (8, 15, 6, 5), (8, 15, 13, 2),
    (15, 29, 14, 1), (57, 114, 29, 29), (57, 114, 100, 14)])
def test_window_plain_matches_whole_sliced(dtype, in_h, out_h, row0, rows):
    """``upsample_conv_window`` from the source rows the window reads equals
    the whole-image op at the window's rows; f32 to rounding, bf16 to a
    step of its rounding of the upsampled rows."""
    gen = torch.Generator().manual_seed(row0)
    x = torch.randn(2, in_h, 6, 8, generator=gen).to(dtype)
    k = (torch.randn(5, 5, 8, 6, generator=gen) / 10).to(dtype)
    lo, hi = spatial.upsample_conv_rows(row0, row0 + rows, in_h, out_h)
    got = upsample_conv_window(x[:, lo:hi].contiguous(), k, (out_h, 11),
                               (lo, in_h, row0, rows))
    want = upsample_conv(x, k, (out_h, 11))[:, row0:row0 + rows]
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_window_checks_its_rows_and_has_no_gradient():
    x = torch.randn(1, 8, 6, 4, requires_grad=True)
    k = torch.randn(5, 5, 4, 2)
    lo, hi = spatial.upsample_conv_rows(3, 7, 8, 15)
    with pytest.raises(ValueError, match="read source rows"):
        upsample_conv_window(x[:, lo + 1:hi], k, (15, 11), (lo + 1, 8, 3, 4))
    y = upsample_conv_window(x[:, lo:hi], k, (15, 11), (lo, 8, 3, 4))
    assert y.shape == (1, 4, 11, 2)
    with pytest.raises(NotImplementedError, match="eval only"):
        y.sum().backward()
    torch.library.opcheck(torch.ops.ede.upsample_conv_window,
                          (x.detach()[:, lo:hi].contiguous(), k, [15, 11],
                           [lo, 8, 3, 4]))


# --------------------------------------------------------- across processes


def launch(out_dir, scenario: str, *args, world: int) -> None:
    """Run ``scenario`` of the runner on ``world`` gloo ranks; fail with each
    rank's log tail unless every rank exits 0 before the deadline."""
    os.makedirs(out_dir, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=os.pathsep.join([ROOT, TESTS]), OMP_NUM_THREADS="1",
               EDE_NUM_PROCESSES=str(world),
               EDE_COORDINATOR_ADDRESS=f"file://{out_dir}/store",
               EDE_DIST_TIMEOUT=str(COLLECTIVE_TIMEOUT_S))
    logs = [open(os.path.join(out_dir, f"log{r}.txt"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, RUNNER, scenario, str(out_dir), *map(str, args)],
        env={**env, "EDE_PROCESS_ID": str(r)}, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.returncode for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=30)
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        with open(os.path.join(out_dir, f"log{r}.txt")) as f:
            tail = f.read()[-4000:]
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{tail}"


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    """Every rank's results of the runner's ``serve`` on 8 ranks."""
    out = tmp_path_factory.mktemp("spatial")
    launch(out, "serve", world=8)
    with removed_after(out):
        yield [torch.load(out / f"rank{r}.pt", weights_only=False)
               for r in range(8)]


@pytest.fixture(scope="module")
def outputs(eight_ranks) -> dict:
    """Every mesh's gathered outputs of the runner, by case."""
    return {k: v for r in eight_ranks for k, v in r.items()
            if k not in ("band_rows", "fetched", "collectives")}


@functools.lru_cache(maxsize=None)
def one_process_hu() -> np.ndarray:
    """ENB0-HU served by the port in one process."""
    fn = make_infer_fn(cases.model("enb0_hu"), upsample_to=cases.HU_UPSAMPLE,
                       device="cpu")
    return fn(cases.hu_input()).numpy()


@pytest.mark.parametrize("world", [2, 3, 8])
def test_enb0_hu_spatial_matches_one_process(outputs, world):
    got = outputs[f"enb0_hu/{world}"]
    want = one_process_hu()
    assert got.shape == want.shape == (1, *cases.HU_UPSAMPLE, 1)
    np.testing.assert_allclose(got, want, **SERVE_TOL)


def test_enb0_hu_spatial_matches_jax_spatial(outputs):
    """JAX's own spatial mode, GSPMD over its 8 CPU devices, from the same
    ``.ede`` and input, against the port's 8 ranks."""
    model, variables = jax_load_any_checkpoint(cases.EDE["enb0_hu"])
    fn = jax_make_infer_fn(model, variables, upsample_to=cases.HU_UPSAMPLE,
                           mesh=jax_create_mesh(), spatial=True)
    want = np.asarray(fn(jnp.asarray(cases.hu_input().numpy())))
    np.testing.assert_allclose(outputs["enb0_hu/8"], want, **SERVE_TOL)


@pytest.mark.parametrize("case", cases.CASES)
def test_families_and_options_on_three_ranks(outputs, case):
    """Each family at 64×96 (ranks without rows at the deepest levels),
    and the serving options, against the same fn in one process."""
    fn, inputs, height = cases.serving_fn(case)
    with runner_threads(case):
        want = fn(inputs).numpy()
    got = outputs[case]
    assert got.shape == want.shape and want.shape[1] == height
    tol = BF16_TOL if case.endswith("bf16") else SERVE_TOL
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("case", [c for c in cases.CASES if "int8" in c])
def test_int8_scales_are_the_whole_inputs(outputs, case, monkeypatch):
    """Every quantized conv on the ranks, a 1×1 one too, all-reduced its
    band's maximum of |x| and took the whole input's: the maxima the ranks
    used are, call for call, those of the convs of one process."""
    from efficientdepthestimation_tpu_torch.ops import quant

    want = []
    quantize = quant.quant_conv2d

    def recording(x, weight, **kw):
        assert kw.get("amax") is None
        want.append(float(x.float().abs().amax()))
        return quantize(x, weight, **kw)

    monkeypatch.setattr(quant, "quant_conv2d", recording)
    fn, inputs, _ = cases.serving_fn(case)
    with runner_threads(case):
        fn(inputs)
    assert want
    np.testing.assert_allclose(outputs[f"{case}/amax"], want, rtol=1e-5)


def test_each_rank_reads_only_its_rows_and_halo(eight_ranks):
    """On 8 ranks, at every row-dependent op of ENB0-HU, a rank computed
    only its own block of output rows and read only the input rows near
    them (its block's span in the input, widened by at most 4 rows of
    halo), never a whole activation; the last rank owns no rows at the
    8-row level, and every rank issued the same collectives."""
    counts = {(r["collectives"], len(r["fetched"])) for r in eight_ranks}
    assert len(counts) == 1
    empty = 0
    for rank, result in enumerate(eight_ranks):
        assert result["band_rows"] == 60  # 480 rows over 8
        for in_h, out_h, start, stop, lo, hi in result["fetched"]:
            assert (start, stop) == spatial.owned_rows(out_h, 8, rank)
            if stop == start:
                empty += 1
                assert hi == lo
                continue
            scale = in_h / out_h
            assert lo >= int(start * scale) - 4
            assert hi <= int(np.ceil(stop * scale)) + 4
            assert hi - lo < in_h or in_h <= 8
    assert empty > 0


def test_inference_benchmark_spatial_on_two_ranks(tmp_path):
    """``inference_benchmark --spatial --device cpu`` on 2 gloo ranks: every
    rank serves every frame row-sharded, and rank 0 writes the summary."""
    from PIL import Image

    ckpt_dir, frames = tmp_path / "checkpoints", tmp_path / "frames"
    ckpt_dir.mkdir()
    frames.mkdir()
    save_checkpoint(str(ckpt_dir / "RN18-HU.ede"), cases.model("rn18_hu"),
                    encoder="resnet18", decoder="hu2018")
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
                        ).save(frames / f"{i:03d}.png")
    launch(tmp_path / "run", "cli", ckpt_dir, frames, world=2)
    lines = (tmp_path / "run" / "cli" / "inference_benchmark.csv"
             ).read_text().splitlines()
    assert len(lines) == 2 and lines[1].startswith("RN18-HU,")
    for r in range(2):
        assert "RN18-HU.ede" in (tmp_path / "run" / f"log{r}.txt").read_text()


# ---------------------------------------------------------------------- C8


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(2, 96, 128, 3), (2, 200, 300, 3)])
def test_eval_preprocess_matches_jax_where_scale_is_not_two(shape, seed):
    """uint8 frames whose Scale-240 factor is not 2 resample to values on
    or within f32 error of a rounding tie, which ``quantize_uint8`` sends
    to the side the sum's rounding gives them. The port rounds each pass
    as the JAX package's f32 dot does on the CPU (``ops.resize.
    _pil_tap_sum``), so the uint8 levels are JAX's. PIL itself resamples
    uint8 in fixed point and rounds between its passes: JAX departs from
    PIL by one level at about a fifth of these values, and the port
    follows JAX. The fused-or-not rule was read off one XLA CPU version
    (``XLA_CPU_RULE_FITTED_ON``), which a failure names beside this
    one's."""
    frames = np.random.default_rng(seed).integers(0, 256, shape,
                                                  dtype=np.uint8)
    want = np.asarray(jax_eval_preprocess(jnp.asarray(frames), (64, 96)))
    got = eval_preprocess_image_only(torch.from_numpy(frames), (64, 96))
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0, atol=PREPROCESS_ATOL,
        err_msg=f"ops.resize's XLA CPU rule was fitted on "
                f"{XLA_CPU_RULE_FITTED_ON}; this is jax {jax.__version__}, "
                f"jaxlib {jaxlib.__version__}")
