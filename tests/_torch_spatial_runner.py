"""One rank of the port's spatial-serving tests (gloo on the CPU).

Usage: python _torch_spatial_runner.py SCENARIO OUT_DIR [ARGS...]

The launcher sets ``EDE_COORDINATOR_ADDRESS`` (a ``file://`` store),
``EDE_NUM_PROCESSES``, ``EDE_PROCESS_ID`` and ``EDE_DIST_TIMEOUT``, so that
``maybe_initialize_distributed`` joins the group. Scenarios:

* ``serve``: on 8 ranks, at once, ENB0-HU from its ``.ede`` at batch 1,
  228×304, upsampled to 480×640, on a mesh of ranks 0-1 and on one of
  ranks 2-4, and the families and serving options of ``spatial_cases``
  at 64×96 on 3 ranks, half on ranks 2-4 after ENB0-HU and half on ranks
  5-7; then ENB0-HU on all 8. Each mesh's first rank writes its gathered
  outputs (of an int8 case also the activation maxima its quantized convs
  all-reduced, under ``CASE/amax``), and every rank its 8-rank band's
  shape, the rows it fetched and its collectives, to
  ``OUT_DIR/rank{r}.pt``;
* ``cli CKPT_DIR FRAMES_DIR``: ``apps.inference_benchmark.main`` with
  ``--spatial --device cpu``, its summary into ``OUT_DIR/cli``.
"""

import contextlib
import os
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from efficientdepthestimation_tpu_torch.apps import common  # noqa: E402
from efficientdepthestimation_tpu_torch.parallel import (  # noqa: E402
    create_mesh,
    gather_rows,
    maybe_initialize_distributed,
)
from efficientdepthestimation_tpu_torch.parallel.mesh import Mesh  # noqa
from efficientdepthestimation_tpu_torch.parallel.spatial import (  # noqa
    RowSharded,
)

import spatial_cases as cases  # noqa: E402

scenario, out_dir = sys.argv[1], sys.argv[2]
rank = int(os.environ["EDE_PROCESS_ID"])
assert maybe_initialize_distributed(device="cpu")

if scenario == "cli":
    from efficientdepthestimation_tpu_torch.apps import inference_benchmark

    ckpt_dir, frames_dir = sys.argv[3], sys.argv[4]
    inference_benchmark.main(["-c", ckpt_dir, "-f", frames_dir, "-n", "1",
                              "-b", "2", "-o", os.path.join(out_dir, "cli"),
                              "--spatial", "--device", "cpu"])
    sys.exit(0)

assert scenario == "serve"
world = create_mesh(device="cpu", backend="gloo")


def submesh(ranks: list[int]):
    """A mesh of ``ranks`` (every rank takes part in making it), None on
    the others."""
    group = dist.new_group(ranks)
    if rank not in ranks:
        return None
    k, r = len(ranks), ranks.index(rank)
    return Mesh(group=group, world_size=k, rank=r,
                shape={"data": k, "model": 1}, data_index=r,
                device=torch.device("cpu"), host_group=group)


# three disjoint meshes at once, then all 8 ranks
two, three, other = submesh([0, 1]), submesh([2, 3, 4]), submesh([5, 6, 7])
contexts = []
row_sharded = common.row_sharded


@contextlib.contextmanager
def recording(mesh):
    with row_sharded(mesh) as ctx:
        contexts.append(ctx)
        yield ctx


common.row_sharded = recording
maxima = []
all_reduced_max = RowSharded.max


def recording_max(self, t):
    out = all_reduced_max(self, t)
    maxima.append(float(out))
    return out


RowSharded.max = recording_max
out = {}
hu = cases.model("enb0_hu")


def serve_hu(mesh) -> torch.Tensor:
    """ENB0-HU served over ``mesh``: this rank's band; the gathered depth
    kept on the mesh's rank 0."""
    contexts.clear()
    band = common.make_infer_fn(hu, upsample_to=cases.HU_UPSAMPLE,
                                device="cpu", mesh=mesh,
                                spatial=True)(cases.hu_input())
    whole = gather_rows(band, cases.HU_UPSAMPLE[0], mesh)
    if mesh.rank == 0:
        out[f"enb0_hu/{mesh.world_size}"] = whole
    return band


if two is not None:
    serve_hu(two)
if three is not None:
    serve_hu(three)
# the cases, half on ranks 2-4 after ENB0-HU, half on ranks 5-7
families = three or other
if families is not None:
    for case in cases.CASES[0 if three else 1::2]:
        maxima.clear()
        infer, inputs, height = cases.serving_fn(case, mesh=families)
        whole = gather_rows(infer(inputs), height, families)
        if families.rank == 0:
            out[case] = whole
            if "int8" in case:
                out[f"{case}/amax"] = list(maxima)
band = serve_hu(world)
out["band_rows"] = band.shape[1]
out["fetched"] = list(contexts[-1].fetched)
out["collectives"] = contexts[-1].collectives
torch.save({k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()},
           os.path.join(out_dir, f"rank{rank}.pt"))
dist.barrier()
