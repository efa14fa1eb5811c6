"""One rank of the port's multi-process tests (gloo on the CPU).

Usage: python _torch_multiprocess_runner.py SCENARIO OUT_DIR [ARGS...]

The launcher sets ``EDE_COORDINATOR_ADDRESS`` (a ``file://`` store),
``EDE_NUM_PROCESSES``, ``EDE_PROCESS_ID`` and ``EDE_DIST_TIMEOUT``, as the
JAX package's runner does, so that the port's
``maybe_initialize_distributed`` joins the group. Scenarios:

* ``cases INIT_PATH``: every case of ``torch_parallel_cases`` on this
  rank, its results to ``OUT_DIR/rank{r}.pt``, the ZeRO-1 and unsharded
  train states to ``OUT_DIR/zero1.ede`` and ``OUT_DIR/plain.ede``;
* ``cli WORKDIR ARGS...``: ``apps.train.main(ARGS)`` run from ``WORKDIR``;
  rank 0 writes the path it returns to ``OUT_DIR/cli.txt``. With
  ``EDE_TEST_SIGTERM=RANK:N`` in the environment, rank RANK sends itself a
  SIGTERM after its N-th training step (one rank preempted).
"""

import os
import signal
import sys

import torch
import torch.distributed as dist

# One thread a rank: with two, a rank's CPU convolutions round differently
# from run to run (by up to 1e-4 of a gradient under accumulation and
# remat), which would hide whether ZeRO-1 equals the unsharded optimizer.
torch.set_num_threads(1)

scenario, out_dir = sys.argv[1], sys.argv[2]
rank = int(os.environ["EDE_PROCESS_ID"])

if scenario == "cli":
    from efficientdepthestimation_tpu_torch.apps import train

    workdir, argv = sys.argv[3], sys.argv[4:]
    target = os.environ.get("EDE_TEST_SIGTERM")
    if target and int(target.split(":")[0]) == rank:
        after = int(target.split(":")[1])
        make = train.make_train_step

        def make_signalling(*args, **kwargs):
            step, calls = make(*args, **kwargs), [0]

            def signalling(*step_args, **step_kwargs):
                out = step(*step_args, **step_kwargs)
                calls[0] += 1
                if calls[0] == after:
                    os.kill(os.getpid(), signal.SIGTERM)
                return out

            return signalling

        train.make_train_step = make_signalling
    os.chdir(workdir)
    path = train.main(argv)
    if rank == 0:
        with open(os.path.join(out_dir, "cli.txt"), "w") as f:
            f.write(os.path.abspath(path))
elif scenario == "cases":
    import torch_parallel_cases as cases

    from efficientdepthestimation_tpu_torch.parallel import (
        create_mesh,
        maybe_initialize_distributed,
    )

    init_path = sys.argv[3]
    assert maybe_initialize_distributed(device="cpu")
    mesh = create_mesh(device="cpu", backend="gloo")
    assert mesh.distributed and mesh.rank == rank
    out = {
        "resnet18": cases.resnet18_trajectory(mesh, init_path),
        "enb0": cases.enb0_steps(mesh),
        # the unsharded run, whose moments the ZeRO-1 run's must equal
        "enb0_accum_remat": cases.enb0_steps(
            mesh, accum_steps=2, remat="full",
            save=os.path.join(out_dir, "plain.ede")),
        "enb0_zero1": cases.enb0_steps(
            mesh, accum_steps=2, remat="full", zero1=True,
            save=os.path.join(out_dir, "zero1.ede")),
    }
    # What the tests read, kept small: every case's digest (both ranks
    # hold one replica), ZeRO-1 against the unsharded run here, the full
    # tensors of rank 0 only where one process's are compared with them.
    zero, plain = out["enb0_zero1"], out["enb0_accum_remat"]
    result = {
        "digests": {k: cases.digest(v["state"]) for k, v in out.items()},
        "zero1_count": (zero["count"], plain["count"]),
        "zero1_moments_equal": zero["moments"].keys() == plain[
            "moments"].keys() and all(
                torch.equal(a, b) for k, pair in plain["moments"].items()
                for a, b in zip(zero["moments"][k], pair)),
        "zero1_state_equal": cases.digest(zero["state"]) == cases.digest(
            plain["state"]),
        "eval": cases.eval_epoch(mesh, init_path),
        "serve": cases.serve(mesh, init_path),
    }
    if rank == 0:
        result["resnet18"] = {k: v for k, v in out["resnet18"].items()
                              if k != "state"}
        for case in ("enb0", "enb0_accum_remat"):
            result[case] = {k: out[case][k]
                            for k in ("metrics", "grads", "state")}
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
else:
    raise SystemExit(f"unknown scenario {scenario!r}")

if dist.is_initialized():
    dist.destroy_process_group()
