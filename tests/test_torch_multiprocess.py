"""The port's data parallelism across real processes: two ranks of a gloo
process group on the CPU (``_torch_multiprocess_runner.py``, launched with
the JAX package's ``EDE_*`` variables and a ``file://`` store under the
test's directory), held against one process on the whole batch and against
the JAX package's own 4-device mesh trajectory
(``multihost_common.run_steps``), as ``tests/test_multihost.py`` and
``tests/test_multidevice_equivalence.py`` hold the JAX package.

Every launch has a deadline: a rank that fails ends the others at once,
and the process group's collectives time out after ``EDE_DIST_TIMEOUT``
seconds, so that a hang fails the test instead of holding the suite."""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientdepthestimation_tpu.checkpoints import (
    serialization as jserialization,
)
from efficientdepthestimation_tpu.models import build_model as jax_build_model
from efficientdepthestimation_tpu.training import train_step as jstep

from efficientdepthestimation_tpu_torch.apps import train
from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    from_jax_variables,
    to_jax_variables,
)
from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
    load_checkpoint,
    load_train_state,
    read_ede,
    save_checkpoint,
)
from efficientdepthestimation_tpu_torch.models.registry import build_model
from efficientdepthestimation_tpu_torch.parallel import create_mesh
from efficientdepthestimation_tpu_torch.training.train_step import (
    create_train_state,
    make_train_step,
)

import torch_parallel_cases as cases
from multihost_common import run_steps
from test_train_app import synthetic_nyu  # noqa: F401  (8 train, 2 test)

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
RUNNER = os.path.join(TESTS, "_torch_multiprocess_runner.py")
LAUNCH_TIMEOUT_S = 300
COLLECTIVE_TIMEOUT_S = 120
LR = 1e-3  # the ENB0-HU cases' learning rate


def launch(out_dir, scenario: str, *args, world: int = 2,
           extra_env: dict | None = None) -> None:
    """Run ``scenario`` of the runner on ``world`` ranks; fail with each
    rank's log tail unless every rank exits 0 before the deadline."""
    os.makedirs(out_dir, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=os.pathsep.join([ROOT, TESTS]), OMP_NUM_THREADS="1",
               WANDB_MODE="disabled", EDE_NUM_PROCESSES=str(world),
               EDE_COORDINATOR_ADDRESS=f"file://{out_dir}/store",
               EDE_DIST_TIMEOUT=str(COLLECTIVE_TIMEOUT_S), **(extra_env or {}))
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
def init_checkpoint(tmp_path_factory):
    """``run_steps``'s initial resnet18-HU weights (JAX's ``model.init``),
    carried to the port by ``checkpoints.convert``."""
    variables = jax_build_model("resnet18", "hu2018").init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, 32, 48, 3)))
    model = build_model("resnet18", "hu2018")
    model.load_state_dict(from_jax_variables(jax.device_get(variables)),
                          strict=True)
    path = str(tmp_path_factory.mktemp("init") / "resnet18-hu.ede")
    save_checkpoint(path, model, encoder="resnet18", decoder="hu2018")
    return path


@pytest.fixture(scope="module")
def two_ranks(init_checkpoint, tmp_path_factory):
    """Every case of ``torch_parallel_cases`` on two ranks: each rank's
    results, and the directory of the ZeRO-1 and unsharded train states."""
    out = tmp_path_factory.mktemp("two-ranks")
    launch(out, "cases", init_checkpoint)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(2)], out


@pytest.fixture(scope="module")
def one_process():
    """A mesh of one process: the whole batch, no collectives."""
    return create_mesh(device="cpu")


def _grad_rel(got: dict, ref: dict) -> float:
    """‖Δ‖/‖ref‖ over every gradient of the model."""
    num = sum(float((got[k] - g).double().square().sum())
              for k, g in ref.items())
    den = sum(float(g.double().square().sum()) for g in ref.values())
    return (num / den) ** 0.5


def _check_step(got: dict, ref: dict, grad_tol: float) -> None:
    """A data-parallel ENB0-HU step against the one-process step: metrics
    and the loss to rtol 1e-5, the gradient's norm-relative difference to
    ``grad_tol``, BN statistics to 1e-4, and each weight within Adam's
    largest update difference (2·lr) of the other, with few moved."""
    for key, value in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][key], value, rtol=1e-5,
                                   err_msg=key)
    assert _grad_rel(got["grads"], ref["grads"]) < grad_tol
    moved = total = 0
    for key, value in ref["state"].items():
        diff = (got["state"][key] - value).abs()
        if "running" in key:
            assert float((diff / value.abs().clamp(min=1e-3)).max()) < 1e-4
        else:
            assert float(diff.max()) <= 2 * LR * 1.001, key
            moved += int((diff > 1e-6).sum())
            total += diff.numel()
    assert moved / total < 1e-2


def test_ranks_stay_replicas(two_ranks):
    """After every case both ranks hold the same weights and statistics."""
    ranks, _ = two_ranks
    assert set(ranks[0]["digests"]) == {
        "resnet18", "enb0", "enb0_accum_remat", "enb0_zero1"}
    assert ranks[0]["digests"] == ranks[1]["digests"]


def test_resnet18_two_ranks_match_one_process(two_ranks, init_checkpoint,
                                              one_process):
    """Three steps of resnet18-HU at 32×48 over ``SynthDataset``, the last
    batch 2 valid of 4 (rank 1 all padding), against one process."""
    got = two_ranks[0][0]["resnet18"]
    ref = cases.resnet18_trajectory(one_process, init_checkpoint)
    assert got["final_step"] == ref["final_step"] == 3
    # the first step: the same weights and data (measured 7.8e-8)
    np.testing.assert_allclose(got["losses"][0], ref["losses"][0], rtol=1e-6)
    # later steps follow f32 rounding through two Adam updates: the port's
    # one-process trajectory alone moves its third loss by 1.8e-3 between
    # 1 and 8 threads (5.6081 to 5.6181), its 2-rank one by 4.3e-3 between
    # 1 and 4 threads a rank (5.5889 to 5.5646), which puts the two 7e-3
    # apart
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-2)
    np.testing.assert_allclose(got["final_abs_rel"], ref["final_abs_rel"],
                               rtol=2e-2)
    np.testing.assert_allclose(got["param_checksum"], ref["param_checksum"],
                               rtol=1e-3)


def test_resnet18_two_ranks_match_jax_mesh(two_ranks):
    """The same trajectory against JAX's on a 4-device mesh, from the same
    initial weights: ``tests/test_multihost.py``'s tolerances, loss[0]
    across frameworks, and the losses at 1e-2 for the reason above (JAX's
    own one-device and 4-device third losses differ by 9e-4)."""
    got = two_ranks[0][0]["resnet18"]
    ref = run_steps(global_batch_size=4, n_devices=4)
    assert got["final_step"] == ref["final_step"] == 3
    np.testing.assert_allclose(got["losses"][0], ref["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-2)
    np.testing.assert_allclose(got["final_abs_rel"], ref["final_abs_rel"],
                               rtol=2e-2)
    np.testing.assert_allclose(got["param_checksum"], ref["param_checksum"],
                               rtol=1e-3)


def test_enb0_two_ranks_match_one_process(two_ranks, one_process):
    """An ENB0-HU step with drop-connect on and the batch 3 valid of 4:
    the masks, augmentation and BN statistics of the global batch. The
    gradients differ by 2.2e-5 of their norm; the one-process step on 1
    and on 4 threads differs by 4.9e-5."""
    _check_step(two_ranks[0][0]["enb0"], cases.enb0_steps(one_process),
                grad_tol=1e-3)


def test_enb0_accum_remat_two_ranks_match_one_process(two_ranks,
                                                      one_process):
    """``accum_steps=2`` under remat ``full``: each rank holds its row of
    each microbatch. The gradients differ by 2.7e-4 of their norm; the
    one-process step on 1 and on 4 threads differs by 2.8e-3."""
    ref = cases.enb0_steps(one_process, accum_steps=2, remat="full")
    _check_step(two_ranks[0][0]["enb0_accum_remat"], ref, grad_tol=1e-2)


def test_zero1_equals_unsharded_bit_for_bit(two_ranks):
    """ZeRO-1's weights, and its moments gathered from their owners, are
    the unsharded optimizer's bit for bit on both ranks; so are the two
    files' optimizer states, and no moment is written as zeros."""
    ranks, out = two_ranks
    for rank in ranks:
        assert rank["zero1_count"] == (1, 1)
        assert rank["zero1_moments_equal"] and rank["zero1_state_equal"]
    zero_opt = read_ede(str(out / "zero1.ede"))[1]["opt_state"]
    plain_opt = read_ede(str(out / "plain.ede"))[1]["opt_state"]
    moments = 0
    for key in ("mu", "nu"):
        z = jax.tree_util.tree_leaves(zero_opt["1"]["0"][key])
        p = jax.tree_util.tree_leaves(plain_opt["1"]["0"][key])
        assert len(z) == len(p) == len(ranks[0]["enb0"]["grads"])
        for a, b in zip(z, p):
            np.testing.assert_array_equal(a, b)
            assert np.any(a != 0)  # every gradient is nonzero somewhere
            moments += 1
    assert moments == 2 * len(p)


def test_zero1_state_resumes_in_one_process_and_jax(two_ranks):
    """The 2-rank ZeRO-1 train state loads into a one-process port state
    with every moment the unsharded run's, takes the next step there
    exactly as the unsharded file does, and loads in the JAX package."""
    _, out = two_ranks
    states, moments = {}, {}
    for name in ("plain", "zero1"):
        model = load_checkpoint(cases.ENB0_CHECKPOINT)[0]
        state = create_train_state(model, LR, 1e-4)
        state, header = load_train_state(str(out / f"{name}.ede"), state)
        assert state.step == 1 and header["epoch"] == 0
        moments[name] = {k: (state.optimizer.state[p]["exp_avg"].clone(),
                             state.optimizer.state[p]["exp_avg_sq"].clone())
                         for k, p in model.named_parameters()}
        step = make_train_step(crop_hw=cases.ENB0_CROP, device="cpu")
        state, metrics = step(state, cases.enb0_batch(), 4)
        states[name] = {k: v.clone() for k, v in model.state_dict().items()}
    for key, (mu, nu) in moments["plain"].items():
        assert torch.equal(moments["zero1"][key][0], mu), key
        assert torch.equal(moments["zero1"][key][1], nu), key
    for key, value in states["plain"].items():
        assert torch.equal(states["zero1"][key], value), key

    jm = jax_build_model("efficientnet-b0", "hu2018")
    variables = to_jax_variables(
        load_checkpoint(cases.ENB0_CHECKPOINT)[0].state_dict())
    tx = jstep.adam_with_l2(LR, 1e-4)
    restored, _ = jserialization.load_train_state(
        str(out / "zero1.ede"), jstep.create_train_state(jm, variables, tx))
    assert int(restored.step) == 1
    mu = from_jax_variables({"params": restored.opt_state[1][0].mu})
    assert mu.keys() == moments["plain"].keys()
    for key, value in mu.items():
        assert torch.equal(value, moments["plain"][key][0]), key


def test_mesh_eval_epoch_matches_one_process(two_ranks, init_checkpoint,
                                             one_process):
    """``run_eval_epoch`` over 5 test pairs at batch 4 (the last batch 1
    valid: rank 1 all padding): every rank's tracker is the one-process
    one."""
    ref = cases.eval_epoch(one_process, init_checkpoint)
    for rank in two_ranks[0]:
        for key, value in ref.items():
            np.testing.assert_allclose(rank["eval"][key], value, rtol=1e-6,
                                       err_msg=key)


def test_mesh_serving_rows_match_whole_batch(two_ranks, init_checkpoint,
                                             one_process):
    """Data-parallel serving: each rank's output is its rows of the
    whole-batch output."""
    ref = cases.serve(one_process, init_checkpoint)
    rows = [rank["serve"] for rank in two_ranks[0]]
    assert [tuple(r.shape) for r in rows] == [(2, 480, 640, 1)] * 2
    np.testing.assert_allclose(torch.cat(rows).numpy(), ref.numpy(),
                               rtol=1e-6, atol=1e-6)


def _cli_args(data, *extra):
    return ["--encoder", "resnet18", "--decoder", "hu2018", "--epochs", "2",
            "--train-csv", data["train_csv"], "--test-csv", data["test_csv"],
            "--crop-hw", "64", "96", "--watch-every", "0", "--device", "cpu",
            *extra]


def _log(path: str) -> list[dict]:
    with open(os.path.join(os.path.dirname(path), "log.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _cli(out_dir, *argv, extra_env=None) -> str:
    workdir = os.path.join(out_dir, "work")
    os.makedirs(workdir, exist_ok=True)
    launch(out_dir, "cli", workdir, *argv, extra_env=extra_env)
    with open(os.path.join(out_dir, "cli.txt")) as f:
        return f.read()


def test_cli_zero1_stop_and_resume_match_one_process(synthetic_nyu,  # noqa: F811
                                                     tmp_path, monkeypatch):
    """Two epochs of 2 steps at global batch 4: one process at per-device
    batch 4, uninterrupted, against two processes at 2 with ``--zero1``,
    stopped after 3 steps (mid-epoch) and resumed from the rolling train
    state (also at two processes): per-epoch evaluation metrics and the
    first epoch's training loss within
    ``tests/test_multidevice_equivalence.py``'s tolerances, and the best
    checkpoints' parameters within 5e-3."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("WANDB_MODE", "disabled")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ckpt_a = train.main(_cli_args(synthetic_nyu, "--per-device-batch",
                                      "4"))
    finally:
        torch.set_num_threads(n)
    mesh_flags = ["--per-device-batch", "2", "--zero1"]
    rolling = _cli(tmp_path / "stop", *_cli_args(synthetic_nyu, *mesh_flags,
                                                 "--stop-after-steps", "3"))
    assert rolling.endswith("train_state.ede")
    header = read_ede(rolling)[0]
    assert (header["epoch"], header["step"], header["step_in_epoch"]) == (
        1, 3, 1)
    ckpt_b = _cli(tmp_path / "resume", *_cli_args(synthetic_nyu, *mesh_flags,
                                                  "--resume", rolling))
    log_a, log_b = _log(ckpt_a), _log(rolling) + _log(ckpt_b)
    assert len(log_a) == len(log_b) == 2
    for epoch, (ra, rb) in enumerate(zip(log_a, log_b)):
        # the resumed epoch's "loss" is the mean of the steps run after the
        # resume alone, so only epoch 0's compares
        for key in ("abs_rel", "delta1", "rmse", "mae") + (
                ("loss",) if epoch == 0 else ()):
            np.testing.assert_allclose(ra[key], rb[key], rtol=2e-3,
                                       atol=2e-3,
                                       err_msg=f"epoch {epoch} {key}")
    # the parameters, as the JAX test compares them: the BN statistics
    # follow f32 rounding further (one process on 1 and on 4 threads ends
    # this run 1.2e-2 apart in a running mean, 5.9e-4 in a weight)
    a, b = load_checkpoint(ckpt_a)[0], load_checkpoint(ckpt_b)[0]
    b_params = dict(b.named_parameters())
    worst = max(float((p - b_params[k]).abs().max())
                for k, p in a.named_parameters())
    assert worst < 5e-3


def test_sigterm_on_one_rank_stops_both_at_one_step(synthetic_nyu,  # noqa: F811
                                                    tmp_path):
    """A SIGTERM that reaches rank 1 alone, after its first step: the stop
    flag is reduced at the step boundary, so both ranks save and return
    there (rank 0 writes the train state of step 1), and neither is left
    waiting in a collective."""
    rolling = _cli(tmp_path, *_cli_args(synthetic_nyu, "--per-device-batch",
                                        "2"),
                   extra_env={"EDE_TEST_SIGTERM": "1:1"})
    assert rolling.endswith("train_state.ede")
    header = read_ede(rolling)[0]
    assert (header["epoch"], header["step"], header["step_in_epoch"]) == (
        0, 1, 1)
    for r in range(2):
        with open(tmp_path / f"log{r}.txt") as f:
            assert "Preempted at epoch 0" in f.read()
