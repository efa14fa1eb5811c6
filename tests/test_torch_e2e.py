"""The port's end-to-end rehearsal (``scripts/run_e2e_torch.py``) on the CPU,
at the smallest sizes that still cross every phase boundary: the dataset,
a real SIGTERM and ``--resume`` for each decoder, the frozen-encoder
fine-tune, the random entrant, ``evaluate`` at batch 1 and 4, ``test_nyu``,
``inference_benchmark``, the benchmark harness (1 sample, 2 views a
second) and the study materials, then the report.

One run serves the module. Its ``--out``, ``--work-dir`` and
``--data-dir`` are temporary: nothing under the repo's ``e2e/`` (the JAX
package's record) may change. The report's JAX columns are held against
``e2e/trajectory.json``, and the rehearsal's staged HU checkpoint, loaded
by the JAX package, against the port's forward of it.
"""

import hashlib
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientdepthestimation_tpu.apps.common import (
    load_any_checkpoint as jax_load_any_checkpoint,
)
from efficientdepthestimation_tpu.apps.common import (
    make_infer_fn as jax_make_infer_fn,
)

from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
    make_infer_fn,
)
from torch_tmp_cleanup import delete_tmp_path  # noqa: F401  (autouse)
from torch_tmp_cleanup import removed_after

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "run_e2e_torch.py")
E2E = os.path.join(REPO, "e2e")
TINY = ["--device", "cpu", "--n-train", "4", "--n-test", "2", "--hw", "120",
        "160", "--crop-hw", "64", "96", "--batch-size", "2", "--epochs", "3",
        "--preempt-after-epochs", "1", "--freeze-epochs", "1",
        "--bench-samples", "1", "--renderer-fps", "2", "--poll-seconds",
        "0.25"]
ENTRANTS = {"random", "reside_enb0_hu_trained", "midas_enb0_lr_trained",
            "reside_enb0_random", "flat"}
# Each of the script's processes computes on this many threads: the tier
# runs six test processes on the host's cores, which a process of the
# host's core count each would oversubscribe.
THREADS = "2"
# The JAX package and the port forward the same .ede at 64x96 in f32.
DEPTH_ATOL = 1e-3


def e2e_digest() -> dict[str, str]:
    out = {}
    for root, _, files in os.walk(E2E):
        for name in files:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, E2E)] = hashlib.sha1(
                    f.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """One run of the script (~400 MB of runs and checkpoints, deleted
    when the module's tests are done)."""
    with removed_after(tmp_path_factory.mktemp("e2e_torch")) as tmp:
        dirs = {k: tmp / k for k in ("out", "work", "data")}
        before = e2e_digest()
        proc = subprocess.run(
            [sys.executable, SCRIPT, *TINY, "--out", str(dirs["out"]),
             "--work-dir", str(dirs["work"]), "--data-dir",
             str(dirs["data"])],
            cwd=str(tmp), env=dict(os.environ, OMP_NUM_THREADS=THREADS),
            capture_output=True, text=True, timeout=900)
        yield proc, dirs, before


def test_rehearsal_crosses_every_phase(rehearsal):
    proc, dirs, _ = rehearsal
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    work = dirs["work"]
    for tag in ("hu", "lr"):
        assert "Preempted at epoch" in (work / f"train_{tag}_a.log"
                                        ).read_text()
        assert "Resumed from" in (work / f"train_{tag}_b.log").read_text()
    meta = json.loads((work / "train_meta.json").read_text())
    for tag in ("hu", "lr"):
        run_a, run_b = meta["run_dirs"][tag]
        assert (work / "runs" / run_a / "train_state.ede").is_file()
        assert any(p.suffix == ".ede" and p.name != "train_state.ede"
                   for p in (work / "runs" / run_b).iterdir())
    for name in ("ENB0-HU.ede", "ENB0-LR.ede"):
        load_any_checkpoint(str(work / "checkpoints" / name), device="cpu")
    rows = (work / "benchmark_out" / "nyu.csv").read_text().splitlines()
    table = {r.split(",")[0]: r.split(",")[1:] for r in rows[1:]}
    assert set(table) == ENTRANTS
    header = rows[0].split(",")[1:]
    for name, values in table.items():
        for key in ("mae", "abs_rel", "rmse", "ssim", "lpips"):
            assert np.isfinite(float(values[header.index(key)])), (name, key)
    assert (work / "study_material" / "video_urls.csv").is_file()
    timings = json.loads((dirs["out"] / "timings_torch.json").read_text())
    assert {"0_dataset", "1_hu_train_until_preempt", "2_hu_train_resumed",
            "1_lr_train_until_preempt", "2_lr_train_resumed",
            "2b_lr_freeze_finetune", "3_evaluate", "4_test_nyu",
            "5_inference_benchmark", "6_benchmark", "7_study_materials",
            "total"} <= set(timings)
    report = (dirs["out"] / "E2E_torch.md").read_text()
    for heading in ("## Epoch trajectories", "## Evaluation",
                    "## Inference benchmark", "## Full benchmark",
                    "## Phase wall times"):
        assert heading in report


def test_report_jax_columns_are_the_jax_record(rehearsal):
    """Each trajectory table's last four columns are ``e2e/trajectory.json``
    epoch by epoch, as the report prints them."""
    _, dirs, _ = rehearsal
    report = (dirs["out"] / "E2E_torch.md").read_text()
    with open(os.path.join(E2E, "trajectory.json")) as f:
        jax_trajs = json.load(f)
    sections = re.split(r"^### ", report, flags=re.M)[1:4]
    for key, section in zip(("hu", "lr", "lr_freeze"), sections):
        rows = [ln.split("|")[1:-1] for ln in section.splitlines()
                if re.match(r"\| \d+ \|", ln)]
        assert len(rows) == len(jax_trajs[key])
        for row, ref in zip(rows, jax_trajs[key]):
            assert [c.strip() for c in row[5:9]] == [
                f"{ref[k]:.4f}" for k in ("loss", "abs_rel", "delta1",
                                          "rmse")]


def test_staged_hu_checkpoint_in_jax(rehearsal):
    """The rehearsal's staged ENB0-HU ``.ede``, read by the JAX package, gives
    the port's depth at 64x96."""
    _, dirs, _ = rehearsal
    path = str(dirs["work"] / "checkpoints" / "ENB0-HU.ede")
    images = np.random.default_rng(0).standard_normal(
        (2, 64, 96, 3)).astype(np.float32)
    model, variables = jax_load_any_checkpoint(path)
    want = np.asarray(jax_make_infer_fn(model, variables)(
        jnp.asarray(images)))
    got = make_infer_fn(load_any_checkpoint(path, device="cpu"),
                        device="cpu")(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=DEPTH_ATOL)


def test_repo_e2e_record_unchanged(rehearsal):
    _, _, before = rehearsal
    assert e2e_digest() == before


def test_no_card_raises_before_phase_0(tmp_path):
    """Without a card and without ``--device cpu`` the script stops before
    it makes its first directory."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, SCRIPT, "--out", str(tmp_path / "out"),
         "--work-dir", str(tmp_path / "work"), "--data-dir",
         str(tmp_path / "data")], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not any(tmp_path.iterdir())
