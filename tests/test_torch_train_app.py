"""The port's training CLI on the CPU, on the synthetic split of
``tests/test_train_app.py``: one epoch and its run directory, the best
checkpoint loaded by the JAX package, ``--stop-after-steps`` then
``--resume`` bit for bit against an uninterrupted run (as
``tests/test_preemption.py``), the SIGTERM flag and the step boundary it
stops at, ``--init-from`` with ``--freeze-encoder``, and the flags that
raise."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from efficientdepthestimation_tpu.apps.common import (
    load_any_checkpoint as jax_load_any_checkpoint,
)
from efficientdepthestimation_tpu.checkpoints.serialization import (
    load_midas as jax_load_midas,
)

from efficientdepthestimation_tpu_torch.apps import train
from efficientdepthestimation_tpu_torch.apps.common import load_any_checkpoint
from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
    read_ede,
    save_checkpoint,
)
from efficientdepthestimation_tpu_torch.data.synthetic_nyu import (
    synthetic_train_set,
)
from efficientdepthestimation_tpu_torch.models.common import randomize_
from efficientdepthestimation_tpu_torch.models.registry import build_model
from efficientdepthestimation_tpu_torch.training import train_step as pstep

from test_train_app import synthetic_nyu  # noqa: F401  (8 train, 2 test)


@pytest.fixture(autouse=True)
def _run_dir(tmp_path, monkeypatch):
    """Each CLI run writes ``runs/`` under a temporary directory, with two
    PyTorch threads (the suite runs several workers on a few cores)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("WANDB_MODE", "disabled")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _args(data, *extra, encoder="resnet18", decoder="hu2018", batch=2):
    return ["--encoder", encoder, "--decoder", decoder,
            "--train-csv", data["train_csv"], "--test-csv", data["test_csv"],
            "--per-device-batch", str(batch), "--crop-hw", "64", "96",
            "--device", "cpu", *extra]


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}"
        if isinstance(value, dict):
            out.update(_flat(value, name))
        else:
            out[name] = np.asarray(value)
    return out


@pytest.mark.parametrize("extra", [
    [], ["--accum-steps", "2", "--remat", "full", "--split-preprocess"]])
def test_train_cli_one_epoch(synthetic_nyu, extra):  # noqa: F811
    ckpt = train.main(_args(synthetic_nyu, "--epochs", "1", *extra))
    assert os.path.isfile(ckpt)
    run_dir = os.path.dirname(ckpt)
    assert os.path.relpath(run_dir).startswith("runs")
    with open(os.path.join(run_dir, "log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 1
    record = records[0]
    assert np.isfinite(record["abs_rel"]) and np.isfinite(record["loss"])
    assert record["vram_source"] == "static" and record["vram_usage"] > 0
    for key in ("training_frame_time", "test_frame_time", "inference_time"):
        assert record[key] > 0, key
    media = os.path.join(run_dir, "media", "examples")
    assert os.path.isdir(media) and len(os.listdir(media)) == 2
    with open(os.path.join(run_dir, "histograms.jsonl")) as f:
        params, grads = (json.loads(line) for line in f)
    assert "parameters/E/conv1/kernel" in params
    assert "gradients/R/conv2/kernel" in grads
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    assert summary["num_parameters"] > 0 and "delta1" in summary
    header, _ = read_ede(os.path.join(run_dir, "train_state.ede"))
    assert (header["epoch"], header["step"]) == (0, 4)
    assert "step_in_epoch" not in header

    model, variables = jax_load_any_checkpoint(ckpt)
    assert "params" in variables
    ours = load_any_checkpoint(ckpt, device="cpu")
    assert sum(p.numel() for p in ours.parameters()) == \
        summary["num_parameters"]


def test_train_cli_midas_checkpoint_loads_in_jax(synthetic_nyu):  # noqa: F811
    ckpt = train.main(_args(synthetic_nyu, "--epochs", "1", "--watch-every",
                            "0", decoder="lasinger2019", batch=4))
    header, _ = read_ede(ckpt)
    assert header["format"] == "midas-self-describing"
    assert header["output_size"] == [48, 32]
    model, _ = jax_load_midas(ckpt)
    assert model.output_size == (32, 48)


def test_stop_then_resume_is_exact(synthetic_nyu):  # noqa: F811
    """2 epochs of 2 steps; stopped after global step 3 (epoch 1, one step
    in, with a --save-every save before it), then resumed: the final train
    state equals the uninterrupted run's bit for bit."""
    base = _args(synthetic_nyu, "--epochs", "2", "--watch-every", "0",
                 batch=4)
    ckpt_a = train.main(base)
    rolling = train.main(base + ["--stop-after-steps", "3",
                                 "--save-every", "2"])
    header, _ = read_ede(rolling)
    assert (header["step"], header["epoch"], header["step_in_epoch"]) == (
        3, 1, 1)
    ckpt_c = train.main(base + ["--resume", rolling])
    (ha, pa), (hc, pc) = (read_ede(os.path.join(os.path.dirname(c),
                                                "train_state.ede"))
                          for c in (ckpt_a, ckpt_c))
    assert ha["step"] == hc["step"] == 4
    assert "step_in_epoch" not in ha and "step_in_epoch" not in hc
    fa, fc = _flat(pa), _flat(pc)
    assert fa.keys() == fc.keys()
    assert any("/opt_state/1/0/mu/" in k for k in fa)
    for key in fa:
        np.testing.assert_array_equal(fa[key], fc[key], err_msg=key)


def test_sigterm_stops_at_the_next_step_boundary():
    """SIGTERM sets the flag; the epoch then saves and stops after the step
    in flight."""
    train._install_preemption_handler()
    try:
        assert not train._PREEMPTED.is_set()
        os.kill(os.getpid(), signal.SIGTERM)
        assert train._PREEMPTED.wait(5), "handler did not set the flag"
        state = pstep.create_train_state(build_model("resnet18"), 1e-4)
        step = pstep.make_train_step(crop_hw=(64, 96), device="cpu")
        saved = []
        state, _, stopped = train.run_train_epoch(
            state, step, synthetic_train_set((0, 1, 2, 3)), 2, seed=0,
            epoch=0, checkpoint_cb=lambda s, e, k: saved.append((e, k)),
            device="cpu")
        assert stopped and state.step == 1 and saved == [(0, 1)]
    finally:
        train._PREEMPTED.clear()
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


def test_init_from_with_frozen_encoder(synthetic_nyu, tmp_path):  # noqa: F811
    init = randomize_(build_model("resnet18"), 9)
    path = str(tmp_path / "RN18-HU.ede")
    save_checkpoint(path, init, encoder="resnet18", decoder="hu2018")
    ckpt = train.main(_args(synthetic_nyu, "--epochs", "1", "--watch-every",
                            "0", "--init-from", path, "--freeze-encoder"))
    tuned = dict(load_any_checkpoint(ckpt, device="cpu").named_parameters())
    moved = set()
    for name, p in init.named_parameters():
        if name.startswith("E."):
            assert torch.equal(tuned[name], p), name
        elif not torch.equal(tuned[name], p):
            moved.add(name.split(".")[0])
    assert moved == {"D", "MFF", "R"}


def test_flags_that_raise(synthetic_nyu, tmp_path):  # noqa: F811
    with pytest.raises(SystemExit):
        train.main(_args(synthetic_nyu, "--init-from", "a.ede",
                         "--resume", "b.ede"))
    with pytest.raises(ValueError, match="accum_steps must be >= 1"):
        train.main(_args(synthetic_nyu, "--accum-steps", "0"))
