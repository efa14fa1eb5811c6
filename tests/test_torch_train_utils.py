"""The port's ``RunLogger`` against the JAX package's, and its
``device_prefetch`` on the CPU (the card's copy streams are held in
``tests/test_torch_gpu.py``)."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from efficientdepthestimation_tpu.utils.run_logger import (
    RunLogger as JaxRunLogger,
)

from efficientdepthestimation_tpu_torch.data.prefetch import device_prefetch
from efficientdepthestimation_tpu_torch.utils.run_logger import RunLogger


def _read(run_dir: str, name: str) -> list[dict]:
    with open(os.path.join(run_dir, name)) as f:
        return [json.loads(line) for line in f]


def _drop_time(records):
    return [{k: v for k, v in r.items() if k != "_time"} for r in records]


def test_run_logger_writes_what_the_jax_logger_writes(tmp_path,
                                                      monkeypatch):
    """The same calls give the same files: config, log records (an array
    value skipped), histograms of a nested dict of tensors and arrays
    (names joined with '/', non-finite values dropped), example PNGs and
    the summary."""
    monkeypatch.setenv("WANDB_MODE", "disabled")
    rng = np.random.default_rng(0)
    tree = {"E": {"conv": {"kernel": rng.standard_normal((3, 3, 2, 4))}},
            "R": {"bias": np.array([1.0, np.nan, 2.0, np.inf])}}
    images = rng.uniform(0, 1, (2, 6, 8, 1))
    config = {"network": {"encoder": {"name": "resnet18"}}}
    dirs = []
    for cls, to_leaf in ((JaxRunLogger, np.asarray),
                         (RunLogger, torch.tensor)):
        logger = cls(project="p", config=config,
                     run_dir=str(tmp_path / cls.__module__.split(".")[0]),
                     name_prefix="resnet18-hu2018")
        logger.set_summary("num_parameters", 42)
        logger.log({"abs_rel": np.float32(0.5), "vram_source": "static",
                    "images": images}, step=0)
        logger.log_histograms(
            {"E": {"conv": {"kernel": to_leaf(tree["E"]["conv"]["kernel"])}},
             "R": {"bias": to_leaf(tree["R"]["bias"])}}, step=0,
            prefix="gradients", bins=8)
        logger.log_images("examples", images, step=3)
        logger.finish()
        assert logger.name.startswith("resnet18-hu2018-")
        dirs.append(logger.dir)
    ref, ours = dirs
    for name in ("log.jsonl", "histograms.jsonl"):
        assert _drop_time(_read(ours, name)) == _drop_time(_read(ref, name))
    hist = _read(ours, "histograms.jsonl")[0]
    assert sum(hist["gradients/R/bias"]["counts"]) == 2
    for name in ("config.json", "summary.json"):
        with open(os.path.join(ours, name)) as a, \
                open(os.path.join(ref, name)) as b:
            assert json.load(a) == json.load(b)
    assert sorted(os.listdir(os.path.join(ours, "media", "examples"))) == \
        sorted(os.listdir(os.path.join(ref, "media", "examples"))) == \
        ["step0003_00.png", "step0003_01.png"]


def test_run_logger_takes_wandb_unless_disabled(tmp_path, monkeypatch):
    """wandb when it imports and starts; local files with
    ``WANDB_MODE=disabled`` (wandb is never started then) or when its
    start fails."""
    started = []

    def init(**kwargs):
        started.append(kwargs)
        raise RuntimeError("no network")

    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=init))
    monkeypatch.setenv("WANDB_MODE", "disabled")
    logger = RunLogger(project="p", config={}, run_dir=str(tmp_path))
    assert not started and os.path.isfile(os.path.join(logger.dir,
                                                       "log.jsonl"))
    logger.finish()
    monkeypatch.setenv("WANDB_MODE", "offline")
    logger = RunLogger(project="p", config={}, run_dir=str(tmp_path))
    assert len(started) == 1 and logger._wandb is None
    logger.finish()


def test_device_prefetch_passes_batches_through_on_the_cpu():
    batches = [{"image": np.full((2, 3), i), "num_valid": i}
               for i in range(5)]
    out = list(device_prefetch(iter(batches), size=2, device="cpu"))
    assert len(out) == 5
    assert all(a is b for a, b in zip(out, batches))


def test_device_prefetch_needs_the_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(device_prefetch(iter([{"image": np.zeros(2)}])))
