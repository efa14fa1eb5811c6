"""The port's autotuner (``apps/autotune.py``) against the JAX package's, on
the CPU: policy keys, serving candidates, the training CLI's resolution
rules, both tuners writing entries that the serving fn and the training
CLI then follow, ``bake_weights`` refused, ``--policy``,
``--train-policy`` and ``--dw-impl`` through the CLIs' ``main``, and the
port's console scripts.
"""

import contextlib
import io
import itertools
import json
import os
import tomllib

import numpy as np
import pytest
import torch

from efficientdepthestimation_tpu.apps import autotune as jax_autotune
from efficientdepthestimation_tpu.models.registry import (
    build_model as jax_build_model,
)

from efficientdepthestimation_tpu_torch.apps import (
    autotune,
    inference_benchmark,
    test_nyu,
    train,
)
from efficientdepthestimation_tpu_torch.apps.autotune import (
    _serving_candidates,
    apply_train_policy,
    autotune_serving,
    autotune_train,
    load_policy,
    policy_key,
    train_policy_key,
)
from efficientdepthestimation_tpu_torch.apps.common import (
    make_infer_fn,
    make_serving_fn,
    serving_form,
)
from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
    save_checkpoint,
)
from efficientdepthestimation_tpu_torch.models.common import randomize_
from efficientdepthestimation_tpu_torch.models.registry import build_model

from test_train_app import synthetic_nyu  # noqa: F401  (8 train, 2 test)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The eight configurations the port serves: (encoder, decoder).
CONFIGS = [(e, "hu2018") for e in ("efficientnet-b0", "efficientnet-b4",
                                   "resnet50", "densenet161", "senet154")] + [
    (e, "lasinger2019") for e in ("efficientnet-b0", "efficientnet-b4",
                                  "resnet50")]
LR_SIZES = dict(input_size=(64, 96), output_size=(32, 48))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two PyTorch intra-op threads a worker: the suite runs its files in
    parallel workers, where torch's default of one thread a core
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _models(encoder, decoder):
    kw = LR_SIZES if decoder == "lasinger2019" else {}
    with torch.device("meta"):  # no weights are needed, only the modules
        ours = build_model(encoder, decoder, **kw)
    return ours, jax_build_model(encoder, decoder, **kw)


@pytest.mark.parametrize("encoder,decoder", CONFIGS)
def test_policy_keys_match_jax(encoder, decoder):
    """On the CPU the port's keys are the JAX package's, letter for
    letter, the device kind ``cpu`` in both."""
    ours, theirs = _models(encoder, decoder)
    for batch, (tdt, jdt) in itertools.product(
            (1, 128), ((None, None), (torch.bfloat16, "bfloat16"))):
        assert policy_key(ours, batch, tdt, "cpu") == \
            jax_autotune.policy_key(theirs, batch, jdt)
        assert train_policy_key(encoder, decoder, batch, tdt, "cpu") == \
            jax_autotune.train_policy_key(encoder, decoder, batch, jdt)
    assert autotune._device_kind("cpu") == "cpu"


@pytest.mark.parametrize("encoder,decoder", [
    ("efficientnet-b0", "hu2018"), ("resnet50", "hu2018"),
    ("efficientnet-b0", "lasinger2019"), ("resnet18", "lasinger2019")])
def test_serving_candidates_are_jax_minus_bake(encoder, decoder):
    ours, theirs = _models(encoder, decoder)
    for batch, int8 in itertools.product((8, 128, 256), (False, True)):
        want = [(n, s) for n, s in jax_autotune._serving_candidates(
            theirs, batch, int8=int8) if "+bake" not in n]
        assert _serving_candidates(ours, batch, int8=int8) == want
    assert len(_serving_candidates(ours, 256)) == (
        12 if encoder.startswith("eff") and decoder == "hu2018" else
        6 if encoder.startswith("eff") else 4 if decoder == "hu2018" else 2)
    assert jax_autotune.TILE_BATCH == autotune.TILE_BATCH == 128


def test_train_candidates_match_jax():
    for batch in (1, 2, 6, 8, 64):
        assert autotune._train_candidates(batch) == \
            jax_autotune._train_candidates(batch)


def test_apply_train_policy_matches_jax(tmp_path):
    """Every combination of explicit flags, with and without an entry for
    the key, and without a policy file: the JAX package's resolution."""
    path = str(tmp_path / "train_policy.json")
    key = jax_autotune.train_policy_key("resnet18", "hu2018", 8, "bfloat16")
    with open(path, "w") as f:
        json.dump({key: {"accum_steps": 4, "remat": None,
                         "img_per_s": 1.0}}, f)
    for policy, batch, accum, remat in itertools.product(
            (path, None, str(tmp_path / "missing.json")), (8, 16),
            (None, 1, 2), (None, "auto", "none", "dots", "full")):
        ours = apply_train_policy(policy, "resnet18", "hu2018", batch,
                                  torch.bfloat16, accum, remat, device="cpu")
        assert ours == jax_autotune.apply_train_policy(
            policy, "resnet18", "hu2018", batch, "bfloat16", accum, remat), (
            policy, batch, accum, remat)
    assert apply_train_policy(path, "resnet18", "hu2018", 8, torch.bfloat16,
                              None, "auto", device="cpu") == (4, None,
                                                               "policy")


@pytest.fixture(scope="module")
def rn18_hu():
    return randomize_(build_model("resnet18", "hu2018"), 3)


def test_autotune_serving_writes_and_dispatches(rn18_hu, tmp_path):
    """``iters=1``: every candidate timed and recorded, the winner written
    under its key, and ``make_serving_fn`` then serving it; the int8
    variants with their ``rel_out_err``; other batches keep the rule."""
    path = str(tmp_path / "serving_policy.json")
    images = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 48, 3)).astype(np.float32))
    fn, entry = autotune_serving(rn18_hu, 2, crop_hw=(32, 48),
                                 policy_path=path, warmup=0, iters=1,
                                 verbose=False, int8=True, device="cpu")
    assert [r["candidate"] for r in entry["measured"]] == [
        "monolithic/xla", "staged/xla", "monolithic/xla+int8",
        "staged/xla+int8"]
    assert all(r["fps"] > 0 for r in entry["measured"])
    assert all(0 < r["rel_out_err"] < 0.05 for r in entry["measured"]
               if r.get("int8"))
    stored = load_policy(path)[policy_key(rn18_hu, 2, None, "cpu")]
    assert stored["path"] == entry["path"] == fn.spec["path"]
    assert stored["bake_weights"] is False
    served = make_serving_fn(rn18_hu, batch_hint=2, policy_path=path,
                             device="cpu")
    assert {k: served.spec[k] for k in ("path", "dw_impl", "int8")} == {
        k: entry[k] for k in ("path", "dw_impl", "int8")}
    ref = make_infer_fn(rn18_hu, device="cpu", int8=entry["int8"])(images)
    torch.testing.assert_close(served(images), ref, rtol=1e-5, atol=1e-5)
    other = make_serving_fn(rn18_hu, batch_hint=3, policy_path=path,
                            device="cpu")
    assert other.spec == dict(serving_form(3), dw_impl="pallas", int8=False)


def test_autotune_serving_pairs_enb0_lowerings(tmp_path):
    """ENB0-HU: the three depthwise modes each a candidate."""
    model = randomize_(build_model("efficientnet-b0", "hu2018"), 4)
    path = str(tmp_path / "serving_policy.json")
    _, entry = autotune_serving(model, 1, crop_hw=(32, 48), policy_path=path,
                                warmup=0, iters=1, verbose=False,
                                dtype=torch.bfloat16, device="cpu")
    assert [r["candidate"] for r in entry["measured"]] == [
        f"{p}/{dw}" for dw in ("xla", "shift", "pallas")
        for p in ("monolithic", "staged")]
    key = policy_key(model, 1, torch.bfloat16, "cpu")
    assert key == "cpu|HuDepthModel:efficientnet-b0|b1|bfloat16"
    assert load_policy(path)[key]["dw_impl"] == entry["dw_impl"]


def test_bake_weights_raises_naming_a16(rn18_hu, tmp_path):
    """``bake_weights=True``, passed or in a policy entry, raises."""
    path = str(tmp_path / "serving_policy.json")
    with open(path, "w") as f:
        json.dump({policy_key(rn18_hu, 4, None, "cpu"): {
            "path": "monolithic", "dw_impl": "xla", "int8": False,
            "bake_weights": True}}, f)
    with pytest.raises(NotImplementedError, match="A16"):
        make_serving_fn(rn18_hu, batch_hint=4, policy_path=path,
                        device="cpu")
    with pytest.raises(NotImplementedError, match="A16"):
        autotune.build_serving_candidate(
            rn18_hu, {"path": "staged", "dw_impl": "xla",
                      "bake_weights": True}, device="cpu")
    assert make_serving_fn(rn18_hu, batch_hint=4, bake_weights=False,
                           device="cpu").spec["path"] == "monolithic"


def test_autotune_train_writes_the_cli_policy(tmp_path):
    """``autotune_train`` at batch 2 (accum 1 × three remats, accum 2),
    ``iters=1``: the entry written, and the training CLI's resolution of
    ``--train-policy`` (``train.train_policy``) gives the winner, where
    explicit flags still win."""
    path = str(tmp_path / "train_policy.json")
    entry = autotune_train("resnet18", "hu2018", 2, crop_hw=(32, 48),
                           bf16=False, policy_path=path, warmup=0, iters=1,
                           verbose=False, device="cpu")
    assert [r["candidate"] for r in entry["measured"]] == [
        "accum1/no-remat", "accum1/dots", "accum1/full", "accum2/no-remat"]
    assert all(r["img_per_s"] > 0 for r in entry["measured"])
    assert list(load_policy(path)) == ["cpu|resnet18-hu2018|b2|float32"]
    base = ["--encoder", "resnet18", "--per-device-batch", "2",
            "--train-policy", path]
    accum, remat, source = train.train_policy(train.parse_args(base), "cpu")
    assert (accum, remat) == (entry["accum_steps"], entry["remat"])
    assert source == f"policy {path}"
    assert train.train_policy(train.parse_args(base + ["--remat", "none"]),
                              "cpu") == (1, None, "flags")
    assert train.train_policy(train.parse_args(base + ["--bf16"]),
                              "cpu") == (1, None, "defaults")


def test_train_cli_follows_train_policy(synthetic_nyu, tmp_path,  # noqa: F811
                                        monkeypatch):
    """``--train-policy`` through the CLI's ``main``: the step is built
    with the entry's accum_steps and remat, and the CLI says so; without
    the flag, ``runs/train_policy.json`` is read when it exists."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("WANDB_MODE", "disabled")
    built = []
    make = train.make_train_step
    monkeypatch.setattr(train, "make_train_step",
                        lambda **kw: built.append(kw) or make(**kw))
    os.makedirs("runs")
    path = os.path.join("runs", "train_policy.json")
    with open(path, "w") as f:
        json.dump({"cpu|resnet18-hu2018|b2|float32": {
            "accum_steps": 2, "remat": None, "img_per_s": 1.0}}, f)
    argv = ["--encoder", "resnet18", "--train-csv",
            synthetic_nyu["train_csv"], "--test-csv",
            synthetic_nyu["test_csv"], "--per-device-batch", "2",
            "--crop-hw", "32", "48", "--device", "cpu", "--epochs", "1",
            "--watch-every", "0", "--stop-after-steps", "1"]
    for extra in (["--train-policy", path], []):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            train.main(argv + extra)
        assert built[-1]["accum_steps"] == 2
        assert built[-1]["remat"] is None
        assert "train policy from policy" in out.getvalue()


@pytest.fixture(scope="module")
def cli_workspace(tmp_path_factory):
    """An RN18-HU checkpoint, a test CSV of 2 pairs and a frames dir."""
    from PIL import Image

    root = tmp_path_factory.mktemp("autotune_cli")
    ckpt_dir = root / "checkpoints"
    ckpt_dir.mkdir()
    save_checkpoint(str(ckpt_dir / "RN18-HU.ede"),
                    randomize_(build_model("resnet18", "hu2018"), 5),
                    encoder="resnet18", decoder="hu2018")
    frames = root / "frames"
    frames.mkdir()
    rng = np.random.default_rng(1)
    rows = []
    for i in range(2):
        image = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
        Image.fromarray(image).save(root / f"rgb{i}.png")
        Image.fromarray(rng.integers(500, 9000, (480, 640)).astype(
            np.uint16), mode="I;16").save(root / f"d{i}.png")
        Image.fromarray(image).save(frames / f"{i:03d}.png")
        rows.append(f"rgb{i}.png,d{i}.png\n")
    (root / "test.csv").write_text("".join(rows))
    # the entry make_serving_fn will find for this model at batch 2: the
    # staged form, where the rule serves the monolithic one
    key = policy_key(build_model("resnet18", "hu2018"), 2, None, "cpu")
    (root / "policy.json").write_text(json.dumps({key: {
        "path": "staged", "dw_impl": "xla", "int8": False,
        "bake_weights": False}}))
    return root


def _staged_spy(monkeypatch):
    calls = []
    make = autotune.make_staged_infer_fn
    monkeypatch.setattr(autotune, "make_staged_infer_fn",
                        lambda *a, **kw: calls.append(kw) or make(*a, **kw))
    return calls


def test_serving_clis_follow_policy(cli_workspace, tmp_path, monkeypatch):
    """``test_nyu --policy`` and ``inference_benchmark --policy --dw-impl``
    serve the entry's form at their batch (``-b``): the staged form here,
    whose depth maps equal those of the rule's monolithic form."""
    root = cli_workspace
    calls = _staged_spy(monkeypatch)
    argv = ["-c", str(root / "checkpoints"), "--test-csv",
            str(root / "test.csv"), "-b", "2", "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        test_nyu.main(argv + ["-o", str(tmp_path / "mono")])
        assert calls == []
        test_nyu.main(argv + ["-o", str(tmp_path / "policy"), "--policy",
                              str(root / "policy.json")])
    assert len(calls) == 1
    from PIL import Image

    for name in ("0000.png", "0001.png"):
        a = np.asarray(Image.open(tmp_path / "mono" / "RN18-HU" / name))
        b = np.asarray(Image.open(tmp_path / "policy" / "RN18-HU" / name))
        assert a.shape == (480, 640) and np.abs(
            a.astype(np.int64) - b).max() <= 1

    bench = ["-c", str(root / "checkpoints"), "-f", str(root / "frames"),
             "-n", "1", "-b", "2", "--device", "cpu", "-o", str(tmp_path)]
    with contextlib.redirect_stdout(io.StringIO()):
        summary = inference_benchmark.main(
            bench + ["--policy", str(root / "policy.json"), "--dw-impl",
                     "shift"])
    assert list(summary) == ["RN18-HU"] and len(calls) == 2
    assert calls[-1]["dw_impl"] == "xla"  # the entry's, over --dw-impl
    with pytest.raises(SystemExit):
        inference_benchmark.main(bench + ["--dw-impl", "fast"])


def test_console_scripts_import():
    """Every ``ede-torch-*`` script of ``pyproject.toml`` names a ``main``
    of the port, one for each of its CLIs, beside the JAX package's
    scripts."""
    import importlib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    ours = {k: v for k, v in scripts.items() if k.startswith("ede-torch-")}
    assert len(ours) == 12
    for name, target in ours.items():
        module, attr = target.split(":")
        assert module.startswith("efficientdepthestimation_tpu_torch.")
        assert callable(getattr(importlib.import_module(module), attr)), name
    assert scripts["ede-train"] == "efficientdepthestimation_tpu.apps.train:main"
