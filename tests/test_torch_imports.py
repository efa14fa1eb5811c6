"""The PyTorch port stands alone: no JAX, and the card unless asked for CPU.

Every module of ``efficientdepthestimation_tpu_torch``, ``chip_smoke.py`` and
``scripts/run_e2e_torch.py`` is imported in a fresh interpreter, which must then hold no ``jax``, ``flax``
or ``efficientdepthestimation_tpu`` module, and none of PIL, pandas,
matplotlib and cv2, which the card's machine lacks: a module that decodes
or writes images or video imports them where it does so, as the study
tooling imports pandas. Importing builds no native library.
"""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import efficientdepthestimation_tpu_torch as port
from efficientdepthestimation_tpu_torch.apps import common
from efficientdepthestimation_tpu_torch.models import registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(ROOT, "e2e", "ENB0-HU-synthetic.ede")
LR_CHECKPOINT = os.path.join(ROOT, "e2e", "ENB0-LR-synthetic.ede")


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, port.__name__ + "."))


def test_port_imports_no_jax():
    modules = _port_modules()
    for name in ("ops.kernels.depthwise", "ops.quant", "apps.autotune",
                 "apps.export", "apps.ingest", "checkpoints.export",
                 "data.prefetch",
                 "utils.run_logger", "apps.train", "utils.image_io",
                 "checkpoints.lpips_convert", "benchmark",
                 *(f"benchmark.{m}" for m in (
                     "datasets", "depth_model", "harness", "metrics",
                     "noise", "raster_reference", "renderer")),
                 "native", "native.build", "native.loader", "native.encoder",
                 "utils.colmap_io", "mturk",
                 *(f"mturk.{m}" for m in (
                     "collect_study_materials", "process_mturk_results",
                     "process_mturk_second_round_results", "tum2kf"))):
        assert f"efficientdepthestimation_tpu_torch.{name}" in modules
    code = "\n".join(
        [f"import {m}" for m in modules] + [
            "import chip_smoke",
            "import sys",
            "sys.path.insert(0, 'scripts')",
            "import run_e2e_torch",
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', "
            "'efficientdepthestimation_tpu', 'PIL', 'pandas', 'matplotlib', "
            "'cv2'))",
            "assert not bad, bad",
            "from efficientdepthestimation_tpu_torch.native import encoder, "
            "loader",
            "assert encoder._LIBRARY._lib is None is loader._LIBRARY._lib",
            "print('clean', len(sys.modules))",
        ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("clean")


def test_entry_points_need_the_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.load_any_checkpoint(CHECKPOINT)
    model = registry.build_model("efficientnet-b0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.make_serving_fn(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.make_infer_fn(model, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.load_any_checkpoint(LR_CHECKPOINT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.make_serving_fn(registry.build_model("resnet18",
                                                    "lasinger2019"))
    assert common.resolve_device("cpu") == torch.device("cpu")


def test_export_entry_points_need_the_card_unless_cpu(monkeypatch,
                                                     tmp_path):
    """The export and ingest CLIs and ``save_serving_artifact`` run on the
    card, and raise without one before they write anything, unless asked
    for the CPU."""
    from efficientdepthestimation_tpu_torch.apps import export, ingest
    from efficientdepthestimation_tpu_torch.checkpoints import (
        export as artifacts,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "a.edz"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.main(["--model", CHECKPOINT, "--out", str(out)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        artifacts.save_serving_artifact(
            str(out), registry.build_model("resnet18"), encoder="resnet18",
            decoder="hu2018")
    assert not out.exists()
    report = tmp_path / "INGEST_REPORT.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ingest.main(["--source-dir", str(tmp_path), "--out-dir",
                     str(tmp_path / "released"), "--report", str(report)])
    assert not report.exists() and not (tmp_path / "released").exists()


def test_eval_entry_points_need_the_card_unless_cpu(monkeypatch, tmp_path):
    """The evaluation modules' entry points run on the card, and raise
    without one, unless given ``device="cpu"`` or ``--device cpu``."""
    from efficientdepthestimation_tpu_torch.apps import (
        evaluate,
        inference_benchmark,
        test_nyu,
        train,
    )
    from efficientdepthestimation_tpu_torch.training import train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = registry.build_model("efficientnet-b0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_step.make_eval_step()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run_eval_epoch(model, None, [], 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.evaluate_dataset(model, [], 1)
    frames = tmp_path / "frames"
    frames.mkdir()
    (tmp_path / "test.csv").write_text("")
    for main, argv in (
            (evaluate.main, ["--model", CHECKPOINT, "--test-csv",
                             str(tmp_path / "test.csv")]),
            (test_nyu.main, ["-c", os.path.dirname(CHECKPOINT),
                             "--test-csv", str(tmp_path / "test.csv"),
                             "-o", str(tmp_path / "out")]),
            (inference_benchmark.main, ["-c", os.path.dirname(CHECKPOINT),
                                        "-f", str(frames)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    train_step.make_eval_step(device="cpu")


def test_training_entry_points_need_the_card_unless_cpu(monkeypatch,
                                                        tmp_path):
    """The training CLI and its step builders run on the card, and raise
    without one, unless given ``--device cpu`` or ``device="cpu"``."""
    from efficientdepthestimation_tpu_torch.apps import train
    from efficientdepthestimation_tpu_torch.training import train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    for make in (train_step.make_train_step, train_step.make_grad_snapshot):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        make(device="cpu")
    (tmp_path / "empty.csv").write_text("")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--train-csv", "empty.csv", "--test-csv", "empty.csv"])
    assert not (tmp_path / "runs").exists()


def test_media_entry_points_need_the_card_unless_cpu(monkeypatch, tmp_path):
    """demo, point_clouds, depth_video, examples and inference, from an
    ``.ede`` and from a ``.pth``, raise without a card unless given
    ``--device cpu``, which then runs them (on no frames); and a ``.pth``
    loads on the card by default."""
    from efficientdepthestimation_tpu_torch.apps import (
        demo,
        depth_video,
        examples,
        inference,
        point_clouds,
    )
    from efficientdepthestimation_tpu_torch.checkpoints.pth_import import (
        reference_state_dict,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pth = tmp_path / "RN18-HU.pth"
    torch.save(reference_state_dict(registry.build_model("resnet18")), pth)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.load_any_checkpoint(str(pth))
    frames = tmp_path / "frames"
    frames.mkdir()
    for model in (CHECKPOINT, str(pth)):
        for main, argv in (
                (demo.main, ["-i", str(frames), "-m", model]),
                (point_clouds.main, ["-i", str(frames), "-m", model, "-o",
                                     str(tmp_path / "plys")]),
                (depth_video.main, ["-i", str(frames), "-m", model, "-o",
                                    str(tmp_path / "video")]),
                (examples.main, ["-c", os.path.dirname(model), "--test-csv",
                                 str(tmp_path / "test.csv")]),
                (inference.main, ["--model", model, "--test-csv",
                                  str(tmp_path / "test.csv")])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(argv)
    (tmp_path / "test.csv").write_text("")
    demo.main(["-i", str(frames), "-m", str(pth), "--device", "cpu"])
    point_clouds.main(["-i", str(frames), "-m", str(pth), "-o",
                       str(tmp_path / "plys"), "--device", "cpu"])
    depth_video.main(["-i", str(frames), "-m", str(pth), "-o",
                      str(tmp_path / "video"), "--device", "cpu"])


def test_benchmark_entry_points_need_the_card_unless_cpu(monkeypatch,
                                                        tmp_path):
    """The benchmark's main, its depth models, renderer sweep and visual
    metrics raise without a card, before they write anything, unless
    asked for the CPU."""
    import numpy as np

    from efficientdepthestimation_tpu_torch.benchmark import (
        depth_model,
        harness,
        metrics,
        renderer,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "bench"
    for call in (
            lambda: harness.main(["--csv-path", str(tmp_path / "x.csv"),
                                  "--output-path", str(out)]),
            lambda: depth_model.ReSIDEModel(CHECKPOINT,
                                            encoder="efficientnet-b0"),
            lambda: depth_model.ReSIDEModel(encoder="efficientnet-b0",
                                            pretrained=False),
            lambda: depth_model.MidasModel(LR_CHECKPOINT),
            lambda: renderer.create_rendered_images(str(out), []),
            lambda: metrics.VisualMetricsTracker(),
            lambda: harness.create_depth_maps(str(out), None, []),
            lambda: harness.test([], [], str(out))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not out.exists()
    model = depth_model.MidasModel(LR_CHECKPOINT, device="cpu")
    assert model(torch.zeros(1, 64, 96, 3)).device.type == "cpu"
    assert metrics.VisualMetricsTracker(device="cpu").device.type == "cpu"
    renderer.create_rendered_images(str(out), [], device="cpu")
    frames = renderer.render_novel_views_mesh(
        torch.zeros(8, 8, 3), torch.zeros(8, 8), np.eye(4)[None])
    assert frames.shape == (1, 8, 8, 3)


@pytest.mark.parametrize("encoder,decoder", [
    ("senet154", "hu2018"), ("densenet161", "hu2018"),
    ("densenet161", "lasinger2019")])
def test_dn161_sn154_build_with_jax_keys(encoder, decoder):
    """SN154-HU, DN161-HU and DN161-LR build with the JAX model's
    variables (keys and shapes of ``jax.eval_shape``)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from efficientdepthestimation_tpu.models import registry as jreg
    from efficientdepthestimation_tpu_torch.checkpoints.convert import (
        from_jax_variables,
    )

    jm = jreg.build_model(encoder, decoder)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 96, 3)), False))
    state = from_jax_variables(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    ours = registry.build_model(encoder, decoder).state_dict()
    assert sorted(state) == sorted(ours)
    assert all(state[k].shape == ours[k].shape for k in state)


def test_parse_checkpoint_name_matches_jax():
    from efficientdepthestimation_tpu.models import registry as jreg

    names = ["ENB0-HU.pth", "ENB4-LR.pth", "RN50-HU.pth", "DN161-HU.pth",
             "SN154-HU.pth", "enb0-hu.pth", "efficientnet-b0-hu2018.pth",
             "resnet50-lasinger2019.pth", "senet-HU.pth", "densenet-HU.ede",
             "/a/b/ENB4-HU.ede"]
    for name in names:
        assert registry.parse_checkpoint_name(name) == \
            jreg.parse_checkpoint_name(name), name
    for bad in ["model.pth", "ENB0-XX.pth", "foo-HU.pth"]:
        with pytest.raises(ValueError):
            registry.parse_checkpoint_name(bad)
        with pytest.raises(ValueError):
            jreg.parse_checkpoint_name(bad)
