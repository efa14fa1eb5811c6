"""The PyTorch port stands alone: no JAX, and the card unless asked for CPU.

Every module of ``efficientdepthestimation_tpu_torch`` and ``chip_smoke.py``
is imported in a fresh interpreter, which must then hold no ``jax``, ``flax``
or ``efficientdepthestimation_tpu`` module.
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


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, port.__name__ + "."))


def test_port_imports_no_jax():
    modules = _port_modules()
    assert "efficientdepthestimation_tpu_torch.ops.kernels.depthwise" in \
        modules
    code = "\n".join(
        [f"import {m}" for m in modules] + [
            "import chip_smoke",
            "import sys",
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', "
            "'efficientdepthestimation_tpu'))",
            "assert not bad, bad",
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
    assert common.resolve_device("cpu") == torch.device("cpu")


def test_pth_checkpoints_are_not_ported_yet(tmp_path):
    path = tmp_path / "ENB0-HU.pth"
    path.write_bytes(b"PK\x03\x04 not an ede file")
    with pytest.raises(NotImplementedError, match="A8"):
        common.load_any_checkpoint(str(path), device="cpu")


@pytest.mark.parametrize("encoder,decoder", [
    ("resnet50", "hu2018"), ("densenet161", "hu2018"),
    ("efficientnet-b0", "lasinger2019")])
def test_unported_models_name_the_roadmap_item(encoder, decoder):
    with pytest.raises(NotImplementedError, match="A7"):
        registry.build_model(encoder, decoder)


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
