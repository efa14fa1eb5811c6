"""The port's ingestion CLI (``apps/ingest.py``), on the CPU.

The JAX package's ``tests/test_ingest.py`` cases on the port, with the
same synthetic stand-ins (a random ENB0-HU ``.pth`` in the reference's
format, AlexNet and LPIPS-head stand-ins, NYU-layout archives); then one
``.pth`` written by the torch mirror of the reference models ingested by
both packages' CLIs: the reports agree field by field (paths aside), and
each package's ``.ede`` loads in the other and serves the same depth.
"""

import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientdepthestimation_tpu.apps import ingest as jax_ingest
from efficientdepthestimation_tpu.apps.common import (
    load_any_checkpoint as jax_load_any_checkpoint,
)

from efficientdepthestimation_tpu_torch.apps import ingest
from efficientdepthestimation_tpu_torch.apps.common import load_any_checkpoint
from efficientdepthestimation_tpu_torch.checkpoints.pth_import import (
    reference_state_dict,
)
from efficientdepthestimation_tpu_torch.data.datasets import DepthPairDataset
from efficientdepthestimation_tpu_torch.models.common import randomize_
from efficientdepthestimation_tpu_torch.models.registry import build_model

from full_size_configs import CONFIGS as MIRRORS
from test_ingest import _make_dataset_zip, _standin_lpips_inputs

PATH_KEYS = ("path", "native_checkpoint", "output", "csv", "source", "tree")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_ingest_dry_run(tmp_path):
    """A random ENB0-HU in the reference's ``.pth`` format and the LPIPS
    stand-ins: acquired from the source directory, validated, the
    checkpoint re-written as a native ``.ede``, LPIPS converted and
    self-checked, the five absent checkpoints reported absent."""
    src = tmp_path / "artifacts"
    out = tmp_path / "released"
    src.mkdir()
    model = randomize_(build_model("efficientnet-b0", "hu2018"), 0)
    torch.save(reference_state_dict(model), src / "ENB0-HU.pth")
    _standin_lpips_inputs(str(src / "alexnet-owt-7be5be79.pth"),
                          str(src / "lpips_alex.pth"))
    report_path = tmp_path / "report.json"
    report = ingest.main([
        "--source-dir", str(src), "--out-dir", str(out),
        "--lpips-out", str(tmp_path / "lpips_alex.npz"),
        "--report", str(report_path), "--device", "cpu"])
    entry = report["checkpoints"]["ENB0-HU.pth"]
    assert entry["structural_ok"]
    assert (entry["encoder"], entry["decoder"]) == ("efficientnet-b0",
                                                    "hu2018")
    assert entry["output_shape"] == [1, 114, 152, 1]
    assert os.path.isfile(entry["native_checkpoint"])
    assert report["checkpoints"]["RN50-LR.pth"] is None
    assert report["lpips"]["structural_ok"]
    assert abs(report["lpips"]["lpips_identity"]) < 1e-5
    assert json.loads(report_path.read_text())["ok"] is True


def test_ingest_expect_published_requires_csv(tmp_path):
    with pytest.raises(SystemExit):
        ingest.main(["--source-dir", str(tmp_path), "--out-dir",
                     str(tmp_path / "o"), "--expect-published",
                     "--report", str(tmp_path / "r.json"),
                     "--device", "cpu"])


def test_released_table_matches_jax():
    assert ingest.RELEASED == jax_ingest.RELEASED
    assert ingest.RELEASED["RN50-LR.pth"] == (0.849, 0.124)
    assert (ingest._RELEASE_BASE, ingest._LPIPS_SOURCES,
            ingest._DATASET_URL, ingest._EXPECTED_COUNTS) == (
        jax_ingest._RELEASE_BASE, jax_ingest._LPIPS_SOURCES,
        jax_ingest._DATASET_URL, jax_ingest._EXPECTED_COUNTS)


def _strip(obj):
    """A report without its paths."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in PATH_KEYS}
    return obj


def test_ingest_dataset_dry_run(tmp_path):
    """``--dataset-only`` turns a reference-layout archive into CSVs the
    port's loader reads, both depth conventions; the report is the JAX
    CLI's on the same archive."""
    src = tmp_path / "artifacts"
    src.mkdir()
    _make_dataset_zip(str(src / "nyu_data.zip"))
    reports = {}
    for name, cli in (("torch", ingest), ("jax", jax_ingest)):
        data_out = tmp_path / f"data_{name}"
        reports[name] = cli.main([
            "--dataset-only", "--source-dir", str(src),
            "--data-out", str(data_out),
            "--out-dir", str(tmp_path / f"o_{name}"),
            "--report", str(tmp_path / f"report_{name}.json")])
    entry = reports["torch"]["dataset"]
    assert entry["structural_ok"] is True
    assert entry["train"]["rows"] == 6 and entry["test"]["rows"] == 3
    assert entry["train"]["bit_depth_ok"] and entry["test"]["bit_depth_ok"]
    assert entry["train"]["dropped"] == 0
    assert _strip(reports["torch"]) == _strip(reports["jax"])
    data_out = tmp_path / "data_torch"
    img, dep = DepthPairDataset(str(data_out / "nyu2_train.csv"),
                                is_test=False, use_native=False)[0]
    assert img.shape == (480, 640, 3) and dep.dtype == np.uint8
    _, dep = DepthPairDataset(str(data_out / "nyu2_test.csv"), is_test=True,
                              use_native=False)[0]
    assert dep.dtype in (np.uint16, np.int32)


def test_ingest_dataset_extracted_tree(tmp_path):
    """An already-extracted tree (no archive) is accepted as the source."""
    import zipfile

    src = tmp_path / "artifacts"
    src.mkdir()
    _make_dataset_zip(str(src / "nyu_data.zip"), n_train=2, n_test=2)
    tree = tmp_path / "tree"
    with zipfile.ZipFile(str(src / "nyu_data.zip")) as zf:
        zf.extractall(str(tree))
    os.remove(str(src / "nyu_data.zip"))
    report = ingest.main([
        "--dataset-only", "--source-dir", str(tree),
        "--data-out", str(tmp_path / "data2"),
        "--out-dir", str(tmp_path / "o"),
        "--report", str(tmp_path / "r2.json")])
    assert report["dataset"]["structural_ok"] is True
    assert report["dataset"]["train"]["rows"] == 2


def test_archive_magic_and_selection(tmp_path):
    """Bad downloads fail the magic check before extraction, an unrelated
    archive is never extracted blind, and tar members that would escape
    the destination are refused."""
    import tarfile

    html = tmp_path / "nyu_data.zip"
    html.write_text("<html>Google Drive - Virus scan warning</html>")
    assert ingest._archive_kind(str(html)) is None
    with pytest.raises(RuntimeError, match="magic check failed"):
        ingest._extract_archive(str(html), str(tmp_path / "out"))
    _make_dataset_zip(str(tmp_path / "real_nyu.zip"), n_train=1, n_test=1)
    assert ingest._archive_kind(str(tmp_path / "real_nyu.zip")) == "zip"
    tar_path = tmp_path / "bundle.tar"
    with tarfile.open(tar_path, "w") as tf:
        p = tmp_path / "ckpt.bin"
        p.write_bytes(b"\x00" * 64)
        tf.add(str(p), arcname="checkpoints/ckpt.bin")
    assert ingest._archive_kind(str(tar_path)) == "tar"
    html.unlink()
    src = ingest._find_dataset_source(str(tmp_path), str(tmp_path / "d"),
                                      download=False)
    assert src is not None and os.path.basename(src) == "real_nyu.zip"
    os.rename(str(tmp_path / "real_nyu.zip"), str(tmp_path / "zz_data.zip"))
    src = ingest._find_dataset_source(str(tmp_path), str(tmp_path / "d"),
                                      download=False)
    assert src is not None and os.path.basename(src) == "zz_data.zip"
    evil = tmp_path / "evil_nyu.tar"
    with tarfile.open(evil, "w") as tf:
        p = tmp_path / "payload"
        p.write_bytes(b"x")
        tf.add(str(p), arcname="../escaped")
    with pytest.raises(tarfile.FilterError):
        ingest._extract_archive(str(evil), str(tmp_path / "jail" / "inner"))
    assert not (tmp_path / "jail" / "escaped").exists()


def test_mirror_pth_ingested_by_both_clis(tmp_path):
    """The torch mirror's ENB0-HU ``.pth`` through both CLIs: the same
    report but for paths; the port's ``.ede`` loads in the JAX package and
    the JAX package's in the port, with the same weights, and both serve
    the same depth at f32."""
    _, buf, _, _, _ = MIRRORS["ENB0-HU"]()
    src = tmp_path / "artifacts"
    src.mkdir()
    (src / "ENB0-HU.pth").write_bytes(buf.getvalue())
    reports = {}
    for name, cli, extra in (("torch", ingest, ["--device", "cpu"]),
                             ("jax", jax_ingest, [])):
        reports[name] = cli.main([
            "--source-dir", str(src), "--out-dir", str(tmp_path / name),
            "--lpips-out", str(tmp_path / name / "lpips.npz"),
            "--report", str(tmp_path / f"report_{name}.json"), *extra])
    assert _strip(reports["torch"]) == _strip(reports["jax"])
    assert reports["torch"]["checkpoints"]["ENB0-HU.pth"]["structural_ok"]
    ours = load_any_checkpoint(str(tmp_path / "jax" / "ENB0-HU.ede"),
                               device="cpu")
    mine = load_any_checkpoint(str(tmp_path / "torch" / "ENB0-HU.ede"),
                               device="cpu")
    for key, value in mine.state_dict().items():
        assert torch.equal(ours.state_dict()[key], value), key
    jmodel, variables = jax_load_any_checkpoint(
        str(tmp_path / "torch" / "ENB0-HU.ede"))
    x = np.random.default_rng(0).standard_normal(
        (1, 64, 96, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = ours(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
