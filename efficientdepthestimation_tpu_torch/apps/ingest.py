"""One-command ingestion of the released artifacts the environment can't reach.

Counterpart of ``efficientdepthestimation_tpu/apps/ingest.py``, with the
same flags and the same ``INGEST_REPORT.json`` fields: each checkpoint is
validated by the port's ``load_any_checkpoint`` and a forward at 228×304 and
rewritten by the port's ``.ede`` writer (a file both packages load); LPIPS
is converted by the port's ``checkpoints.lpips_convert``, the δ1/REL check
runs the port's ``apps.evaluate``, and the dataset route validates the
splits with the port's ``DepthPairDataset``. The forwards (checkpoint,
LPIPS, δ1/REL) run on the CUDA card unless ``--device cpu``; the dataset
route is host work only. The network is touched only with ``--download``.

The reference publishes six trained ``.pth`` checkpoints
(``README.md:49-56``) and its visual benchmark needs the official
LPIPS-AlexNet weights (``Benchmark/benchmark.py:1389``). Neither is
downloadable in a zero-egress environment, so this app packages the entire
"day egress exists" workflow as one command: acquire (download or mounted
dir) → convert → structurally validate → optionally run the δ1/REL parity
check against the published table.

    # from a mounted directory of artifacts
    ede-torch-ingest --source-dir /mnt/artifacts --out-dir checkpoints/released

    # with network access
    ede-torch-ingest --download --out-dir checkpoints/released \
        --test-csv data/nyu2_test.csv --expect-published

    # the NYU-v2 training data too (zip/tarball or extracted tree;
    # README.md:12) -> ready-to-train data/nyu2_{train,test}.csv
    ede-torch-ingest --dataset-only --source-dir /mnt/artifacts --data-out data

Outputs, per checkpoint found: an imported-and-verified native EDE
checkpoint next to the original, plus ``INGEST_REPORT.json`` summarising
every validation. With ``--expect-published`` (requires ``--test-csv``
pointing at the real NYU-v2 test split) each model's δ1/REL must match the
README table within ``--tolerance`` (default 0.002 — the BASELINE north
star), and the exit code reflects the comparison.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

# README.md:49-56 — name -> (url, delta1, rel)
RELEASED = {
    "ENB0-HU.pth": (0.816, 0.140),
    "ENB4-HU.pth": (0.840, 0.128),
    "RN50-HU.pth": (0.843, 0.125),
    "ENB0-LR.pth": (0.807, 0.144),
    "ENB4-LR.pth": (0.835, 0.130),
    "RN50-LR.pth": (0.849, 0.124),
}
_RELEASE_BASE = ("https://github.com/AnthonyDickson/EfficientDepthEstimation"
                 "/releases/download/v1.0.0/")
# LPIPS inputs: torchvision AlexNet backbone + lpips 0.1.4 linear heads
_LPIPS_SOURCES = {
    "alexnet-owt-7be5be79.pth":
        "https://download.pytorch.org/models/alexnet-owt-7be5be79.pth",
    "lpips_alex.pth":
        "https://github.com/richzhang/PerceptualSimilarity/raw/master/"
        "lpips/weights/v0.1/alex.pth",
}
# NYU-v2 training data (reference README.md:12 — Google Drive file id)
_DATASET_URL = ("https://drive.google.com/uc?export=download&"
                "id=1WoOZOBpOWfmwe7bknWS5PMUCLBPFKTOw")
_DATASET_ARCHIVE = "nyu_data.zip"
# the reference's published split sizes (informational — loaddata.py:44,73)
_EXPECTED_COUNTS = {"train": 50688, "test": 654}


def _archive_kind(path: str) -> Optional[str]:
    """'zip' / 'tar' / 'gztar' from the file's magic bytes, else None.

    Google Drive serves an HTML virus-scan interstitial instead of large
    files (ADVICE r4); checking the payload's magic before extraction turns
    "opaque BadZipFile mid-extract" into "bad download" at acquire time."""
    try:
        with open(path, "rb") as f:
            head = f.read(4)
            f.seek(257)
            ustar = f.read(5)
    except OSError:
        return None
    if head.startswith(b"PK\x03\x04") or head.startswith(b"PK\x05\x06"):
        return "zip"
    if head[:2] == b"\x1f\x8b":
        return "gztar"
    if ustar == b"ustar":
        return "tar"
    return None


def _download_google_drive(url: str, dest: str) -> None:
    """Fetch a Drive uc?export=download URL, handling the large-file
    virus-scan confirmation flow (the plain GET returns an HTML page with a
    confirm form for multi-GB files, not the payload)."""
    import http.cookiejar
    import re
    import urllib.parse
    import urllib.request

    jar = http.cookiejar.CookieJar()
    opener = urllib.request.build_opener(
        urllib.request.HTTPCookieProcessor(jar))

    def fetch(u: str) -> bytes | None:
        """Stream to dest; return the body instead when it is HTML."""
        with opener.open(u) as resp:
            ctype = resp.headers.get("Content-Type", "")
            if "text/html" in ctype:
                return resp.read()
            with open(dest, "wb") as f:
                while chunk := resp.read(1 << 20):
                    f.write(chunk)
        return None

    html = fetch(url)
    if html is None:
        return
    # Large-file flow: the interstitial form posts to
    # drive.usercontent.google.com/download with hidden id/export/confirm/
    # uuid inputs (older variants use a confirm token in a cookie or link).
    text = html.decode("utf-8", "replace")
    action = re.search(r'action="([^"]+)"', text)
    hidden = dict(re.findall(
        r'<input type="hidden" name="([^"]+)" value="([^"]*)"', text))
    if action and hidden.get("id"):
        confirm_url = (action.group(1).replace("&amp;", "&") + "?"
                       + urllib.parse.urlencode(hidden))
    else:
        token = next((c.value for c in jar
                      if c.name.startswith("download_warning")), None)
        if token is None:
            m = re.search(r"confirm=([0-9A-Za-z_-]+)", text)
            token = m.group(1) if m else "t"
        sep = "&" if "?" in url else "?"
        confirm_url = f"{url}{sep}confirm={token}"
    if fetch(confirm_url) is not None:
        raise RuntimeError(
            "Google Drive returned HTML twice (confirmation flow failed) — "
            "download the file in a browser and mount it via --source-dir")


def _acquire(name: str, url: str, source_dir: Optional[str],
             out_dir: str, download: bool) -> Optional[str]:
    """Find ``name`` in source_dir, else download it to out_dir. None if absent."""
    if source_dir:
        cand = os.path.join(source_dir, name)
        if os.path.isfile(cand):
            return cand
    dest = os.path.join(out_dir, name)
    if os.path.isfile(dest):
        return dest
    if download:
        import urllib.request

        print(f"downloading {url} -> {dest}")
        try:
            if "drive.google.com" in url or "drive.usercontent" in url:
                _download_google_drive(url, dest)
            else:
                urllib.request.urlretrieve(url, dest)
            if (name.endswith((".zip", ".tar", ".tar.gz", ".tgz"))
                    and _archive_kind(dest) is None):
                raise RuntimeError(
                    f"{name} downloaded but is not a zip/tar archive "
                    "(HTML interstitial or truncated transfer?)")
            return dest
        except Exception as exc:  # zero-egress environments land here
            print(f"  download failed: {exc}")
            if os.path.isfile(dest):
                os.remove(dest)
    return None


def _validate_checkpoint(path: str, out_dir: str, device) -> dict:
    """load_any_checkpoint → forward at 228×304 on ``device`` →
    finite/shape sanity → native re-export."""
    import numpy as np
    import torch

    from efficientdepthestimation_tpu_torch.apps.common import (
        infer_arch_from_path,
        load_any_checkpoint,
    )
    from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
        save_checkpoint,
    )

    encoder, decoder = infer_arch_from_path(path)
    model = load_any_checkpoint(path, device=device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((1, 228, 304, 3), np.float32))
    with torch.inference_mode():
        out = model(x.to(device)).cpu().numpy()
    finite = bool(np.isfinite(out).all())
    n_params = sum(int(v.numel()) for v in model.state_dict().values())
    native = os.path.join(
        out_dir, os.path.basename(path).replace(".pth", ".ede"))
    save_checkpoint(native, model, encoder=encoder, decoder=decoder)
    return {
        "path": path,
        "encoder": encoder,
        "decoder": decoder,
        "output_shape": list(out.shape),
        "finite": finite,
        "n_params": n_params,
        "native_checkpoint": native,
        "structural_ok": finite and out.ndim == 4,
    }


def _convert_lpips(alexnet_path: str, lpips_path: str, output: str,
                   device) -> dict:
    """Convert + self-check: LPIPS must be 0 on identical images, finite else."""
    import numpy as np
    import torch

    from efficientdepthestimation_tpu_torch.benchmark.metrics import (
        load_lpips_weights,
        lpips_alex,
    )
    from efficientdepthestimation_tpu_torch.checkpoints.lpips_convert import (
        convert,
    )

    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    convert(alexnet_path, lpips_path, output)
    weights = load_lpips_weights(output, device=device)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.random((1, 64, 64, 3), np.float32) * 2 - 1)
    b = torch.from_numpy(rng.random((1, 64, 64, 3), np.float32) * 2 - 1)
    a, b = a.to(device), b.to(device)
    with torch.inference_mode():
        d_same = float(torch.mean(lpips_alex(a, a, weights)))
        d_diff = float(torch.mean(lpips_alex(a, b, weights)))
    return {
        "output": output,
        "lpips_identity": d_same,
        "lpips_random_pair": d_diff,
        "structural_ok": abs(d_same) < 1e-5 and 0.0 < d_diff < 10.0,
    }


def _accuracy_check(path: str, test_csv: str, tolerance: float,
                    device) -> dict:
    """Run the full NYU evaluation and compare δ1/REL to the README table."""
    from efficientdepthestimation_tpu_torch.apps import evaluate

    tracker, _ = evaluate.main(["--model", path, "--test-csv", test_csv,
                                "--batch-size", "8",
                                "--device", str(device)])
    metrics = tracker.to_dict()
    want_d1, want_rel = RELEASED[os.path.basename(path)]
    got_d1 = float(metrics["delta1"])
    got_rel = float(metrics["abs_rel"])
    return {
        "delta1": got_d1, "rel": got_rel,
        "published_delta1": want_d1, "published_rel": want_rel,
        "delta1_ok": abs(got_d1 - want_d1) <= tolerance,
        "rel_ok": abs(got_rel - want_rel) <= tolerance,
    }


def _find_dataset_source(source_dir: Optional[str], data_out: str,
                         download: bool) -> Optional[str]:
    """An archive (zip/tar) or an already-extracted tree containing
    ``nyu2_train.csv``. ``None`` when nothing is reachable."""
    if source_dir:
        for root, _, files in os.walk(source_dir):
            if "nyu2_train.csv" in files:
                return root  # extracted tree
        archives = [os.path.join(source_dir, name)
                    for name in sorted(os.listdir(source_dir))
                    if name.endswith((".zip", ".tar", ".tar.gz", ".tgz"))]
        # A source dir can hold unrelated archives (checkpoint bundles,
        # ADVICE r4); prefer nyu-named ones, then any whose listing contains
        # nyu2_train.csv — never blind-extract the alphabetically first.
        archives.sort(key=lambda p: "nyu" not in os.path.basename(p).lower())
        for cand in archives:
            if ("nyu" in os.path.basename(cand).lower()
                    or _archive_lists_nyu(cand)):
                return cand
    return _acquire(_DATASET_ARCHIVE, _DATASET_URL, None, data_out, download)


def _archive_lists_nyu(archive: str) -> bool:
    """Peek the archive listing for nyu2_train.csv without extracting."""
    import tarfile
    import zipfile

    try:
        if _archive_kind(archive) == "zip":
            with zipfile.ZipFile(archive) as zf:
                return any(n.endswith("nyu2_train.csv") for n in zf.namelist())
        with tarfile.open(archive) as tf:
            return any(m.name.endswith("nyu2_train.csv") for m in tf)
    except Exception:
        return False


def _extract_archive(archive: str, dest: str) -> str:
    import tarfile
    import zipfile

    os.makedirs(dest, exist_ok=True)
    kind = _archive_kind(archive)
    if kind is None:
        raise RuntimeError(
            f"{archive} is not a zip/tar archive (magic check failed) — "
            "likely a failed/HTML download; re-acquire the dataset")
    print(f"extracting {archive} -> {dest}")
    if kind == "zip":
        with zipfile.ZipFile(archive) as zf:
            zf.extractall(dest)
    else:
        with tarfile.open(archive) as tf:
            # externally acquired archive: refuse tar-slip members
            # (absolute paths / '..' traversal) instead of writing them
            tf.extractall(dest, filter="data")
    return dest


def _locate(tree: str, name: str) -> Optional[str]:
    for root, _, files in os.walk(tree):
        if name in files:
            return os.path.join(root, name)
    return None


def _normalize_csv(src_csv: str, tree: str, out_csv: str) -> dict:
    """Rewrite a reference split CSV with absolute, verified paths.

    The reference zip's rows are repo-root-relative (``data/nyu2_train/...``,
    loaddata.py:44) while our loader resolves relative rows against the
    CSV's own directory (data/datasets.py) — resolve each row against every
    plausible root and write what actually exists."""
    import csv as csv_mod

    csv_dir = os.path.dirname(os.path.abspath(src_csv))
    roots = [csv_dir, os.path.dirname(csv_dir), tree,
             os.path.dirname(tree.rstrip(os.sep))]

    def resolve(rel: str) -> Optional[str]:
        rel = rel.strip()
        if os.path.isabs(rel):
            return rel if os.path.isfile(rel) else None
        for root in roots:
            cand = os.path.join(root, rel)
            if os.path.isfile(cand):
                return os.path.abspath(cand)
        return None

    kept, dropped = 0, 0
    with open(src_csv, newline="") as f_in, \
            open(out_csv, "w", newline="") as f_out:
        writer = csv_mod.writer(f_out)
        for row in csv_mod.reader(f_in):
            if not row:
                continue
            image, depth = resolve(row[0]), resolve(row[1])
            if image and depth:
                writer.writerow([image, depth])
                kept += 1
            else:
                dropped += 1
    return {"csv": out_csv, "rows": kept, "dropped": dropped}


def _validate_split(csv_path: str, is_test: bool, sample_k: int = 8) -> dict:
    """Decode a few pairs and check the load-bearing depth conventions:
    8-bit PNG train depths (×10/255 m), 16-bit PNG test depths (÷1000 m)
    — nyu_transform.py:170-175."""
    import numpy as np
    from PIL import Image

    from efficientdepthestimation_tpu_torch.data.datasets import (
        DepthPairDataset,
    )

    ds = DepthPairDataset(csv_path, is_test=is_test, use_native=False)
    n = len(ds)
    idx = sorted({0, n // 2, n - 1} | set(range(min(sample_k, n))))
    depths_m = []
    bit_ok, image_ok = True, True
    for i in idx:
        image_path, depth_path = ds.rows[i]
        img = Image.open(image_path)
        image_ok &= img.mode in ("RGB", "L") and img.size[0] >= img.size[1]
        dep = Image.open(depth_path)
        arr = np.asarray(dep)
        if is_test:
            bit_ok &= arr.dtype in (np.uint16, np.int32)
            depths_m.append(arr.astype(np.float64) / 1000.0)
        else:
            bit_ok &= arr.dtype == np.uint8
            depths_m.append(arr.astype(np.float64) / 255.0 * 10.0)
    stacked = np.concatenate([d.ravel() for d in depths_m])
    rng_ok = (0.0 <= float(stacked.min())
              and float(np.percentile(stacked, 99)) <= 12.0
              and float(stacked.std()) > 0.01)
    split = "test" if is_test else "train"
    return {
        "rows": n,
        "expected_rows": _EXPECTED_COUNTS[split],
        "matches_reference_count": n == _EXPECTED_COUNTS[split],
        "bit_depth_ok": bool(bit_ok),
        "images_ok": bool(image_ok),
        "depth_range_m": [float(stacked.min()), float(stacked.max())],
        "structural_ok": bool(bit_ok and image_ok and rng_ok),
    }


def _ingest_dataset(source_dir: Optional[str], download: bool,
                    data_out: str) -> dict:
    """Acquire → extract → normalize CSVs → validate conventions. The result
    is a ready-to-train ``data_out/nyu2_{train,test}.csv`` pair in the exact
    layout every CLI consumes (loaddata.py:32-85)."""
    os.makedirs(data_out, exist_ok=True)
    source = _find_dataset_source(source_dir, data_out, download)
    if source is None:
        return {"structural_ok": False, "error": "no dataset source found "
                "(mount the nyu_data.zip / extracted tree via --source-dir "
                "or pass --download with egress)"}
    if os.path.isdir(source):
        tree = source
    else:
        tree = _extract_archive(source, os.path.join(data_out, "_extracted"))
    report: dict = {"source": source, "tree": tree}
    ok = True
    for split in ("train", "test"):
        src_csv = _locate(tree, f"nyu2_{split}.csv")
        if src_csv is None:
            report[split] = {"structural_ok": False,
                            "error": f"nyu2_{split}.csv not found"}
            ok = False
            continue
        out_csv = os.path.join(data_out, f"nyu2_{split}.csv")
        entry = _normalize_csv(src_csv, tree, out_csv)
        if entry["rows"] == 0:
            entry.update(structural_ok=False, error="no resolvable rows")
            ok = False
        else:
            entry.update(_validate_split(out_csv, is_test=(split == "test")))
            ok &= entry["structural_ok"]
        report[split] = entry
        status = "ok" if entry.get("structural_ok") else "FAIL"
        print(f"[{status:^7}] dataset {split}: {entry.get('rows', 0)} rows "
              f"-> {entry.get('csv', '-')}")
    report["structural_ok"] = bool(ok)
    return report


def main(args: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(
        description="Acquire/convert/validate the released artifacts")
    parser.add_argument("--source-dir", type=str, default=None,
                        help="mounted directory holding the released .pth "
                             "files and/or LPIPS inputs")
    parser.add_argument("--download", action="store_true",
                        help="fetch anything missing from the public URLs")
    parser.add_argument("--out-dir", type=str, default="checkpoints/released")
    parser.add_argument("--lpips-out", type=str, default="weights/lpips_alex.npz")
    parser.add_argument("--test-csv", type=str, default=None,
                        help="real NYU-v2 test split CSV for the parity check")
    parser.add_argument("--expect-published", action="store_true",
                        help="fail unless δ1/REL match README.md:49-56 within "
                             "--tolerance (needs --test-csv)")
    parser.add_argument("--tolerance", type=float, default=0.002)
    parser.add_argument("--report", type=str, default="INGEST_REPORT.json")
    parser.add_argument("--dataset", action="store_true",
                        help="also acquire/convert the real NYU-v2 training "
                             "data (README.md:12) into the reference csv "
                             "layout at --data-out")
    parser.add_argument("--dataset-only", action="store_true",
                        help="ingest the dataset and skip checkpoint/LPIPS "
                             "acquisition")
    parser.add_argument("--data-out", type=str, default="data")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the checkpoint, LPIPS and "
                             "δ1/REL forwards (default: the CUDA card; "
                             "'cpu' on request)")
    args = parser.parse_args(args)

    from efficientdepthestimation_tpu_torch.apps.common import resolve_device

    # the dataset route runs no forward, so it needs no card
    device = None if args.dataset_only else resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    report: dict = {"checkpoints": {}, "lpips": None, "accuracy": {},
                    "dataset": None}
    ok = True

    if args.dataset or args.dataset_only:
        entry = _ingest_dataset(args.source_dir, args.download, args.data_out)
        report["dataset"] = entry
        ok &= entry["structural_ok"]
        if args.dataset_only:
            report["ok"] = bool(ok)
            with open(args.report, "w") as f:
                json.dump(report, f, indent=2)
            print(f"report -> {args.report} (ok={ok})")
            if not ok:
                raise SystemExit(1)
            return report

    for name in RELEASED:
        path = _acquire(name, _RELEASE_BASE + name, args.source_dir,
                        args.out_dir, args.download)
        if path is None:
            print(f"[absent ] {name}")
            report["checkpoints"][name] = None
            continue
        entry = _validate_checkpoint(path, args.out_dir, device)
        report["checkpoints"][name] = entry
        ok &= entry["structural_ok"]
        print(f"[{'ok' if entry['structural_ok'] else 'FAIL':^7}] {name}: "
              f"{entry['n_params']:,} params -> {entry['native_checkpoint']}")

    lpips_paths = {
        key: _acquire(key, url, args.source_dir, args.out_dir, args.download)
        for key, url in _LPIPS_SOURCES.items()
    }
    if all(lpips_paths.values()):
        entry = _convert_lpips(lpips_paths["alexnet-owt-7be5be79.pth"],
                               lpips_paths["lpips_alex.pth"], args.lpips_out,
                               device)
        report["lpips"] = entry
        ok &= entry["structural_ok"]
        print(f"[{'ok' if entry['structural_ok'] else 'FAIL':^7}] LPIPS -> "
              f"{args.lpips_out} (identity={entry['lpips_identity']:.2e}, "
              f"pair={entry['lpips_random_pair']:.3f})")
    else:
        print("[absent ] LPIPS inputs (alexnet + lpips heads)")

    if args.expect_published:
        if not args.test_csv or not os.path.isfile(args.test_csv):
            parser.error("--expect-published requires an existing --test-csv")
        for name, entry in report["checkpoints"].items():
            if not entry:
                ok = False
                continue
            acc = _accuracy_check(entry["path"], args.test_csv, args.tolerance,
                                  device)
            report["accuracy"][name] = acc
            ok &= acc["delta1_ok"] and acc["rel_ok"]
            print(f"[{'ok' if acc['delta1_ok'] and acc['rel_ok'] else 'FAIL':^7}]"
                  f" {name}: δ1 {acc['delta1']:.3f} (pub {acc['published_delta1']})"
                  f" REL {acc['rel']:.3f} (pub {acc['published_rel']})")

    report["ok"] = bool(ok)
    with open(args.report, "w") as f:
        json.dump(report, f, indent=2)
    print(f"report -> {args.report} (ok={ok})")
    if not ok:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
