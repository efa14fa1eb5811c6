"""End-to-end rehearsal of the PyTorch port: the reference workflow as one
run, on the card.

The port's counterpart of ``scripts/run_e2e.py``, with its phases and
defaults; every phase runs an entry point of ``efficientdepthestimation_tpu_torch``
in a subprocess (``python -m``, or its ``main`` through ``python -c`` where
the script reads its results), with ``--device`` passed through to each
CLI that takes one:

  0. generate the synthetic NYU dataset (``data.synthetic_nyu``) if absent;
  1. train ENB0-HU (20 epochs, Adam 1e-4, wd 1e-4, StepLR(5, 0.1), batch 8,
     ``--cache-ram``, best-by-abs_rel), send a real ``SIGTERM`` once 5
     epochs are logged, then resume from the rolling train state;
  2. the same for ENB0-LR (``--watch-every 0``), then a 3-epoch
     ``--freeze-encoder --init-from`` fine-tune from its best checkpoint;
     a random-weights ENB0-HU entrant (``models.common.randomize_``, seed
     999);
  3. ``apps.evaluate`` of the best HU checkpoint at batch 1 and 4;
  4. ``apps.test_nyu`` over both staged checkpoints;
  5. ``apps.inference_benchmark --bf16`` over both;
  6. ``benchmark.harness``: both trained models, random weights and flat,
     visual metrics with stand-in LPIPS weights converted by
     ``checkpoints.lpips_convert`` (its plots left out where matplotlib
     does not import);
  7. ``mturk.collect_study_materials``;
  8. the report: ``E2E_torch.md``, ``trajectory_torch.json`` and
     ``timings_torch.json`` in ``--out`` (``e2e/torch/``), the JAX package's
     record (``e2e/E2E.md``, ``e2e/trajectory.json``, ``e2e/timings.json``,
     ``e2e/nyu*.csv``) beside the port's numbers.

The script never writes under ``e2e/`` outside ``--out``; the trained
checkpoints stay in ``--work-dir``. It imports no JAX. Without a CUDA card
it raises before phase 0 unless ``--device cpu`` asks for the CPU.

    python scripts/run_e2e_torch.py                  # the full run, on the card
    python scripts/run_e2e_torch.py --device cpu --n-train 8 --n-test 4 \\
        --epochs 3 --preempt-after-epochs 1 --freeze-epochs 1 \\
        --bench-samples 1 --batch-size 4 --poll-seconds 0.5 \\
        --out /tmp/e2e_out --work-dir /tmp/e2e_work --data-dir /tmp/e2e_data
"""

from __future__ import annotations

import argparse
import csv as csv_mod
import datetime
import glob
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# run as a script, sys.path[0] is scripts/: the port is imported from the
# repo root, and the subprocesses find it there through PYTHONPATH
if REPO not in sys.path:
    sys.path.insert(0, REPO)

PKG = "efficientdepthestimation_tpu_torch"
JAX_RECORD = os.path.join(REPO, "e2e")
HU_NAME, LR_NAME = "reside_enb0_hu_trained", "midas_enb0_lr_trained"
RANDOM_NAME = "reside_enb0_random"
# apps.evaluate through its own main, printing its results in full
# precision: the progress line rounds them to 3 decimals
EVALUATE = ("import json, sys\n"
            f"from {PKG}.apps.evaluate import main\n"
            "tracker, edges = main(sys.argv[1:])\n"
            "print('EVALUATE ' + json.dumps({**tracker.to_dict(), **edges}))\n")

# benchmark.harness through its own main, its plots left out where
# matplotlib does not import (the card's machine has none): the tables,
# depth maps, renders and grids are unchanged
HARNESS = ("import sys\n"
           f"from {PKG}.benchmark import harness\n"
           "try:\n"
           "    import matplotlib\n"
           "except ImportError:\n"
           "    print('PLOTS LEFT OUT: matplotlib does not import')\n"
           "    harness.visualise_results = lambda *args: None\n"
           "harness.main(sys.argv[1:])\n")


def log(msg):
    print(f"[e2e-torch {datetime.datetime.now():%H:%M:%S}] {msg}", flush=True)


def child_env(**extra) -> dict:
    """The subprocesses' environment: the port importable from the repo
    root, and the run logger's local ``log.jsonl`` (which the preemption
    poll reads) rather than wandb."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, WANDB_MODE="disabled",
                PYTHONPATH=REPO + (os.pathsep + path if path else ""),
                **extra)


def run(cmd, work_dir, log_path=None, env=None) -> str:
    """``cmd`` from ``work_dir``; returns its output, kept in ``log_path``
    too when given. Raises with the output's tail if it fails."""
    log("$ " + " ".join(cmd))
    out = subprocess.run(cmd, cwd=work_dir, env=env or child_env(),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if log_path:
        with open(log_path, "w") as f:
            f.write(out.stdout)
    if out.returncode:
        raise RuntimeError(f"{' '.join(cmd)[:200]} exited {out.returncode}:"
                           f"\n{out.stdout[-4000:]}")
    return out.stdout


def run_dirs(work_dir: str) -> set[str]:
    return {d for d in glob.glob(os.path.join(work_dir, "runs", "*"))
            if os.path.isdir(d)}


def new_run_dir(work_dir: str, before: set[str]) -> str:
    """The run directory a train run made, none of ``before``."""
    dirs = run_dirs(work_dir) - before
    if not dirs:
        raise RuntimeError(f"no run directory made under {work_dir}/runs")
    return max(dirs, key=os.path.getmtime)


def read_log(run_dir: str) -> list[dict]:
    path = os.path.join(run_dir, "log.jsonl")
    if not os.path.isfile(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def best_ckpt_in(run_dir: str) -> str:
    ckpts = [p for p in glob.glob(os.path.join(run_dir, "*.ede"))
             if not p.endswith("train_state.ede")]
    if not ckpts:
        raise RuntimeError(f"no best checkpoint in {run_dir}")
    return ckpts[0]


def card_name(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    if not device.startswith("cuda"):
        return "the CPU (no card)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "card not named by nvidia-smi"
    except (OSError, subprocess.SubprocessError):
        import torch

        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def make_standin_lpips(out_npz: str):
    """Stand-in AlexNet + LPIPS weights (the official files cannot be
    fetched here) through the port's converter, drawn as ``run_e2e.py``
    draws them."""
    import numpy as np
    import torch

    from efficientdepthestimation_tpu_torch.checkpoints.lpips_convert import (
        convert,
    )

    shapes = {0: (64, 3, 11), 3: (192, 64, 5), 6: (384, 192, 3),
              8: (256, 384, 3), 10: (256, 256, 3)}
    rng = np.random.default_rng(0)
    alex, chans = {}, []
    for idx, (cout, cin, k) in shapes.items():
        alex[f"features.{idx}.weight"] = torch.from_numpy(
            rng.standard_normal((cout, cin, k, k)).astype(np.float32) * 0.05)
        alex[f"features.{idx}.bias"] = torch.from_numpy(
            rng.standard_normal(cout).astype(np.float32) * 0.05)
        chans.append(cout)
    heads = {f"lin{i}.model.1.weight": torch.from_numpy(
        np.abs(rng.standard_normal((1, c, 1, 1))).astype(np.float32))
        for i, c in enumerate(chans)}
    tmp = os.path.join(os.path.dirname(out_npz), "_lpips_src")
    os.makedirs(tmp, exist_ok=True)
    torch.save(alex, os.path.join(tmp, "alexnet.pth"))
    torch.save(heads, os.path.join(tmp, "alex.pth"))
    convert(os.path.join(tmp, "alexnet.pth"), os.path.join(tmp, "alex.pth"),
            out_npz)


def save_random_entrant(path: str):
    """The random-weights entrant (benchmark.py:551-553): the port's ENB0-HU
    with ``randomize_`` weights, seed 999, written as a ``.ede``."""
    from efficientdepthestimation_tpu_torch.checkpoints.serialization import (
        save_checkpoint,
    )
    from efficientdepthestimation_tpu_torch.models.common import randomize_
    from efficientdepthestimation_tpu_torch.models.registry import build_model

    os.makedirs(os.path.dirname(path), exist_ok=True)
    model = randomize_(build_model("efficientnet-b0", "hu2018"), 999)
    save_checkpoint(path, model, encoder="efficientnet-b0", decoder="hu2018")


def train_with_preemption(args, py, timings, tag, train_flags):
    """Train with a real SIGTERM once ``--preempt-after-epochs`` epochs are
    logged, then resume from the rolling train state to the end.

    Returns ``(trajectory, run_dir_a, run_dir_b, best_ckpt, notes)``, the
    notes the preemption and resume lines the two runs printed.
    """
    cmd = [py, "-m", f"{PKG}.apps.train"] + train_flags
    t0, before = time.time(), run_dirs(args.work_dir)
    train_log_a = os.path.join(args.work_dir, f"train_{tag}_a.log")
    with open(train_log_a, "w") as log_f:
        # the output goes to a file: a pipe left undrained fills within the
        # first epoch's progress lines and blocks the child
        log("$ " + " ".join(cmd))
        proc = subprocess.Popen(cmd, cwd=args.work_dir, env=child_env(),
                                stdout=log_f, stderr=subprocess.STDOUT,
                                text=True)
        log(f"[{tag}] train launched (pid {proc.pid}); SIGTERM once "
            f"{args.preempt_after_epochs} epochs are logged")
        run_dir_a = None
        while proc.poll() is None:
            time.sleep(args.poll_seconds)
            try:
                run_dir_a = new_run_dir(args.work_dir, before)
            except RuntimeError:  # not made yet
                continue
            if len(read_log(run_dir_a)) >= args.preempt_after_epochs:
                # lands mid-epoch, not at the boundary
                time.sleep(args.poll_seconds * 0.6)
                proc.send_signal(signal.SIGTERM)
                log(f"[{tag}] {args.preempt_after_epochs} epochs logged: "
                    "SIGTERM sent")
                break
        proc.wait()
    with open(train_log_a) as f:
        stdout_a = f.read()
    preempted = re.findall(r"Preempted at epoch \d+[^\n]*", stdout_a)
    if proc.returncode or run_dir_a is None or not preempted:
        raise RuntimeError(
            f"[{tag}] run A (exit {proc.returncode}) was not preempted: it "
            f"must still be training when {args.preempt_after_epochs} epochs "
            f"are logged (raise --epochs):\n{stdout_a[-3000:]}")
    rolling = os.path.join(run_dir_a, "train_state.ede")
    timings[f"1_{tag}_train_until_preempt"] = time.time() - t0
    log(f"[{tag}] {preempted[0]}")

    t0, before = time.time(), run_dirs(args.work_dir)
    out_b = run(cmd + ["--resume", rolling], args.work_dir,
                os.path.join(args.work_dir, f"train_{tag}_b.log"))
    run_dir_b = new_run_dir(args.work_dir, before)
    timings[f"2_{tag}_train_resumed"] = time.time() - t0
    trajectory = read_log(run_dir_a) + read_log(run_dir_b)
    notes = preempted[:1] + re.findall(r"Resumed from [^\n]*", out_b)[:1]
    return (trajectory, run_dir_a, run_dir_b, best_ckpt_in(run_dir_b), notes)


def parse_args(argv=None):
    work = os.path.join(REPO, "runs", "e2e_torch")
    parser = argparse.ArgumentParser(description="E2E rehearsal of the port")
    parser.add_argument("--data-dir", default=os.path.join(work, "data"))
    parser.add_argument("--work-dir", default=os.path.join(work, "work"))
    parser.add_argument("--out", default=os.path.join(JAX_RECORD, "torch"))
    parser.add_argument("--device", default=None,
                        help="torch device of every phase (default: the "
                             "CUDA card, which must be present; 'cpu' runs "
                             "the kernels' plain versions)")
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--freeze-epochs", type=int, default=3,
                        help="length of the LR frozen-encoder fine-tune")
    parser.add_argument("--n-train", type=int, default=1500)
    parser.add_argument("--n-test", type=int, default=150)
    parser.add_argument("--hw", type=int, nargs=2, default=(480, 640),
                        help="frame size of the generated dataset")
    parser.add_argument("--batch-size", type=int, default=8,
                        help="training batch (the recipe's 8)")
    parser.add_argument("--crop-hw", type=int, nargs=2, default=(228, 304),
                        help="the training runs' crop (the train CLI's "
                             "--crop-hw)")
    parser.add_argument("--bench-samples", type=int, default=25,
                        help="test subset for the render-heavy benchmark")
    parser.add_argument("--renderer-fps", type=int, default=60,
                        help="the benchmark harness's --renderer-fps")
    parser.add_argument("--preempt-after-epochs", type=int, default=5,
                        help="SIGTERM each train run after this many "
                             "epoch log entries")
    parser.add_argument("--poll-seconds", type=float, default=5.0,
                        help="how often the epoch log is read")
    parser.add_argument("--skip-hu-train", action="store_true",
                        help="take the JAX package's trained HU artifact "
                             "(e2e/ENB0-HU-synthetic.ede, read only) and "
                             "its trajectory instead of training HU")
    parser.add_argument("--reuse-train", action="store_true",
                        help="skip the training phases, reusing the staged "
                             "checkpoints and train_meta.json a previous "
                             "run left in --work-dir")
    args = parser.parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)
    return args


def main(argv=None):
    args = parse_args(argv)
    from efficientdepthestimation_tpu_torch.apps.common import resolve_device

    device = str(resolve_device(args.device))
    args.data_dir, args.work_dir, args.out = (
        os.path.abspath(p) for p in (args.data_dir, args.work_dir, args.out))
    py = sys.executable
    os.makedirs(args.work_dir, exist_ok=True)
    os.makedirs(args.out, exist_ok=True)
    timings: dict[str, float] = {}
    t_all = time.time()

    # ---------------------------------------------------------------- 0 data
    train_csv = os.path.join(args.data_dir, "train.csv")
    test_csv = os.path.join(args.data_dir, "test.csv")
    t0 = time.time()
    if not (os.path.isfile(train_csv) and os.path.isfile(test_csv)):
        run([py, "-m", f"{PKG}.data.synthetic_nyu", "--out", args.data_dir,
             "--train", str(args.n_train), "--test", str(args.n_test),
             "--hw", *map(str, args.hw)], args.work_dir)
    timings["0_dataset"] = time.time() - t0

    staged = os.path.join(args.work_dir, "checkpoints")
    os.makedirs(staged, exist_ok=True)
    hu_path = os.path.join(staged, "ENB0-HU.ede")
    lr_path = os.path.join(staged, "ENB0-LR.ede")
    random_path = os.path.join(args.work_dir, "random_ckpt", "ENB0-HU.ede")
    meta_path = os.path.join(args.work_dir, "train_meta.json")

    if args.reuse_train:
        missing = [p for p in (hu_path, lr_path, random_path, meta_path)
                   if not os.path.isfile(p)]
        if missing:
            raise SystemExit(f"--reuse-train: {missing} missing")
        with open(meta_path) as f:
            meta = json.load(f)
        log("reusing the train artifacts in " + args.work_dir)
    else:
        meta = train_phases(args, py, device, timings, train_csv, test_csv,
                            hu_path, lr_path, random_path)
        with open(meta_path, "w") as f:
            json.dump(meta, f, indent=2)
    downstream(args, py, device, timings, t_all, test_csv, meta, staged,
               hu_path, lr_path, random_path)


def train_phases(args, py, device, timings, train_csv, test_csv, hu_path,
                 lr_path, random_path) -> dict:
    base_flags = [
        "--encoder", "efficientnet-b0", "--epochs", str(args.epochs),
        "--train-csv", train_csv, "--test-csv", test_csv,
        "--per-device-batch", str(args.batch_size), "--cache-ram",
        "--crop-hw", *map(str, args.crop_hw), "--device", device,
    ]
    notes = {}
    # ------------------------------------------- 1 ENB0-HU train + SIGTERM
    if args.skip_hu_train:
        shutil.copyfile(os.path.join(JAX_RECORD, "ENB0-HU-synthetic.ede"),
                        hu_path)
        with open(os.path.join(JAX_RECORD, "trajectory.json")) as f:
            hu_traj = json.load(f)["hu"]
        hu_dirs = ["the JAX package's trained artifact "
                   "(e2e/ENB0-HU-synthetic.ede, e2e/trajectory.json)"]
        log("HU: the JAX package's trained artifact (--skip-hu-train)")
    else:
        hu_traj, hu_a, hu_b, hu_best, notes["hu"] = train_with_preemption(
            args, py, timings, "hu", base_flags + ["--decoder", "hu2018"])
        shutil.copyfile(hu_best, hu_path)
        hu_dirs = [os.path.basename(hu_a), os.path.basename(hu_b)]

    # ------------------------------------------- 2 ENB0-LR train + SIGTERM
    lr_flags = base_flags + ["--decoder", "lasinger2019",
                             "--watch-every", "0"]
    lr_traj, lr_a, lr_b, lr_best, notes["lr"] = train_with_preemption(
        args, py, timings, "lr", lr_flags)

    # the frozen-encoder decoder-only fine-tune from the best LR checkpoint
    # (Encoder(freeze_weights=True), lasinger2019.py:36-38)
    t0, before = time.time(), run_dirs(args.work_dir)
    run([py, "-m", f"{PKG}.apps.train"] + lr_flags
        + ["--epochs", str(args.freeze_epochs), "--init-from", lr_best,
           "--freeze-encoder"], args.work_dir,
        os.path.join(args.work_dir, "train_lr_freeze.log"))
    ft_dir = new_run_dir(args.work_dir, before)
    ft_traj = read_log(ft_dir)
    timings["2b_lr_freeze_finetune"] = time.time() - t0
    # stage whichever run reached the lower abs_rel
    ft_best_rel = min(r["abs_rel"] for r in ft_traj)
    lr_best_rel = min(r["abs_rel"] for r in lr_traj)
    staged_from = "freeze-finetune" if ft_best_rel < lr_best_rel else "main"
    shutil.copyfile(best_ckpt_in(ft_dir) if ft_best_rel < lr_best_rel
                    else lr_best, lr_path)
    log(f"[lr] staged the best of the {staged_from} run (abs_rel "
        f"{min(ft_best_rel, lr_best_rel):.4f})")

    t0 = time.time()
    save_random_entrant(random_path)
    timings["2c_random_entrant"] = time.time() - t0
    return {
        "trajectories": {"hu": hu_traj, "lr": lr_traj, "lr_freeze": ft_traj},
        "run_dirs": {"hu": hu_dirs,
                     "lr": [os.path.basename(lr_a), os.path.basename(lr_b)],
                     "lr_freeze": [os.path.basename(ft_dir)]},
        "notes": notes, "lr_staged_from": staged_from,
        "hu_from_jax": bool(args.skip_hu_train),
    }


def downstream(args, py, device, timings, t_all, test_csv, meta, staged,
               hu_path, lr_path, random_path):
    work = args.work_dir
    # ---------------------------------------------------------- 3 evaluate
    t0 = time.time()
    evals = {}
    for bs in (1, 4):
        out = run([py, "-c", EVALUATE, "--model", hu_path, "--test-csv",
                   test_csv, "--batch-size", str(bs), "--device", device],
                  work, os.path.join(work, f"evaluate_b{bs}.log"))
        lines = out.replace("\r", "\n").strip().splitlines()
        evals[bs] = {
            "tail": [ln for ln in lines if not ln.startswith("EVALUATE ")
                     ][-6:],
            "metrics": json.loads(next(ln for ln in lines if ln.startswith(
                "EVALUATE ")).removeprefix("EVALUATE "))}
    timings["3_evaluate"] = time.time() - t0

    # ------------------------------------------ 4 test_nyu (both models)
    t0 = time.time()
    nyu_out = os.path.join(work, "nyu_depth_out")
    run([py, "-m", f"{PKG}.apps.test_nyu", "-c", staged, "--test-csv",
         test_csv, "-o", nyu_out, "-b", "8", "--device", device], work,
        os.path.join(work, "test_nyu.log"))
    timings["4_test_nyu"] = time.time() - t0

    # ------------------------------- 5 inference_benchmark (both models)
    t0 = time.time()
    ib_out = os.path.join(work, "inference_benchmark")
    os.makedirs(ib_out, exist_ok=True)
    frames_dir = os.path.join(args.data_dir, "test", "images")
    run([py, "-m", f"{PKG}.apps.inference_benchmark", "-c", staged, "-f",
         frames_dir, "-n", "3", "-b", "8", "-o", ib_out, "--bf16",
         "--device", device], work,
        os.path.join(work, "inference_benchmark.log"))
    timings["5_inference_benchmark"] = time.time() - t0

    # ------------------------------------------------------- 6 benchmark
    t0 = time.time()
    bench_csv = os.path.join(work, "bench.csv")
    with open(test_csv) as f_in, open(bench_csv, "w", newline="") as f_out:
        rows = list(csv_mod.reader(f_in))[: args.bench_samples]
        csv_mod.writer(f_out).writerows(rows)
    lpips_npz = os.path.join(work, "lpips_alex.npz")
    make_standin_lpips(lpips_npz)
    bench_out = os.path.join(work, "benchmark_out")
    bench_log = os.path.join(work, "benchmark.log")
    out = run([py, "-c", HARNESS, "--csv-path", bench_csv,
         "--output-path", bench_out, "--batch-size", "4",
         "--renderer-fps", str(args.renderer_fps),
         "--models", f"{HU_NAME}={hu_path}", f"{LR_NAME}={lr_path}",
         f"{RANDOM_NAME}={random_path}", "--baseline-model", HU_NAME,
         "--device", device], work, bench_log,
        env=child_env(LPIPS_ALEX_WEIGHTS=lpips_npz))
    plots = "PLOTS LEFT OUT" not in out
    timings["6_benchmark"] = time.time() - t0

    # ------------------------------------------- 7 study materials (MTurk)
    t0 = time.time()
    study_out = os.path.join(work, "study_material")
    # the script reads <dataset>/nyu2_test.csv and indexes the renders by
    # that csv's rows: the benchmark subset under that name
    study_data = os.path.join(work, "studydata")
    os.makedirs(study_data, exist_ok=True)
    shutil.copyfile(bench_csv, os.path.join(study_data, "nyu2_test.csv"))
    run([py, "-m", f"{PKG}.mturk.collect_study_materials",
         "--benchmark-path", os.path.join(bench_out, "nyu"),
         "--nyu-dataset-path", study_data, "--output-path", study_out,
         "--max-videos", "4", "--selection-interval", "6",
         "--model-selection", HU_NAME, LR_NAME, "flat"], work,
        os.path.join(work, "study_materials.log"))
    timings["7_study_materials"] = time.time() - t0
    timings["total"] = time.time() - t_all

    # ---------------------------------------------------------- 8 report
    write_report(args, device, meta, evals, ib_out, bench_out, nyu_out,
                 study_out, timings, plots)
    log("E2E complete: " + " ".join(f"{k}={v:.1f}s"
                                    for k, v in timings.items()))


# ----------------------------------------------------------------- report


def read_table(path: str) -> dict[str, dict]:
    """model -> column -> float (None where empty), from a harness CSV."""
    with open(path) as f:
        rows = list(csv_mod.reader(f))
    header = rows[0]
    return {row[0]: {header[i]: (float(row[i]) if row[i] else None)
                     for i in range(1, len(row))} for row in rows[1:]}


def jax_blocks(heading: str) -> list[list[str]]:
    """The fenced blocks of ``e2e/E2E.md``'s section ``heading``."""
    with open(os.path.join(JAX_RECORD, "E2E.md")) as f:
        text = f.read()
    start = text.find(heading)
    if start < 0:
        return []
    end = text.find("\n## ", start + len(heading))
    section = text[start:end if end > 0 else None]
    return [block.strip("\n").splitlines()
            for block in section.split("```")[1::2]]


def evaluate_summary(lines: list[str]) -> dict[str, float]:
    """The last progress line's metrics and the edge lines, as printed."""
    out = {}
    progress = [ln for ln in lines if ln.startswith("Progress")]
    if progress:
        for key, value in re.findall(r"([A-Z0-9_]+): ([-0-9.]+)",
                                     progress[-1].split("]", 1)[1]):
            out[key.lower()] = float(value)
    for ln in lines:
        parts = ln.split()
        if len(parts) == 2 and parts[0] in ("AV", "PV", "RV", "FV"):
            out[parts[0]] = float(parts[1])
    return out


def fmt(v, spec=".4f"):
    return "—" if v is None or (isinstance(v, float) and math.isnan(v)) \
        else f"{v:{spec}}"


def trajectory_section(w, title, traj, jax_traj, run_dirs, notes=(),
                       note=""):
    w(f"### {title}\n")
    if note:
        w(note + "\n")
    w("| epoch | loss | abs_rel | δ1 | RMSE | JAX loss | JAX abs_rel | "
      "JAX δ1 | JAX RMSE |")
    w("|---|---|---|---|---|---|---|---|---|")
    for i in range(max(len(traj), len(jax_traj))):
        row = traj[i] if i < len(traj) else {}
        ref = jax_traj[i] if i < len(jax_traj) else {}
        w(f"| {i} | " + " | ".join(fmt(r.get(k)) for r in (row, ref)
                                   for k in ("loss", "abs_rel", "delta1",
                                             "rmse")) + " |")
    w("")
    for name, rows in (("port", traj), ("JAX", jax_traj)):
        rels = [r["abs_rel"] for r in rows]
        if not rels:
            continue
        best = min(range(len(rels)), key=rels.__getitem__)
        w(f"- {name}: abs_rel epoch 0 → best **{rels[0]:.4f} → "
          f"{rels[best]:.4f}** (epoch {best} of {len(rels) - 1}); falls "
          f"across training: **{rels[-1] < rels[0]}**")
    for line in notes:
        w(f"- `{line}`")
    if len(run_dirs) == 2:
        w(f"- run A `{run_dirs[0]}` (a real SIGTERM mid-run, the exact "
          f"train state saved); run B `{run_dirs[1]}` (resumed)")
    else:
        w(f"- run: {run_dirs[0]}")
    w("")


def write_report(args, device, meta, evals, ib_out, bench_out, nyu_out,
                 study_out, timings, plots):
    card = card_name(device)
    with open(os.path.join(JAX_RECORD, "trajectory.json")) as f:
        jax_trajs = json.load(f)
    with open(os.path.join(JAX_RECORD, "timings.json")) as f:
        jax_timings = json.load(f)
    lines = []
    w = lines.append
    w("# E2E rehearsal of the PyTorch port — the reference workflow on the "
      "card\n")
    w(f"Date: {datetime.datetime.now():%Y-%m-%d %H:%M}. One command: "
      f"`{' '.join(['python scripts/run_e2e_torch.py', *args.argv])}`, "
      f"device `{device}`: **{card}**. Every time below was taken there.\n")
    w(f"Dataset: synthetic NYU (`{PKG}/data/synthetic_nyu.py`), "
      f"{args.n_train} train / {args.n_test} test {args.hw[0]}×{args.hw[1]} "
      "pairs. Recipe (both decoders): EfficientNet-B0, "
      f"{args.epochs} epochs, Adam 1e-4, wd 1e-4, StepLR(5, 0.1), batch "
      f"{args.batch_size}, `--cache-ram`, best-by-abs_rel; a real SIGTERM "
      f"once {args.preempt_after_epochs} epochs are logged, then `--resume`; "
      f"the LR fine-tune `--freeze-encoder --init-from` for "
      f"{args.freeze_epochs} epochs; {args.bench_samples} benchmark "
      "samples. The JAX columns are the JAX package's TPU record "
      "(`e2e/E2E.md`, `e2e/trajectory.json`, `e2e/timings.json`, "
      "`e2e/nyu*.csv`), read as data: another device, another run.\n")
    if meta.get("hu_from_jax"):
        w("**`--skip-hu-train`: the HU checkpoint and trajectory below are "
          "the JAX package's (`e2e/ENB0-HU-synthetic.ede`), not a port "
          "run.**\n")

    w("## Epoch trajectories\n")
    trajs, dirs, notes = (meta["trajectories"], meta["run_dirs"],
                          meta.get("notes", {}))
    trajectory_section(w, "ENB0-HU (hu2018 decoder)", trajs["hu"],
                       jax_trajs["hu"], dirs["hu"], notes.get("hu", ()))
    trajectory_section(w, "ENB0-LR (lasinger2019 decoder)", trajs["lr"],
                       jax_trajs["lr"], dirs["lr"], notes.get("lr", ()))
    trajectory_section(
        w, f"ENB0-LR frozen-encoder fine-tune ({args.freeze_epochs} epochs)",
        trajs["lr_freeze"], jax_trajs["lr_freeze"], dirs["lr_freeze"],
        note="`--init-from <best LR> --freeze-encoder`: decoder-only Adam.")
    w(f"- the staged ENB0-LR.ede is the best of the "
      f"**{meta['lr_staged_from']}** run\n")

    w("## Evaluation (apps.evaluate, edge metrics, batch 1 and 4)\n")
    jax_evals = jax_blocks("## Evaluation")
    for i, bs in enumerate(evals):
        w(f"batch_size={bs}, the port:\n```")
        lines.extend(evals[bs]["tail"])
        w("```")
        if i < len(jax_evals):
            w(f"batch_size={bs}, JAX:\n```")
            lines.extend(jax_evals[i][-6:])
            w("```")
    m1, m4 = evals[1]["metrics"], evals[4]["metrics"]
    rel = {k: abs(m1[k] - m4[k]) / max(abs(m1[k]), 1e-12) for k in m1}
    w("\nBatch 1 against batch 4, the port, relative: "
      + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
      + ". LOG10 is the reference's batch-dependent metric (`e2e/E2E.md`); "
      "every other agrees within 1e-3: **"
      f"{all(v <= 1e-3 for k, v in rel.items() if k != 'log10')}**\n")

    w("## Inference benchmark (apps.inference_benchmark, bf16, b8, 3 "
      "trials)\n")
    for name in sorted(os.listdir(ib_out)):
        if name.endswith(".csv"):
            with open(os.path.join(ib_out, name)) as f:
                w(f"The port, `{name}`:\n```\n{f.read().strip()}\n```")
    for block in jax_blocks("## Inference benchmark")[:1]:
        w("JAX:\n```")
        lines.extend(block)
        w("```")

    w("\n## Full benchmark (harness: renders, depth, visual metrics)\n")
    if not plots:
        w("The harness's plots (`visualise_results`) were left out: "
          "matplotlib does not import on this machine. Its tables, depth "
          "maps, renders and grids are all here.\n")
    for name in ("nyu.csv", "nyu-relative.csv"):
        for who, root in (("The port", bench_out), ("JAX", JAX_RECORD)):
            path = os.path.join(root, name)
            if os.path.isfile(path):
                with open(path) as f:
                    w(f"{who}, `{name}`:\n```\n{f.read().strip()}\n```")
    table = read_table(os.path.join(bench_out, "nyu.csv"))
    jax_table = read_table(os.path.join(JAX_RECORD, "nyu.csv"))
    w("\n### Ranking (absolute; abs_rel is the recipe's selection "
      "metric)\n")
    w("| model | abs_rel ↓ | SSIM ↑ | LPIPS ↓ | MIFD ↓ | δ1 | JAX abs_rel "
      "| JAX SSIM | JAX LPIPS |")
    w("|---|---|---|---|---|---|---|---|---|")
    for name, row in sorted(table.items(),
                            key=lambda kv: kv[1].get("abs_rel") or 1e9):
        ref = jax_table.get(name, {})
        w(f"| {name} | " + " | ".join(
            [fmt(row.get(k)) for k in ("abs_rel", "ssim", "lpips", "mifd",
                                       "delta1")]
            + [fmt(ref.get(k)) for k in ("abs_rel", "ssim", "lpips")])
          + " |")
    checks = []
    for trained in (HU_NAME, LR_NAME):
        for baseline in (RANDOM_NAME, "flat"):
            t, b = table[trained], table[baseline]
            ok = t["abs_rel"] < b["abs_rel"]
            checks.append(ok)
            visual = t["ssim"] > b["ssim"] and t["lpips"] < b["lpips"]
            w(f"- {trained} below {baseline} on abs_rel: **{ok}**; also "
              f"on SSIM and LPIPS: {visual}")
    w(f"- both trained models below random weights and flat on abs_rel: "
      f"**{all(checks)}**")
    w("- δ1 is no gate: a near-constant depth (random weights) lands "
      "within the 1.25× band of the synthetic rooms' narrow range (JAX: "
      "δ1 = 1.0 at abs_rel 1.00).")
    w("- The random-weights entrant is the port's `randomize_` (seed 999), "
      "not JAX's `init_variables`: its weights, and so its row, differ "
      "from JAX's by construction.\n")

    w("## Phase wall times\n")
    w(f"Seconds, the port on **{card}**; JAX on its TPU host "
      "(`e2e/timings.json`, a `--reuse-train` run: no training "
      "phases).\n")
    w("| phase | the port, s | JAX, s |")
    w("|---|---|---|")
    for key in list(timings) + [k for k in jax_timings if k not in timings]:
        w(f"| {key} | {fmt(timings.get(key), '.1f')} | "
          f"{fmt(jax_timings.get(key), '.1f')} |")
    w("")
    w("## Outputs\n")
    for label, root in (("test_nyu", nyu_out), ("benchmark", bench_out),
                        ("study materials", study_out)):
        n = sum(len(files) for _, _, files in os.walk(root))
        w(f"- {label}: {n} files (in the run's work directory)")
    out_md = os.path.join(args.out, "E2E_torch.md")
    with open(out_md, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(args.out, "trajectory_torch.json"), "w") as f:
        json.dump(meta["trajectories"], f, indent=2)
    with open(os.path.join(args.out, "timings_torch.json"), "w") as f:
        json.dump({"card": card, **timings}, f, indent=2)
    log(f"wrote {out_md}")


if __name__ == "__main__":
    main()
