"""Generate MTurk study stimuli: the counterpart of
MTurk/collect_study_materials.py and of
``efficientdepthestimation_tpu/mturk/collect_study_materials.py``.

Selects benchmark render videos (interval or explicit selection), pairs each
model with the ground truth, composes side-by-side videos (cv2, replacing the
reference's ffmpeg subprocess), generates S3 URLs and renders the HIT HTML
template via jinja2.
"""

from __future__ import annotations

import argparse
import datetime
import os
import shutil
from typing import List, Optional

DEFAULT_MODEL_SELECTION = ["reside_enb0-random_weights", "flat", "reside_enb0",
                           "reside_senet"]

_TEMPLATE = """<!DOCTYPE html>
<html>
<head><meta charset="utf-8"><title>Depth Quality Study</title></head>
<body>
<h2>Rate the quality of the right-hand video compared to the left</h2>
{% for url in video_urls %}
<div class="task">
  <video src="{{ url }}" controls loop muted></video>
  <crowd-radio-group name="rating">
    {% for label in ratings %}<crowd-radio-button value="{{ label }}">{{ label }}</crowd-radio-button>{% endfor %}
  </crowd-radio-group>
</div>
{% endfor %}
</body>
</html>
"""


def log(msg):
    print(f"[{datetime.datetime.now()}] {msg}")


def side_by_side_video(left_path: str, right_path: str, output_path: str) -> None:
    """Compose two videos horizontally (replaces the ffmpeg hstack call)."""
    import cv2
    import numpy as np

    cap_l = cv2.VideoCapture(left_path)
    cap_r = cv2.VideoCapture(right_path)
    fps = cap_l.get(cv2.CAP_PROP_FPS) or 30.0
    writer = None
    while True:
        ok_l, frame_l = cap_l.read()
        ok_r, frame_r = cap_r.read()
        if not (ok_l and ok_r):
            break
        if frame_l.shape != frame_r.shape:
            frame_r = cv2.resize(frame_r, (frame_l.shape[1], frame_l.shape[0]))
        frame = np.hstack([frame_l, frame_r])
        if writer is None:
            writer = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                     fps, (frame.shape[1], frame.shape[0]))
        writer.write(frame)
    if writer is not None:
        writer.release()
    cap_l.release()
    cap_r.release()


def main(args: Optional[List[str]] = None):
    import pandas as pd

    parser = argparse.ArgumentParser(description="Collect MTurk study materials")
    parser.add_argument("--benchmark-path", default="benchmark/nyu")
    parser.add_argument("--nyu-dataset-path", default="data/datasets/nyuv2/")
    parser.add_argument("--output-path", default="benchmark/study_material")
    parser.add_argument("--selection-interval", default=30, type=int)
    parser.add_argument("--max-videos", default=20, type=int)
    parser.add_argument("--s3-bucket-url", default="https://bucket.s3.amazonaws.com")
    parser.add_argument("--model-selection", nargs="*",
                        default=DEFAULT_MODEL_SELECTION)
    parser.add_argument("video_selection", nargs="*", type=int)
    args = parser.parse_args(args)

    nyu_test_csv = os.path.join(args.nyu_dataset_path, "nyu2_test.csv")
    nyu_files = pd.read_csv(nyu_test_csv, header=None)
    if args.video_selection:
        selected = nyu_files.iloc[list(args.video_selection)]
        indices = list(args.video_selection)
    else:
        selected = nyu_files.iloc[::args.selection_interval][:args.max_videos]
        indices = list(selected.index)
    log(f"Selected {len(selected)} samples: {indices}")

    models = [m for m in sorted(os.listdir(args.benchmark_path))
              if os.path.isdir(os.path.join(args.benchmark_path, m))
              and m != "ground_truth"]
    models = sorted(set(args.model_selection) & set(models)) or models
    log(f"Models: {models}")

    source_dir = os.path.join(args.output_path, "source")
    pairs_dir = os.path.join(args.output_path, "pairs")
    os.makedirs(pairs_dir, exist_ok=True)

    # 1-2: copy the selected videos per model (+ ground truth)
    for model in models + ["ground_truth"]:
        video_dir = os.path.join(
            args.benchmark_path, model,
            "rendered_images" if model != "ground_truth" else "", "video")
        video_dir = os.path.normpath(video_dir)
        out_dir = os.path.join(source_dir, model)
        os.makedirs(out_dir, exist_ok=True)
        for idx in indices:
            src = os.path.join(video_dir, f"{idx:06d}.avi")
            if os.path.isfile(src):
                shutil.copy(src, os.path.join(out_dir, f"{idx:06d}.avi"))

    # 3: side-by-side GT|model videos
    video_urls = []
    for model in models:
        model_pairs = os.path.join(pairs_dir, model)
        os.makedirs(model_pairs, exist_ok=True)
        for idx in indices:
            gt = os.path.join(source_dir, "ground_truth", f"{idx:06d}.avi")
            mv = os.path.join(source_dir, model, f"{idx:06d}.avi")
            if not (os.path.isfile(gt) and os.path.isfile(mv)):
                continue
            out = os.path.join(model_pairs, f"{idx:06d}.mp4")
            side_by_side_video(gt, mv, out)
            # 4: S3 URL convention `<bucket>/<model>/<frame>.mp4`
            video_urls.append(f"{args.s3_bucket_url}/{model}/{idx:06d}.mp4")

    # 5: render the HIT template
    import jinja2

    template = jinja2.Template(_TEMPLATE)
    html = template.render(video_urls=video_urls,
                           ratings=["Bad", "Poor", "Fair", "Good", "Excellent"])
    template_path = os.path.join(args.output_path, "template.html")
    with open(template_path, "w") as f:
        f.write(html)

    urls_csv = os.path.join(args.output_path, "video_urls.csv")
    pd.DataFrame({"video_url": video_urls}).to_csv(urls_csv, index=False)
    log(f"Wrote {len(video_urls)} stimuli, {template_path}, {urls_csv}")
    return video_urls


if __name__ == "__main__":
    main()
