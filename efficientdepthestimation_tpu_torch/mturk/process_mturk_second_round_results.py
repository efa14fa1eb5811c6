"""Second-round study analysis: the counterpart of
MTurk/process_mturk_second_round_results.py and of
``efficientdepthestimation_tpu/mturk/process_mturk_second_round_results.py``.

Round 2 used 7-point Likert items per (model, video) for realism and
GT-similarity instead of the single rating column: one-hot answer columns
``Answer.{task}-{scale}`` are folded back into scores, per-rater similarity
box plots are produced, and per-task mean times reported.
"""

from __future__ import annotations

import argparse
import os
from typing import TYPE_CHECKING, List, Optional

if TYPE_CHECKING:
    import pandas as pd

ANSWER_PREFIX = "Answer."
DEFAULT_MODELS = ["reside_enb0-random_weights", "flat", "reside_enb0",
                  "reside_senet"]
DEFAULT_VIDEOS = [0, 30, 66, 260]


def convert_to_scores(df: pd.DataFrame, columns, scale_range: int,
                      answer_prefix: str = ANSWER_PREFIX) -> dict:
    """Fold one-hot Likert columns ``{prefix}{col}.{1..K}`` into 0-based scores."""
    import pandas as pd

    output = {}
    for col in columns:
        data = None
        for i in range(scale_range):
            full_col = f"{answer_prefix}{col}.{i + 1}"
            if full_col not in df.columns:
                continue
            if data is None:
                data = pd.Series(0, index=df.index, dtype="int64")
            data[df[full_col].astype(bool)] = i
        if data is not None:
            output[col] = data
    return output


def get_gt_realism_scores(df: pd.DataFrame, videos) -> tuple[dict, list]:
    """Aggregate the randomized-id ground-truth realism columns."""
    import pandas as pd

    gt_data: dict = {}
    cols_to_remove = []
    for col in df.columns:
        for video in videos:
            task_id = f"gt-{video:06d}"
            if task_id in col and "realism" in col:
                rating = col[-1]
                gt_id = col.replace(f"{ANSWER_PREFIX}{task_id}-", "").split("-")[0]
                scores = df[col].copy() * int(rating)
                dest = f"{task_id}-realism-{gt_id}"
                gt_data[dest] = (scores if dest not in gt_data
                                 else gt_data[dest].add(scores, fill_value=0))
                cols_to_remove.append(col)

    gt_scores: dict = {}
    for key, value in gt_data.items():
        task_id = "-".join(key.split("-")[:-1])
        gt_scores[task_id] = (value.copy() if task_id not in gt_scores
                              else pd.concat([gt_scores[task_id], value]))
    return gt_scores, cols_to_remove


def plot_similarity_scores_by_rater(similarity_scores: dict, output_path="."):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    df = pd.DataFrame.from_dict(similarity_scores)
    ax = df.T.boxplot()
    ax.set_title(f"Similarity Scores by Rater (N={len(df.columns)})\n"
                 f"'These two videos are similar.'")
    ax.set_ylabel("Score")
    ax.set_ylim(bottom=-0.3, top=6.3)
    ax.set_xlabel("Rater")
    ax.grid(axis="x")
    plt.tight_layout()
    out = os.path.join(output_path, "similarity_by_rater.png")
    plt.savefig(out)
    plt.close()
    return out


def main(args: Optional[List[str]] = None):
    import pandas as pd

    parser = argparse.ArgumentParser(description="Second-round MTurk analysis")
    parser.add_argument("--csv-path", required=True)
    parser.add_argument("--output-path", default=".")
    parser.add_argument("--models", nargs="*", default=DEFAULT_MODELS)
    parser.add_argument("--videos", nargs="*", type=int, default=DEFAULT_VIDEOS)
    parser.add_argument("--scale-range", default=7, type=int)
    args = parser.parse_args(args)

    df = pd.read_csv(args.csv_path)
    videos = [f"{v:06d}" for v in args.videos]
    num_tasks = len(args.models) * len(videos)

    realism_cols = [f"{m}-{v}-realism" for m in args.models for v in videos]
    similarity_cols = [f"gt-{m}-{v}-similarity" for m in args.models for v in videos]

    similarity_scores = convert_to_scores(df, similarity_cols, args.scale_range)
    realism_scores = convert_to_scores(df, realism_cols, args.scale_range)
    gt_realism, _ = get_gt_realism_scores(df, args.videos)

    print("Mean Time (Minutes) per Task:\n",
          df[["WorkerId", "WorkTimeInSeconds"]].set_index("WorkerId")
          / 60 / num_tasks)

    if similarity_scores:
        plot_similarity_scores_by_rater(similarity_scores, args.output_path)
    return {"similarity": similarity_scores, "realism": realism_scores,
            "gt_realism": gt_realism}


if __name__ == "__main__":
    main()
