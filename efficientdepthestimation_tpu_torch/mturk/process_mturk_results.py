"""Analyse MTurk ratings: the counterpart of MTurk/process_mturk_results.py
and of ``efficientdepthestimation_tpu/mturk/process_mturk_results.py``.

Ratings CSV → ordered categorical (Bad..Excellent → 1..5), model/frame parsed
from the S3 URL path, worker rejection heuristics (too fast / not enough
answers / zero variance / questionnaire), summary statistics and plots.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import TYPE_CHECKING, List, Optional
from urllib.parse import urlsplit

if TYPE_CHECKING:
    import pandas as pd

RATING_CATEGORIES = ["Bad", "Poor", "Fair", "Good", "Excellent"]


def process_raw_data(csv_path: str) -> pd.DataFrame:
    import pandas as pd

    data = pd.read_csv(csv_path)
    rating = pd.Categorical(data["Answer.rating.label"], ordered=True,
                            categories=RATING_CATEGORIES)
    data["Rating"] = rating
    data["Score"] = rating.codes + 1

    paths = data["Input.video_url"].map(lambda url: urlsplit(url).path)
    parts = paths.str.split(pat="/", expand=True)
    # url path format: /<model name>/<video name>.mp4
    data["Model"] = parts[1].str.replace("reside", "hu", regex=False)
    data["Frame"] = parts[2].map(lambda p: int(Path(p).stem))
    return data[["WorkerId", "WorkTimeInSeconds", "Model", "Frame",
                 "Rating", "Score"]]


def reject_workers(data: pd.DataFrame,
                   questionnaire_csv_paths: List[str]) -> pd.DataFrame:
    import pandas as pd

    ids_from_questionnaire = set()
    for path in questionnaire_csv_paths:
        df = pd.read_csv(path)
        ids_from_questionnaire |= set(df["WorkerId"])

    num_tasks = data["WorkerId"].value_counts()
    numeric = data[["WorkerId", "WorkTimeInSeconds", "Score"]]
    std = numeric.groupby("WorkerId").std().sort_index()
    mean = numeric.groupby("WorkerId").mean().sort_index()
    std["NumTasks"] = num_tasks
    mean["NumTasks"] = num_tasks

    rejection = pd.DataFrame(index=mean.index)
    rejection["too_fast"] = mean["WorkTimeInSeconds"] < 5
    rejection["not_enough_answers"] = num_tasks.reindex(mean.index) < 180
    rejection["all_same_answers"] = (std["Score"] == 0.0) & (std["NumTasks"] > 5)
    rejection["did_not_complete_questionnaire"] = ~rejection.index.isin(
        ids_from_questionnaire)
    return rejection


def print_summary_stats(series: pd.Series, title: str):
    print(f"{title} Statistics:")
    print(f"\tMean: {series.mean():,.2f}")
    print(f"\tStd. Dev.: {series.std():,.2f}")
    print(f"\tMin.: {series.min():,.0f}")
    print(f"\tLower Quartile: {series.quantile(.25):,.2f}")
    print(f"\tMedian: {series.median():,.2f}")
    print(f"\tUpper Quartile: {series.quantile(.75):,.2f}")
    print(f"\tMax.: {series.max():,.0f}")


def analyse(data: pd.DataFrame, questionnaire_csv_paths: List[str],
            output_path: str = "."):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns

    reject_list = reject_workers(data, questionnaire_csv_paths)
    num_workers = data["WorkerId"].nunique()
    tasks_per_worker = data["WorkerId"].value_counts()

    workers_to_reject = reject_list[
        reject_list["too_fast"] & reject_list["all_same_answers"]].index
    num_rejected_tasks = data["WorkerId"].isin(workers_to_reject).sum()

    print(f"Number of Unique Workers: {num_workers:,d}")
    print(f"Number of Tasks Completed: {len(data):,d}")
    print(f"Num. One Task Completed: {(tasks_per_worker == 1).sum()}")
    print("Rejection Stats (reason, count, rejection rate):")
    for column in reject_list:
        n = int(reject_list[column].sum())
        print(f"\t{' '.join(column.split('_')).capitalize()}: "
              f"{n:,d}/{num_workers:,d} ({n / num_workers * 100:.2f}%)")
    print(f"\tTasks that would be rejected: {num_rejected_tasks:,d}/{len(data):,d}")

    print_summary_stats(tasks_per_worker, "Task Completion")
    print_summary_stats(data["Score"], "Score")
    print_summary_stats(data["WorkTimeInSeconds"], "Time To Answer")

    clean = data[~data["WorkerId"].isin(workers_to_reject)]
    per_model = clean.groupby("Model")["Score"]
    summary = per_model.agg(["mean", "std", "count"])
    print("\nPer-model scores:")
    print(summary)

    fig, axes = plt.subplots(ncols=3, nrows=2, figsize=(16, 10))
    sns.histplot(data, x="Score", discrete=True, ax=axes[0, 0])
    axes[0, 0].set_title("Distribution of Score")
    sns.histplot(tasks_per_worker, ax=axes[0, 1])
    axes[0, 1].set_title("Tasks per Worker")
    sns.histplot(data, x="WorkTimeInSeconds", ax=axes[0, 2])
    axes[0, 2].set_title("Time to Answer")
    sns.boxplot(data=clean, x="Model", y="Score", ax=axes[1, 0])
    axes[1, 0].set_title("Score by Model")
    sns.pointplot(data=clean, x="Frame", y="Score", hue="Model", ax=axes[1, 1],
                  errorbar=("ci", 95))
    axes[1, 1].set_title("Score by Frame")
    sns.histplot(clean, x="Score", hue="Model", discrete=True, multiple="dodge",
                 ax=axes[1, 2])
    axes[1, 2].set_title("Score Distribution by Model")
    plt.tight_layout()
    out = os.path.join(output_path, "mturk_analysis.png")
    plt.savefig(out)
    plt.close(fig)
    print(f"\nWrote {out}")
    return summary


def main(args: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="Process MTurk study results")
    parser.add_argument("--results-csv", required=True)
    parser.add_argument("--questionnaire-csv", nargs="*", default=[])
    parser.add_argument("--output-path", default=".")
    args = parser.parse_args(args)

    data = process_raw_data(args.results_csv)
    return analyse(data, args.questionnaire_csv, args.output_path)


if __name__ == "__main__":
    main()
