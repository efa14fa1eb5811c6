"""Host-side batching of (image, depth) datasets, numpy only.

Counterpart of ``batch_iterator`` in
``efficientdepthestimation_tpu/data/datasets.py:141-196``. A dataset is
anything with ``len`` and ``__getitem__`` returning ``(image, depth)``
arrays (or a lone image), e.g. ``data.synthetic_nyu.synthetic_train_set``.
The PNG/CSV ``DepthPairDataset`` waits for the training CLI (ROADMAP A10).
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator

import numpy as np

__all__ = ["batch_iterator"]


def batch_iterator(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    num_workers: int = 4,
    drop_last: bool = False,
    pad_last: bool = False,
    skip_batches: int = 0,
) -> Iterator[dict]:
    """Yield stacked numpy batches, fetching samples on a thread pool.

    ``pad_last`` repeats the final sample so every batch has the same shape;
    the true count is reported as ``num_valid``. ``skip_batches``
    fast-forwards past the first N batches without fetching them: with the
    same (shuffle, seed) the remaining batches are those of a full pass,
    which is what an exact mid-epoch resume needs.
    """
    indices = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(indices)
    indices = indices[skip_batches * batch_size:]

    def fetch(i):
        return dataset[int(i)]

    with cf.ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        for start in range(0, len(indices), batch_size):
            chunk = indices[start:start + batch_size]
            if len(chunk) < batch_size:
                if drop_last:
                    return
                if pad_last:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], batch_size - len(chunk))]
                    )
            num_valid = min(batch_size, len(indices) - start)
            samples = list(pool.map(fetch, chunk))
            if isinstance(samples[0], tuple):
                images = np.stack([s[0] for s in samples])
                depths = np.stack([s[1] for s in samples])
                yield {"image": images, "depth": depths,
                       "num_valid": num_valid}
            else:
                yield {"image": np.stack(samples), "num_valid": num_valid}
