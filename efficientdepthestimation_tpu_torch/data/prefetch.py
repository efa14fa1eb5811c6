"""Host→device prefetching: copy the next batches while the card computes.

Counterpart of ``efficientdepthestimation_tpu/data/prefetch.py``. The
reference copies each batch when it is used (loaddata.py:62). Here each
array of a batch is staged in pinned host memory and copied with
``non_blocking=True`` on a copy stream of its own, ``size`` batches ahead,
so the copies ride under the previous steps' kernels.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.apps.common import resolve_device

__all__ = ["device_prefetch"]


def device_prefetch(iterator: Iterable[dict], size: int = 2,
                    device=None) -> Iterator[dict]:
    """Yield the batches (dicts) of ``iterator`` with every array on
    ``device`` (the CUDA card unless ``device="cpu"``), keeping ``size``
    copies in flight; other values (``num_valid``) pass as they are.

    Before a batch is handed out, the consumer's current stream waits for
    its copies, and each tensor is recorded as used on that stream, so the
    caching allocator does not reuse its memory while the consumer's
    kernels may still read it. On the CPU the batches pass through
    unchanged."""
    device = resolve_device(device)
    if device.type != "cuda":
        yield from iterator
        return
    copy_stream = torch.cuda.Stream(device)
    queue = collections.deque()

    def put(batch: dict) -> tuple[dict, torch.cuda.Event]:
        out = {}
        with torch.cuda.stream(copy_stream):
            for key, value in batch.items():
                if isinstance(value, (np.ndarray, torch.Tensor)):
                    host = torch.as_tensor(value).pin_memory()
                    value = host.to(device, non_blocking=True)
                out[key] = value
            copied = torch.cuda.Event()
            copied.record(copy_stream)
        return out, copied

    it = iter(iterator)
    while len(queue) < size and (batch := next(it, None)) is not None:
        queue.append(put(batch))
    while queue:
        out, copied = queue.popleft()
        if (batch := next(it, None)) is not None:
            queue.append(put(batch))
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(copied)
        for value in out.values():
            if isinstance(value, torch.Tensor):
                value.record_stream(consumer)
        yield out
