"""Timing utility (context-manager ``Timer``, API parity with
ReSIDE/util.py:198-247).

A copy of ``efficientdepthestimation_tpu/utils/timer.py``. CUDA work is
asynchronous: a timed region must end with ``torch.cuda.synchronize`` on its
outputs' card, or with a host read of a result; ``device_timer`` does the
former.
"""

from __future__ import annotations

import datetime
from contextlib import contextmanager

import torch

__all__ = ["Timer", "device_timer"]


class Timer:
    """Start/stop timer usable as a context manager."""

    def __init__(self):
        self._start_time = datetime.datetime.fromtimestamp(0)
        self._stop_time = None
        self._is_running = False

    @property
    def start_time(self):
        return self._start_time

    @property
    def stop_time(self):
        return self._stop_time

    @property
    def elapsed(self) -> datetime.timedelta:
        if self._stop_time is not None:
            return self._stop_time - self._start_time
        return datetime.datetime.now() - self._start_time

    def start(self):
        self._start_time = datetime.datetime.now()
        self._stop_time = None
        self._is_running = True

    def stop(self):
        self._stop_time = datetime.datetime.now()
        self._is_running = False

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()


@contextmanager
def device_timer(outputs_holder: list):
    """Timer that waits, before it stops, for the card of every CUDA tensor
    appended to ``outputs_holder``."""
    timer = Timer()
    timer.start()
    try:
        yield timer
    finally:
        for out in outputs_holder:
            if isinstance(out, torch.Tensor) and out.is_cuda:
                torch.cuda.synchronize(out.device)
        timer.stop()
