"""Profiling: ``torch.profiler`` traces and step timing.

- ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a TensorBoard-loadable trace of host activity and, where the work
  runs on a card, of its kernels, into ``logdir``.
- ``StepTimer``: a wall-clock EMA of step latency; it reads the clock only
  where the caller ticks it, so it does not add a synchronisation.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(logdir))) as prof:
        yield prof


class StepTimer:
    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Optional[float] = None
        self._t0 = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        self.avg = dt if self.avg is None else (
            self.ema * self.avg + (1 - self.ema) * dt)
        return dt

    def steps_per_sec(self) -> float:
        return 1.0 / self.avg if self.avg else 0.0
