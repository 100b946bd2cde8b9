"""Profiling/tracing hooks.

Port of `dtrenderer_tpu/utils/trace.py`: a `torch.profiler` trace of the host
and, where there is one, the card, plus a lightweight host-side frame timer
whose numbers feed the debug HUD.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler and write a Chrome trace
    (`trace.json`, for chrome://tracing or Perfetto) into log_dir. Yields the
    profiler, whose key_averages() sums the block by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class FrameTimer:
    """Rolling frame-time statistics for the HUD (QPC analog)."""

    def __init__(self, window: int = 60):
        self.window = window
        self.samples: list[float] = []
        self._last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt = (now - self._last) * 1000.0
        self._last = now
        self.samples.append(dt)
        if len(self.samples) > self.window:
            self.samples.pop(0)
        return dt

    @property
    def mean_ms(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    @property
    def fps(self) -> float:
        return 1000.0 / self.mean_ms if self.mean_ms > 0 else 0.0
