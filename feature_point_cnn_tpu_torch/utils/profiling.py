"""Profiling and tracing (`feature_point_cnn_tpu/utils/profiling.py`).

`torch.profiler` trace capture (CPU and CUDA activity, written as a Chrome
trace that Perfetto or TensorBoard opens), named ranges that show on both
the profiler's timeline and an NVTX timeline, a window of training steps
(`Trainer` opens one on steps 5-15 of epoch 0 when ``FPC_PROFILE_DIR`` is
set), and a wall-clock throughput meter.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import torch


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _start():
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    return prof


def _stop(prof, log_dir: str) -> str:
    prof.stop()
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    path = str(Path(log_dir) / f"trace_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a trace: ``with trace('/tmp/tb'): run_steps()`` writes
    ``log_dir/trace_<ms>.json``."""
    prof = _start()
    try:
        yield
    finally:
        _stop(prof, log_dir)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named range on the profiler's timeline and, on a card, on NVTX's."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTraceWindow:
    """Trace a window of training steps into ``log_dir``.

    ``tick(i)`` starts the capture at step ``start`` and stops it at step
    ``stop``; ``close()`` stops it early if the loop ends inside the window.
    An empty ``log_dir`` turns it off.  ``path`` is the last trace written.
    """

    def __init__(self, log_dir: str, start: int = 5, stop: int = 15):
        self.log_dir = log_dir
        self.start = start
        self.stop = stop
        self._prof = None
        self.path: Optional[str] = None

    def tick(self, i: int) -> None:
        if not self.log_dir:
            return
        if i == self.start and self._prof is None:
            self._prof = _start()
        elif i == self.stop and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.path = _stop(self._prof, self.log_dir)
            self._prof = None
            print(f"[profiling] step trace written to {self.path}")


class Throughput:
    """Steady-state items/sec meter (skips the first, warm-up call)."""

    def __init__(self):
        self.n = 0
        self.t0 = None

    def step(self, items: int = 1) -> None:
        if self.t0 is None:
            self.t0 = time.perf_counter()
            return
        self.n += items

    @property
    def per_sec(self) -> float:
        if self.t0 is None or self.n == 0:
            return 0.0
        return self.n / (time.perf_counter() - self.t0)
