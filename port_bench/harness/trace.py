"""The traced windows: device records from the profiler, the device's busy
time, and the breakdown a traced run prints.

The profiler's device records (kernels, copies, fills) are the source of
every per-layer metric read from the trace.  They come from a window that
records the device alone: recording the host's operations as well costs
the host time on every operation, which slows a host-bound loop twice as
much again, so only the breakdown's idle gaps, named by the host span
running at each, come from a second, shorter window that records both.
Even the device alone costs a host-bound loop some speed (the runtime's
calls are recorded too), so rates come from an untraced window.  The tracer now and then drops
a record (seen on the H100 in a few windows of a hundred); readers take a
kernel's time a launch as the mean over the records they find, and its
launches a step by rounding, so one lost record moves a reading little.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, List, Tuple


@dataclass
class Record:
    name: str
    start_us: float
    end_us: float

    @property
    def dur_us(self) -> float:
        return self.end_us - self.start_us


@dataclass
class Trace:
    """One traced window: the device's records, the host's spans (the
    profiler's CPU ops and runtime calls) and the union of the device's
    busy intervals."""

    device: List[Record]
    host: List[Record]
    window_s: float
    start_us: float = 0.0
    end_us: float = 0.0
    busy_intervals: List[Tuple[float, float]] = field(default_factory=list)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals) / 1e6

    def by_name(self, *parts: str) -> List[Record]:
        """The device records whose name holds every one of ``parts``."""
        return [r for r in self.device if all(p in r.name for p in parts)]


def traced(fn: Callable[[], object], host: bool = False):
    """Run ``fn()`` under the profiler and return ``(its result, Trace)``.
    The profiler records the device's activity, and with ``host`` the
    host's operations too.  ``fn`` ends its work in a device synchronise."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        rec = Record(e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(rec)
        else:
            host.append(rec)
    return out, make_trace(dev, host, window_s)


def make_trace(dev: List[Record], host: List[Record], window_s: float) -> Trace:
    """A `Trace` with the union of the device records' intervals; the
    window's ends are the first and last host span's."""
    dev = sorted(dev, key=lambda r: r.start_us)
    merged: List[Tuple[float, float]] = []
    for r in dev:
        if merged and r.start_us <= merged[-1][1]:
            if r.end_us > merged[-1][1]:
                merged[-1] = (merged[-1][0], r.end_us)
        else:
            merged.append((r.start_us, r.end_us))
    start = min((r.start_us for r in host), default=merged[0][0] if merged else 0.0)
    end = max((r.end_us for r in host), default=merged[-1][1] if merged else 0.0)
    return Trace(dev, host, window_s, start, end, merged)


def breakdown(trace: Trace, host_trace: Trace, top: int = 10) -> dict:
    """The device operations of ``trace`` that took most time (seconds
    summed by name), and the idle gaps of ``host_trace``, which recorded
    the host's operations, summed by the innermost host span running at
    each gap's midpoint ("idle" where none runs)."""
    ops = defaultdict(float)
    for r in trace.device:
        ops[r.name[:120]] += r.dur_us / 1e6
    gaps = defaultdict(float)
    edges = [(host_trace.start_us, host_trace.start_us)] + host_trace.busy_intervals + [
        (host_trace.end_us, host_trace.end_us)]
    spans = sorted(host_trace.host, key=lambda r: r.start_us)
    starts = [r.start_us for r in spans]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        best = None
        # the innermost span: the latest start whose end covers mid
        for r in reversed(spans[max(0, i - 4000):i]):
            if r.end_us >= mid:
                best = r
                break
        gaps[best.name[:120] if best else "idle"] += (b - a) / 1e6

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": top_of(ops), "idle_gaps": top_of(gaps)}
