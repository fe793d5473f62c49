"""The program's spans on the device's timeline: the window the span
metrics read, what they read from it, and a command that runs it.

The port's tracer (`feature_point_cnn_tpu_torch/utils/profiling.py`)
stamps its spans on the epoch clock that the profiler's host records
carry (``KinetoEvent.start_ns()``), so a span and the runtime calls made
inside it share one clock with no fitted offset.  In a window recorded
with the tracer on and the profiler recording the device alone:

* each device record (kernel, copy, fill) is matched to the runtime call
  that launched it by correlation id, and goes to the innermost span open
  at that launch; a record whose launch no span holds is ``outside`` (the
  client's read-back and loop), one whose launch was not recorded
  ``unmatched``.  Where records overlap, each instant of busy time goes to
  the record that started first, so the seconds by span add up to the
  device's busy time;
* each idle gap of the device is put on the host's clock by the launch
  that ends it (the device waited for it, so the gap ends as the launch
  begins, give or take the launch's latency), cut at the spans' edges,
  and each piece goes to the innermost span open over it (``outside``
  where none is).  The device's own stamps cannot place it: on the H100
  they sit 9 us to 6 ms off the host's clock, by machine and within a
  window.

``metrics/frame_host_ms.latency.py``, ``upload_ms.serve.py`` and
``idle_in_frame.*.py`` read ``ctx["spans"]`` (the window's spans) and
``ctx["span_trace"]`` (a `SpanTrace`); where the context has neither, as
in a program without the tracer, they return None.

    python3 -m port_bench.harness.spans --workload resnet.serve_b1 --seed 7

runs the cell's set-up, then windows of ``--seconds`` untraced, in turn
with the tracer off, on, on and off (what the tracer costs when on), then
one span window of at most 2 s; it logs the ``[spans]`` line and prints a
JSON line of the rates, the seconds by span and the span metrics.  It
needs a card, as the benchmark does.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

OUTSIDE = "outside"
UNMATCHED = "unmatched"


@dataclass
class SpanTrace:
    """One span window: the device's records ``(start_ns, end_ns,
    correlation id)``, the recorded runtime calls' starts by correlation
    id, the program's spans and the window's ends, all on the epoch clock."""

    device: List[Tuple[int, int, int]]
    launches: Dict[int, int]
    spans: Sequence
    start_ns: int
    end_ns: int


def span_window(fn: Callable[[], object]):
    """Run ``fn()`` under the profiler recording the device alone, with the
    program's tracer on; return ``(its result, SpanTrace)``.  ``fn`` ends
    its work in a device synchronise."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from feature_point_cnn_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    profiling.drain()
    with profiling.enabled(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        out = fn()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        else:
            launches[e.correlation_id()] = e.start_ns()
    return out, SpanTrace(device, launches, profiling.drain(), t0, t1)


class _Innermost:
    """The innermost span open at a time: spans of one thread nest, and
    calls follow one another."""

    def __init__(self, spans: Sequence):
        self.spans = sorted(spans, key=lambda s: s.start_ns)
        self.starts = [s.start_ns for s in self.spans]

    def at(self, t: float) -> str:
        for j in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            s = self.spans[j]
            if s.end_ns >= t:
                return s.name
            if s.parent == -1:      # a closed call: every earlier span closed too
                break
        return OUTSIDE


def attribute(st: SpanTrace) -> dict:
    """``{"device_s": {span: s}, "idle_s": {span: s}, "busy_s", "window_s"}``
    of a span window (the module's docstring says how)."""
    inner = _Innermost(st.spans)
    device = defaultdict(float)
    busy_s = 0.0
    gaps = []               # the device's idle gaps, on the host's clock
    cover = None            # the device clock's end of the busy time so far
    lag = 0                 # device clock less host clock, at the latest gap's end
    for start, end, corr in sorted(st.device):
        launch = st.launches.get(corr)
        if cover is None or start > cover:
            if launch is not None:
                lag = start - launch
            gaps.append((st.start_ns if cover is None else cover - lag, start - lag))
            cover = start
        if end <= cover:
            continue
        part = end - max(start, cover)
        cover = end
        busy_s += part / 1e9
        device[UNMATCHED if launch is None else inner.at(launch)] += part / 1e9
    gaps.append((st.start_ns, st.end_ns) if cover is None else (cover - lag, st.end_ns))
    edges = sorted({t for s in st.spans for t in (s.start_ns, s.end_ns)})
    idle = defaultdict(float)
    for a, b in gaps:
        a, b = max(a, st.start_ns), min(b, st.end_ns)
        cuts = [a] + edges[bisect.bisect_right(edges, a):bisect.bisect_left(edges, b)] + [b]
        for x, y in zip(cuts, cuts[1:]):
            if y > x:
                idle[inner.at(0.5 * (x + y))] += (y - x) / 1e9
    return {"device_s": dict(device), "idle_s": dict(idle), "busy_s": busy_s,
            "window_s": (st.end_ns - st.start_ns) / 1e9}


def spans_line(att: dict) -> str:
    """The ``[spans]`` log line: device and idle seconds by span."""
    def by(d):
        return ", ".join(f"{k} {v:.6f}" for k, v in sorted(d.items(), key=lambda kv: -kv[1]))
    return (f"[spans] window {att['window_s']:.6f} s, device busy {att['busy_s']:.6f} s; "
            f"device s by span: {by(att['device_s'])}; idle s by span: {by(att['idle_s'])}")


def mean_span_ms(ctx: dict, name: str) -> Optional[float]:
    """The mean duration of the window's spans named ``name``, in ms."""
    durations = [s.end_ns - s.start_ns for s in ctx.get("spans") or () if s.name == name]
    if not durations:
        return None
    return sum(durations) / len(durations) / 1e6


def idle_in_frame(ctx: dict) -> Optional[float]:
    """Per cent of the device's idle time in the span window that falls
    inside an open ``frame`` span (its parts included), not the client's."""
    st = ctx.get("span_trace")
    if st is None or not any(s.name == "frame" for s in st.spans):
        return None
    idle = attribute(st)["idle_s"]
    total = sum(idle.values())
    if total <= 0:
        return None
    inside = sum(v for k, v in idle.items() if k == "frame" or k.startswith("frame."))
    return 100.0 * inside / total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import torch

    from feature_point_cnn_tpu_torch.utils import profiling
    from port_bench.harness import core

    if not torch.cuda.is_available():
        core.log("[spans] needs a CUDA device; the benchmark does not run on the CPU")
        return 2
    t_start = time.time()
    bench = core.load_json(core.ROOT / "BENCHMARK.json")
    _, config, traffic, _, _ = core.cell_spec(bench, args.workload)
    drv = core.load_module(core.HERE / "drivers" / f"{traffic['driver']}.py").Driver(
        config, traffic, core.load_json(core.HERE / "limits" / f"{args.workload}.json"),
        args.seed, torch.device("cuda"))
    drv.parts = {}
    drv.setup()
    core.log(f"[spans] {args.workload} seed {args.seed}: set-up {time.time() - t_start:.3f} s")
    rates = {"off": [], "on": []}
    for state in ("off", "on", "on", "off"):
        if state == "on":
            with profiling.enabled():
                rates[state].append(drv.window(args.seconds)["e2e"])
            profiling.drain()
        else:
            rates[state].append(drv.window(args.seconds)["e2e"])
    _, st = span_window(lambda: drv.window(min(args.seconds, core.TRACE_SECONDS)))
    att = attribute(st)
    core.log(spans_line(att))
    ctx = {"spans": st.spans, "span_trace": st}
    readers = {name: core.load_module(core.HERE / "metrics" / f"{name}.py").read(ctx)
               for name in ("frame_host_ms.latency", "upload_ms.serve", "idle_in_frame.serve")}
    # a device record starts after its launch on one clock; how far before
    # its launch the earliest one starts bounds the device clock's offset
    lag_us = sorted((start - st.launches[c]) / 1e3 for start, _, c in st.device
                    if c in st.launches)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name(0), "rates": rates,
                      "spans_dropped": profiling.counters()["spans.dropped"],
                      "records": len(st.device), "matched": len(lag_us),
                      "start_after_launch_us": [lag_us[int(q * (len(lag_us) - 1))]
                                                for q in (0, 0.001, 0.01, 0.5)] if lag_us else None,
                      "attribution": att, "metrics": readers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
