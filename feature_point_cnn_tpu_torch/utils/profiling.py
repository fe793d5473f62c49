"""The port's tracer (`feature_point_cnn_tpu/utils/profiling.py`).

* Spans: ``with span("frame.upload"):`` records the name, the start and
  end on the epoch clock (``time.time_ns()``, the clock the profiler's
  records are stamped on: a record's ``start_ns`` is
  ``kineto_results.trace_start_ns()`` plus its ``time_range.start`` x
  1000), the enclosing span and a call id that every span under one root
  span shares.  Spans are recorded only while the tracer is on
  (`enabled`); off, a span costs one test of a module-level boolean.
  Recorded spans wait in a buffer of `CAPACITY` until `drain` takes them;
  spans past it are dropped and counted.  Spans are not recorded while
  ``torch.export`` or the compiler traces a program, so they never enter
  an exported graph.  The host thread that serves or trains is the only
  one that opens spans.
* Counters: plain integers, always on (`count`, `counters`,
  `reset_counters`).  ``kernel.*`` count the hand-written kernels'
  launches: a CUDA-graph capture takes back what it counted and each
  replay adds it again (`credit`), so a replayed step counts its kernels.
  ``frame.captures`` and ``frame.replays`` count the serving frame's CUDA
  graphs (`inference/wrapper.py::FrameGraph`): their ratio to ``frame``
  calls is the share served by a replay.  ``superglue.pairs`` and
  ``superglue.sinkhorn_iters`` count SuperGlue's pairs and its Sinkhorn
  iterations times the pairs; a replay credits them too.
* `trace` and `StepTraceWindow`: a ``torch.profiler`` capture (CPU and
  CUDA activity) written as a Chrome trace that Perfetto or TensorBoard
  opens; ``Trainer`` opens a window on steps 5-15 of epoch 0 when
  ``FPC_PROFILE_DIR`` is set.  While one runs the tracer is on, and every
  span is also a ``record_function`` range in that trace.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

# the spans the buffer holds before it drops and counts
CAPACITY = 1 << 16

COUNTERS: Dict[str, int] = dict.fromkeys((
    "kernel.decode_threshold",   # decode kernel launches (`ops/kernels/decode.py`)
    "kernel.grid_nms",           # NMS kernel launches (`ops/kernels/nms.py`)
    "kernel.desc_loss_fwd",      # descriptor-loss forward launcher calls
    "kernel.desc_loss_bwd",      # descriptor-loss backward launcher calls
    "kernel.sinkhorn",           # Sinkhorn kernel calls (`ops/kernels/sinkhorn.py`)
    "kernel.conv_epilogue",      # VGG epilogue kernel calls (`ops/kernels/conv_epilogue.py`)
    "train.steps",               # optimizer steps the `Trainer` took
    "frame.captures",            # frame programs captured in a CUDA graph
    "frame.replays",             # `SuperPointFrontend.frame` calls served by a replay
    "superglue.pairs",           # pairs SuperGlue matched (`models/superglue.py`)
    "superglue.sinkhorn_iters",  # its Sinkhorn iterations, times the pairs
    "spans.dropped",             # spans past `CAPACITY`
), 0)


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int          # the enclosing span's id, -1 for a root
    call: int            # the root span's id
    attrs: dict


_on = False              # the one test a span makes
_users = 0               # open `enabled()` blocks
_profiles = 0            # running `trace()` / `StepTraceWindow` captures
_buffer: List[Span] = []
_open: List["_Span"] = []
_next_id = 0


def _refresh() -> None:
    global _on
    _on = bool(_users or _profiles)


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "call", "start", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        global _next_id
        self.id = _next_id
        _next_id += 1
        outer = _open[-1] if _open else None
        self.parent = -1 if outer is None else outer.id
        self.call = self.id if outer is None else outer.call
        _open.append(self)
        self.rf = None
        if _profiles:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _open.pop()
        if len(_buffer) < CAPACITY:
            _buffer.append(Span(self.name, self.start, end, self.id, self.parent,
                                self.call, self.attrs))
        else:
            COUNTERS["spans.dropped"] += 1
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A named range of host time, recorded while the tracer is on."""
    if not _on or torch.compiler.is_compiling():
        return _OFF
    return _Span(name, attrs)


# the older name; `trace` and `StepTraceWindow` users open ranges with it
annotate = span


@contextlib.contextmanager
def enabled() -> Iterator[None]:
    """Record spans inside the block."""
    global _users
    _users += 1
    _refresh()
    try:
        yield
    finally:
        _users -= 1
        _refresh()


def drain() -> List[Span]:
    """The recorded spans in the order they opened; empties the buffer."""
    out = sorted(_buffer, key=lambda s: s.id)
    _buffer.clear()
    return out


def count(name: str, n: int = 1) -> None:
    COUNTERS[name] += n


def counters() -> Dict[str, int]:
    return dict(COUNTERS)


def reset_counters() -> None:
    for k in COUNTERS:
        COUNTERS[k] = 0


def counted_since(before: Dict[str, int]) -> Dict[str, int]:
    """What the counters gained since ``before`` (a `counters()` copy)."""
    return {k: v - before[k] for k, v in COUNTERS.items() if v != before[k]}


def credit(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``counts`` ``times`` over: a graph replay credits what its
    capture counted; a capture takes it back (``times=-1``)."""
    for k, v in counts.items():
        COUNTERS[k] += v * times


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _start():
    global _profiles
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    _profiles += 1
    _refresh()
    return prof


def _stop(prof, log_dir: str) -> str:
    global _profiles
    prof.stop()
    _profiles -= 1
    _refresh()
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
