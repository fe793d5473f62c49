"""The span metrics' readers and the attribution they rest on, on hand-made
span windows (CPU only): each reader is found by name, reads a number
where the window has spans and None where it has none; device seconds go
to the span open at each record's launch and add up to the busy time;
idle gaps are placed on the host's clock by the launches that end them,
whatever the device's stamps read, and are cut at span edges."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE.parent))

from feature_point_cnn_tpu_torch.utils.profiling import Span  # noqa: E402
from port_bench.harness import core, spans  # noqa: E402

READERS = ["frame_host_ms.latency", "idle_in_frame.latency", "upload_ms.serve",
           "idle_in_frame.serve"]
MS = 1_000_000


def _frame_call(t0: int, call: int) -> list:
    """A frame of 10 ms from ``t0``: upload 0-2 ms, forward 3-6, match 7-9."""
    parts = [("frame.upload", 0, 2), ("frame.forward", 3, 6), ("frame.match", 7, 9)]
    return [Span("frame", t0, t0 + 10 * MS, call, -1, call, {"batch": 1})] + [
        Span(name, t0 + a * MS, t0 + b * MS, call + 1 + i, call, call, {})
        for i, (name, a, b) in enumerate(parts)]


def _window(offset: int = 0) -> spans.SpanTrace:
    """Two frame calls at 0 and 20 ms in a 40-ms window.  Device records:
    a copy launched in the upload (1-2 ms on the device, 21.5-22.5 for the
    second call's, overlapping a kernel of 0.5 ms), a kernel launched in
    the forward (4-8 ms, past the span's end), one launched outside any
    span (12-13 ms) and one whose launch was not recorded (30-31 ms).  A
    record that ends a gap starts 0.1 ms after its launch; the device's
    stamps run ``offset`` ns off the host's clock."""
    s = _frame_call(0, 0) + _frame_call(20 * MS, 10)
    device = [(1 * MS, 2 * MS, 1), (4 * MS, 8 * MS, 2), (12 * MS, 13 * MS, 3),
              (int(21.5 * MS), int(22.5 * MS), 4), (22 * MS, int(22.5 * MS), 6),
              (30 * MS, 31 * MS, 5)]
    device = [(a + offset, b + offset, c) for a, b, c in device]
    launches = {1: int(0.9 * MS), 2: int(3.9 * MS), 3: int(11.9 * MS), 4: int(21.4 * MS),
                6: int(21 * MS)}
    return spans.SpanTrace(device, launches, s, 0, 40 * MS)


# on the host's clock the gaps are 0-0.9, 1.9-3.9, 7.9-11.9, 12.9-21.4,
# 22.4-29.9 (ended by the unmatched record, placed by the lag before it)
# and 30.9-40 ms: upload 0-0.9, 1.9-2, 20-21.4; frame 2-3, 9-10, 22.4-23,
# 26-27, 29-29.9; forward 3-3.9, 23-26; match 7.9-9, 27-29; the rest outside
IDLE = {"frame.upload": 0.0024, "frame": 0.0045, "frame.match": 0.0031,
        "frame.forward": 0.0039, "outside": 0.0181}


@pytest.mark.parametrize("offset", [0, -2_250_000, 90_000])
def test_attribution_adds_up_and_ignores_the_device_clock(offset):
    att = spans.attribute(_window(offset))
    assert att["window_s"] == pytest.approx(0.040)
    assert att["busy_s"] == pytest.approx(0.008)
    assert att["device_s"] == pytest.approx({"frame.upload": 0.002, "frame.forward": 0.004,
                                             "outside": 0.001, "unmatched": 0.001})
    assert sum(att["device_s"].values()) == pytest.approx(att["busy_s"], rel=1e-12)
    assert att["idle_s"] == pytest.approx(IDLE)
    line = spans.spans_line(att)
    assert line.startswith("[spans] ") and "frame.upload 0.002000" in line


@pytest.mark.parametrize("name", READERS)
def test_span_readers_read_a_window_with_spans(name):
    read = core.load_module(HERE / "metrics" / f"{name}.py").read
    st = _window()
    want = {"frame_host_ms.latency": 10.0, "upload_ms.serve": 2.0,
            "idle_in_frame.latency": 100.0 * 0.0139 / 0.032,
            "idle_in_frame.serve": 100.0 * 0.0139 / 0.032}[name]
    assert read({"spans": st.spans, "span_trace": st}) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_span_readers_give_none_without_spans(name):
    read = core.load_module(HERE / "metrics" / f"{name}.py").read
    st = _window()
    empty = spans.SpanTrace(st.device, st.launches, [], 0, 40 * MS)
    assert read({}) is None
    assert read({"spans": [], "span_trace": empty}) is None


def test_innermost_span_past_a_closed_call():
    inner = spans._Innermost(_frame_call(0, 0) + _frame_call(20 * MS, 10))
    assert [inner.at(t * MS) for t in (1, 2.5, 5, 15, 21, 29.5, 35)] == [
        "frame.upload", "frame", "frame.forward", "outside", "frame.upload", "frame",
        "outside"]
