"""``idle_in_frame.latency``: the share of the device's idle time in the span
window that falls inside an open ``frame`` call, not the client's read-back
and loop (moves ``frame_ms_p95``)."""

from port_bench.harness.spans import idle_in_frame as read  # noqa: F401
