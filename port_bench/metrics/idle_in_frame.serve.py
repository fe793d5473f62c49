"""``idle_in_frame.serve``: the share of the device's idle time in the span
window that falls inside an open ``frame`` call, not the client's read-back
and loop (moves ``frames_per_s``)."""

from port_bench.harness.spans import idle_in_frame as read  # noqa: F401
