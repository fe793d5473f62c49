"""``frame_host_ms.latency``: the mean host time of a ``frame`` call, from
its span in the span window: what the host spends on a frame while the
device waits (moves ``frame_ms_p95``)."""

from port_bench.harness.spans import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "frame")
