"""``upload_ms.serve``: the mean host time of a ``frame.upload`` span, the
batch's pageable host-to-device copy, which holds the host until the copy
is done (moves ``frames_per_s``)."""

from port_bench.harness.spans import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "frame.upload")
