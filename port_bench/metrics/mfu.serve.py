"""``mfu.serve``: the frame program's convolution FLOPs over the untraced
window, as a share of the bf16 dense peak (moves ``frames_per_s``)."""

from port_bench.harness.readers import forward_mfu as read  # noqa: F401
