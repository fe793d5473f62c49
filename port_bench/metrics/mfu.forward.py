"""``mfu.forward``: the VGG forward's convolution FLOPs over the untraced
window, as a share of the bf16 dense peak (moves ``forward_frames_per_s``)."""

from port_bench.harness.readers import forward_mfu as read  # noqa: F401
