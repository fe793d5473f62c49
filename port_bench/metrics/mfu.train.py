"""``mfu.train``: a joint step's convolution FLOPs over the untraced
window, as a share of the bf16 dense peak (moves ``train_images_per_s``)."""

from port_bench.harness.readers import train_mfu as read  # noqa: F401
