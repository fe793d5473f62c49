"""``decode_roofline``: the fused decode + threshold kernel's byte bound
(logits in and the map out, once each, over the HBM peak) over its mean
device time a launch."""

from port_bench.counts.kernels import bytes_bound_s, decode_bytes
from port_bench.harness.readers import kernel_share

KERNEL = "decode_row_kernel"


def read(ctx):
    t = ctx["traffic"]
    bound = bytes_bound_s(decode_bytes(t["batch"], t["height"], t["width"],
                                       ctx["config"]["cell"]))
    return kernel_share(ctx, KERNEL, bound)
