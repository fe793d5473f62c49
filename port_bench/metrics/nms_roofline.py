"""``nms_roofline``: the grid NMS kernel's byte bound (the score map in
and the kept map out, once each, over the HBM peak) over its mean device
time a launch."""

from port_bench.counts.kernels import bytes_bound_s, nms_bytes
from port_bench.harness.readers import kernel_share

KERNEL = "grid_nms_kernel"


def read(ctx):
    t = ctx["traffic"]
    return kernel_share(ctx, KERNEL, bytes_bound_s(nms_bytes(t["batch"], t["height"],
                                                             t["width"])))
