"""``desc_loss_fwd_roofline``: the hinge descriptor loss's forward bound
(the 2 needed N x N x D products over the TF32 peak, or its bytes,
whichever is longer) over the device time its kernels take a step: the
split, the three sweeps and the sum."""

from port_bench.counts.kernels import desc_loss_bound_s
from port_bench.harness.readers import step_kernel_s

# kernel name parts and launches a step (`csrc/descriptor_loss.cu`: the
# sweep modes 0-2 are the forward's; one of the two plain splits a step is
# the forward's)
KERNELS = {"wgmma_sweep_kernel<0>": 1, "wgmma_sweep_kernel<1>": 1,
           "wgmma_sweep_kernel<2>": 1, "sum_kernel": 1, "split_kernel": 1}
PRODUCTS = 2


def read(ctx):
    t, c = ctx["traffic"], ctx["config"]
    n = (t["height"] // c["cell"]) * (t["width"] // c["cell"])
    took = step_kernel_s(ctx, KERNELS)
    if not took:
        return None
    bound, _ = desc_loss_bound_s(t["batch"], n, c["descriptor_dim"], PRODUCTS)
    return 100.0 * bound / took
