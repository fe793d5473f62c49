"""``desc_loss_bwd_roofline``: the hinge descriptor loss's backward bound
(the 4 needed N x N x D products over the TF32 peak, or its bytes,
whichever is longer) over the device time its kernels take a step: a
split, the transposed split, two sweeps and two gradient sweeps."""

from port_bench.counts.kernels import desc_loss_bound_s
from port_bench.harness.readers import step_kernel_s

KERNELS = {"wgmma_sweep_kernel<3>": 1, "wgmma_sweep_kernel<4>": 1,
           "wgmma_grad_kernel<5>": 1, "wgmma_grad_kernel<6>": 1,
           "split_transposed_kernel": 1, "split_kernel": 1}
PRODUCTS = 4


def read(ctx):
    t, c = ctx["traffic"], ctx["config"]
    n = (t["height"] // c["cell"]) * (t["width"] // c["cell"])
    took = step_kernel_s(ctx, KERNELS)
    if not took:
        return None
    bound, _ = desc_loss_bound_s(t["batch"], n, c["descriptor_dim"], PRODUCTS)
    return 100.0 * bound / took
