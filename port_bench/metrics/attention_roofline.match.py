"""``attention_roofline.match``: SuperGlue's attention, the needed FLOPs of
its two products in every layer on both sides of every pair of a call
(`counts/vgg_superglue.py::attention_flops`) over the bf16 dense peak,
over the device time its kernels take a call: their records' mean time
times ``LAUNCHES`` a layer times the layers.  The kernels are
``scaled_dot_product_attention``'s on the H100, named by ``KERNELS``
(parts of the names in the card's trace): with a key-padding mask in
bf16 it runs cuDNN's fused attention
(``cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_...``,
18 a call); the memory-efficient and flash kernels are its other
backends."""

from port_bench.counts import peaks
from port_bench.counts.vgg_superglue import attention_flops

KERNELS = ("cudnn_generated_fort_native_sdpa", "fmha_cutlassF", "flash_fwd")
# one attention launch a layer: both sides of every pair in one call
LAUNCHES = 1


def read(ctx):
    recs = [r for r in ctx["trace"].device if any(k in r.name for k in KERNELS)]
    if not recs:
        return None
    c, t = ctx["config"], ctx["traffic"]
    n = min(c["top_n"], c["max_keypoints"])
    per_call_s = sum(r.dur_us for r in recs) / len(recs) / 1e6 \
        * LAUNCHES * len(c["superglue"]["GNN_layers"])
    bound_s = attention_flops(c, n, n) * t["batch"] / peaks.BF16_FLOPS
    return 100.0 * bound_s / per_call_s
