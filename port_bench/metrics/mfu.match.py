"""``mfu.match``: the VGG forward's convolution FLOPs a frame times the
frames, plus SuperGlue's FLOPs a pair (`counts/vgg_superglue.py`) times
the pairs the ``superglue.pairs`` counter gained, over the untraced
window, as a share of the bf16 dense peak (moves ``frames_per_s``).  A
program without the counter reads no pairs, and then nothing."""

from port_bench.counts import peaks
from port_bench.counts.convs import forward_flops
from port_bench.counts.vgg_superglue import matcher_flops


def read(ctx):
    st, t, c = ctx["untraced"], ctx["traffic"], ctx["config"]
    if not st.get("frames") or not st.get("pairs"):
        return None
    n = min(c["top_n"], c["max_keypoints"])
    flops = forward_flops(c, t["height"], t["width"]) * st["frames"] \
        + matcher_flops(c, n, n) * st["pairs"]
    return 100.0 * flops / st["window_s"] / peaks.BF16_FLOPS
