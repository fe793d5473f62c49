"""``launches_per_frame.latency``: the device's records (kernels, copies,
fills) in the traced window over the frames it completed: what a CUDA
graph of the frame or fused operations would remove."""


def read(ctx):
    frames = ctx["stats"].get("frames")
    recs = ctx["trace"].device
    if not frames or not recs:
        return None
    return len(recs) / frames
