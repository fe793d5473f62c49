"""What several per-layer metrics read alike: shares of the traced window,
of the peak over the untraced window, and of a kernel's bound.  Each
metric's own file under ``metrics/`` says which it reads; none returns a
number where its window has nothing."""

from __future__ import annotations

from typing import Optional


def idle_share(ctx: dict) -> Optional[float]:
    """Per cent of the traced window in which no kernel, copy or fill ran
    on the device."""
    tr = ctx["trace"]
    if not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def forward_mfu(ctx: dict) -> Optional[float]:
    """Per cent of the bf16 dense peak: the configuration's convolution
    FLOPs a frame times the frames the untraced window completed, over that
    window."""
    from port_bench.counts import peaks
    from port_bench.counts.convs import forward_flops

    st, t = ctx["untraced"], ctx["traffic"]
    if not st.get("frames"):
        return None
    flops = forward_flops(ctx["config"], t["height"], t["width"]) * st["frames"]
    return 100.0 * flops / st["window_s"] / peaks.BF16_FLOPS


def kernel_share(ctx: dict, kernel: str, bound_s: float) -> Optional[float]:
    """Per cent of ``kernel``'s bound: the bound over the mean device time
    of its launches in the trace."""
    recs = ctx["trace"].by_name(kernel)
    if not recs:
        return None
    mean_s = sum(r.dur_us for r in recs) / len(recs) / 1e6
    return 100.0 * bound_s / mean_s


def train_mfu(ctx: dict) -> Optional[float]:
    """Per cent of the bf16 dense peak: a joint step's convolution FLOPs
    (both views, forward and backward) times the steps the untraced window
    completed, over that window."""
    from port_bench.counts import peaks
    from port_bench.counts.convs import train_step_flops

    st, t = ctx["untraced"], ctx["traffic"]
    if not st.get("steps"):
        return None
    flops = train_step_flops(ctx["config"], t["height"], t["width"], t["batch"])
    return 100.0 * flops * st["steps"] / st["window_s"] / peaks.BF16_FLOPS


def step_kernel_s(ctx: dict, kernels: dict) -> Optional[float]:
    """Device seconds a step of the kernels named by ``{name part:
    launches a step}``: each kernel's mean time a launch times its launches
    a step (a record the tracer drops moves the mean, not the count)."""
    tr, steps = ctx["trace"], ctx["stats"].get("steps")
    if not steps:
        return None
    total = 0.0
    for name, per_step in kernels.items():
        recs = tr.by_name(name)
        if not recs:
            return None
        total += per_step * sum(r.dur_us for r in recs) / len(recs) / 1e6
    return total
