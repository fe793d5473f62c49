"""How often the profiler's device trace of a call loses kernel records,
and whether the host's launch records show it: the evidence behind
`chip_smoke.py::traced_window`'s test of a traced window.

A call of the packed frame package (AOTInductor, as phase 14 compiles it)
and of the eager bf16 frame is traced in many windows of three calls, each
after one untraced call, as `trace_device` traces them.  For each window:
the device records of the decode and NMS kernels a call, the device's
kernel records against the host's launch records (``cudaLaunchKernel``,
``cuLaunchKernel`` and their variants, one a kernel), and the device's
copies and fills against the host's ``cudaMemcpy*`` / ``cudaMemset*``.
Prints a JSON line a path: the readings' histogram, and how many windows
lost records by each test.

Run on a CUDA card: ``python3 probe_trace_records.py [--windows N]``; it
prints the card's name and power limit.
"""

import argparse
import json
import re
import tempfile
from collections import Counter
from pathlib import Path

import torch

from chip_smoke import card_line, export_bundle, native_frontend, serving_frames

LAUNCH = re.compile(r"^cu(da)?LaunchKernel")
KERNELS = ("decode_row_kernel", "grid_nms_kernel")


def window(fn, calls: int = 3) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev, host = Counter(), Counter()
    for e in prof.key_averages():
        if not e.count:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.key] += e.count
        else:
            host[e.key] += e.count
    copies = sum(n for k, n in dev.items() if k.startswith(("Memcpy", "Memset")))
    return {"named": tuple(sum(n for k, n in dev.items() if name in k) / calls
                           for name in KERNELS),
            "kernels": sum(dev.values()) - copies,
            "launch_api": sum(n for k, n in host.items() if LAUNCH.match(k)),
            "copies": copies,
            "copy_api": sum(n for k, n in host.items()
                            if k.startswith(("cudaMemcpy", "cudaMemset"))),
            "whole": all(n % calls == 0 for n in dev.values()),
            "api_names": sorted(k for k in host if "Launch" in k or "Graph" in k)}


def survey(name: str, fn, windows: int) -> None:
    rows = [window(fn) for _ in range(windows)]
    print(json.dumps({
        "path": name, "windows": windows,
        "named_readings": {str(k): v for k, v in Counter(r["named"] for r in rows).items()},
        "kernels_vs_launch_api": {f"{a}/{b}": n for (a, b), n in Counter(
            (r["kernels"], r["launch_api"]) for r in rows).items()},
        "copies_vs_copy_api": {f"{a}/{b}": n for (a, b), n in Counter(
            (r["copies"], r["copy_api"]) for r in rows).items()},
        "windows_not_whole": sum(not r["whole"] for r in rows),
        "windows_lost_by_launch_api": sum(r["kernels"] != r["launch_api"] for r in rows),
        "api_names": rows[0]["api_names"]}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=100)
    args = ap.parse_args()
    from torch._inductor import aoti_load_package

    print(f"card: {card_line()}")
    fe = native_frontend("live")
    key_frame, frames = serving_frames(0)
    rgb = lambda u8: torch.from_numpy(u8).cuda().float().div(255.0).expand(
        *u8.shape[:-1], 3).contiguous()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as work:
        secs = export_bundle(fe, "packed", Path(work))
        print(f"packed package exported and compiled in {secs:.1f} s")
        pk = aoti_load_package(str(Path(work) / "packed" / "model.pt2"))
        n = json.loads((Path(work) / "packed" / "meta.json").read_text())["top_n"]
        zero = (torch.zeros((n, fe.config.descriptor_dim), dtype=torch.float16, device="cuda"),
                torch.zeros((), dtype=torch.int32, device="cuda"))
        key_out = pk(rgb(key_frame[None]), *zero)
        key = (key_out[3], key_out[0])
        x = rgb(frames[:1])
        survey("package", lambda: pk(x, *key), args.windows)
        with torch.inference_mode():
            survey("eager_frame", lambda: fe.frame(x, *key), args.windows)
    print(card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
