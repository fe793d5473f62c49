"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``.  With
``--trace 0`` the result's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiler trace of (at most
2 s of) the window.  The last line of standard output is the result's
JSON object; the numbers compared with the plain reference are the last
lines of standard error.  Without a CUDA device, or with fewer than the
cell asks for, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the wall clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


T_START = _process_start()

import argparse  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from port_bench.harness import core

    bench = core.load_json(ROOT / "BENCHMARK.json")
    cell = core.cell_spec(bench, args.workload)[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        core.log(f"[bench] {args.workload} needs {cell['chips']} CUDA device(s), "
                 f"found {n}; the benchmark does not run on the CPU")
        return 2
    result = core.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START)
    core.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
