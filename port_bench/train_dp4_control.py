"""The controls of the data-parallel training cell's check, on one card: the
reference's three steps at the global batch (``ranks x batch``) in fp8
training, or with ``--fault half_batch`` on half of each global batch,
against the float32 reference (`control.train_control` at that batch).  A
sound check calls each not correct.

    python3 port_bench/train_dp4_control.py --seeds <n> [<n> ...] [--fault half_batch]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

WORKLOAD = "resnet.train_dp4"


def main(argv=None) -> int:
    import torch

    from port_bench.control import train_control
    from port_bench.harness import core
    from port_bench.reference.precision import float32_mode

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None, choices=("half_batch",))
    args = ap.parse_args(argv)
    bench = core.load_json(ROOT / "BENCHMARK.json")
    _, cfg, tr, _, _ = core.cell_spec(bench, WORKLOAD)
    limits = core.load_json(core.HERE / "limits" / f"{WORKLOAD}.json")
    tr = {**tr, "batch": tr["batch"] * tr["ranks"]}
    float32_mode()
    for seed in args.seeds:
        numbers = train_control(cfg, tr, seed, torch.device("cuda"), fault=args.fault)
        print(json.dumps({"workload": WORKLOAD, "seed": seed, "fault": args.fault,
                          "failed_limits": [k for k, v in limits.items() if numbers[k] > v],
                          "numbers": {k: v for k, v in numbers.items() if k != "worst_leaves"}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
