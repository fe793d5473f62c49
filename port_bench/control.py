"""The control of a cell's check: the plain reference put in the program's
place, its convolutions in fp8 (the nearest precision below the
configurations' bf16), judged by the same comparison as the program, on
the CUDA device.  A sound check calls it not correct.

    python3 port_bench/control.py --workload <name> --seeds <n> [<n> ...] [--fault half_batch]

For each seed it draws the cell's frames as a run does, takes the first
``checked_calls`` calls of the cell's rotation (each with the keyframe of
the call before), and prints one JSON line of the numbers compared and
their limits.  The benchmark's runs never run it; the limits in
``limits/`` were set between these readings and the program's.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def frame_control(cfg, tr, seed, device) -> dict:
    """The frame cells: reference and control over the sampled calls."""
    from port_bench.harness import scenes
    from port_bench.reference import compare
    from port_bench.reference.frame import ResNetFrame, serve
    from port_bench.reference.models import load_resnet_npz

    weights = load_resnet_npz(str(ROOT / cfg["weights"]), device)
    ref = ResNetFrame(cfg, weights, device)
    low = ResNetFrame(cfg, weights, device, "fp8")
    frames = scenes.shifted_frames(seed, tr["scenes"], tr["shifts"], tr["height"], tr["width"])
    batches = scenes.batches(seed, len(frames), tr["batch"], tr["batches_in_rotation"])
    per_frame = None
    for r in range(min(tr["checked_calls"], len(batches))):
        key = [None if r == 0 else frames[batches[r - 1][0]]] * tr["batch"]
        want = serve(ref, frames[batches[r]], key)
        got = serve(low, frames[batches[r]], key)
        part = compare.frames(got, want, tr["width"])
        per_frame = part if per_frame is None else {k: per_frame[k] + part[k] for k in part}
    return compare.frame_numbers(per_frame)


def forward_control(cfg, tr, seed, device) -> dict:
    """The forward cells: the maps of the sampled calls."""
    from port_bench.drivers.forward import named, seeded_weights
    from port_bench.harness import scenes
    from port_bench.reference import compare
    from port_bench.reference.precision import QUANT

    weights = seeded_weights(cfg, seed, device)
    frames = scenes.shifted_frames(seed, tr["scenes"], tr["shifts"], tr["height"], tr["width"])
    batches = scenes.batches(seed, len(frames), tr["batch"], tr["batches_in_rotation"])
    worst, maps = {}, named(cfg["reference"])
    for r in range(min(tr["checked_calls"], len(batches))):
        want = maps(cfg, weights, frames[batches[r]], device, QUANT["float32"])
        got = maps(cfg, weights, frames[batches[r]], device, QUANT["fp8"])
        for k, v in compare.maps(got, want).items():
            worst[k] = max(v, worst.get(k, 0.0))
    return worst


def train_control(cfg, tr, seed, device, fault=None) -> dict:
    """The training cell: the reference's three steps in fp8 training, or
    with ``fault="half_batch"`` in float32 on the first half of each batch
    (the mean taken over the rest), against the float32 reference."""
    import numpy as np
    import torch

    from port_bench.harness import scenes
    from port_bench.reference import compare
    from port_bench.reference.precision import QUANT
    from port_bench.reference.train import reference_steps, resnet_params

    data = scenes.scene_split(seed, tr["scenes"], tr["height"], tr["width"], cfg["max_points"])
    init = resnet_params(cfg, device, torch.Generator(device=device).manual_seed(seed))
    order = np.random.default_rng([seed, 3]).permutation(tr["scenes"])
    b = tr["batch"]
    batches = [order[i * b:(i + 1) * b] for i in range(3)]
    step_seed = seed % (1 << 20)
    ref = reference_steps(cfg, init, data, batches, step_seed, device, QUANT["float32"])
    if fault == "half_batch":
        low = reference_steps(cfg, init, data, [x[:b // 2] for x in batches], step_seed,
                              device, QUANT["float32"])
    else:
        low = reference_steps(cfg, init, data, batches, step_seed, device, QUANT["fp8"])
    return compare.train(low, ref, init)


CONTROLS = {"frame": frame_control, "forward": forward_control, "train_steps": train_control}


def main(argv=None) -> int:
    import torch

    from port_bench.harness import core
    from port_bench.reference.precision import float32_mode

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None, choices=("half_batch",),
                    help="training only: a planted fault in place of the lower precision")
    args = ap.parse_args(argv)
    bench = core.load_json(ROOT / "BENCHMARK.json")
    _, cfg, tr, _, _ = core.cell_spec(bench, args.workload)
    limits = core.load_json(core.HERE / "limits" / f"{args.workload}.json")
    float32_mode()
    device = torch.device("cuda")
    for seed in args.seeds:
        kw = {"fault": args.fault} if args.fault else {}
        numbers = CONTROLS[tr["driver"]](cfg, tr, seed, device, **kw)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault,
                          "failed_limits": [k for k, v in limits.items() if numbers[k] > v],
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
