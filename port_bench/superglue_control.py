"""The control of the SuperGlue cell's check: the plain reference with the
operands of its products rounded to fp8 (e4m3 under a per-tensor scale,
the nearest precision below the configuration's bf16) in the program's
place, judged by the same numbers as the program, on the CUDA device.  A
sound check calls it not correct.

    python3 port_bench/superglue_control.py --workload vgg_superglue.match_b32 --seeds <n> [<n> ...]

For each seed it draws the cell's frames and weights as a run does and
takes the first ``checked_calls`` calls of the rotation.  Detect and
describe: the fp8 VGG forward's keypoints against the float32 one's.  The
matcher: fp8 SuperGlue against float32 SuperGlue, both fed the float32
reference's keypoints and f16 descriptors of each frame and of its
keyframe (the call before's frame 0).  One JSON line a seed: the numbers
and the limits they fail.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def control(cfg: dict, tr: dict, seed: int, device) -> dict:
    import numpy as np
    import torch

    from port_bench.drivers.superglue_frame import detector_weights, seeded_superglue
    from port_bench.harness import scenes
    from port_bench.reference import superglue_frame as ref
    from port_bench.reference.precision import QUANT, fp8

    weights = detector_weights(cfg, seed, device)
    sg = seeded_superglue(cfg, seed, device)
    sg_cfg = {**cfg["superglue"], "descriptor_dim": cfg["descriptor_dim"]}
    frames = scenes.shifted_frames(seed, tr["scenes"], tr["shifts"], tr["height"], tr["width"])
    batches = scenes.batches(seed, len(frames), tr["batch"], tr["batches_in_rotation"])
    size = (tr["height"], tr["width"])

    def outputs(ex):
        return {"num_valid": ex["valid"].sum(1).cpu().numpy(),
                "kp": torch.stack([ex["y"], ex["x"], ex["score"]], -1).cpu().numpy(),
                "desc": ex["desc"].half().cpu().numpy()}

    per_frame = per_pair = None
    key = None
    for r in range(min(tr["checked_calls"] + 1, len(batches))):
        want = ref.extract(cfg, weights, frames[batches[r]], device, QUANT["float32"])
        frame = outputs(want)
        if r:       # call 0 only gives call 1 its keyframe
            low = ref.extract(cfg, weights, frames[batches[r]], device, QUANT["fp8"])
            part = ref.detect_frames(outputs(low), want, tr["width"])
            per_frame = part if per_frame is None else {k: per_frame[k] + part[k] for k in part}
            exact = ref.match_pairs(sg, sg_cfg, frame, key, size, device)
            rounded = ref.match_pairs(sg, sg_cfg, frame, key, size, device, q=fp8)
            n = frame["kp"].shape[1]
            index = np.full((len(rounded), n), -1)
            score = np.zeros((len(rounded), n))
            for b, p in enumerate(rounded):
                index[b, :len(p["index"])] = p["index"]
                if p["log_best"] is not None:
                    score[b, :len(p["log_best"])] = np.exp(p["log_best"])
            part = ref.matcher_pairs(index, score, frame["num_valid"], exact)
            per_pair = part if per_pair is None else {k: per_pair[k] + part[k] for k in part}
        key = {"num": frame["num_valid"][0], "kp": frame["kp"][0], "desc": frame["desc"][0]}
    return {**ref.detect_numbers(per_frame), **ref.matcher_numbers(per_pair)}


def main(argv=None) -> int:
    import torch

    from port_bench.harness import core
    from port_bench.reference.precision import float32_mode

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="vgg_superglue.match_b32")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = core.load_json(ROOT / "BENCHMARK.json")
    _, cfg, tr, _, _ = core.cell_spec(bench, args.workload)
    limits = core.load_json(core.HERE / "limits" / f"{args.workload}.json")
    float32_mode()
    for seed in args.seeds:
        numbers = control(cfg, tr, seed, torch.device(args.device))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "failed_limits": [k for k, v in limits.items() if numbers[k] > v],
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
