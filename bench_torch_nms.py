#!/usr/bin/env python3
"""Time the PyTorch port's NMS kernel against its own design choices on one
CUDA card.

    python3 bench_torch_nms.py [--seed 0]

Builds `feature_point_cnn_tpu_torch/csrc/grid_nms.cu` as it stands and with
its direct-mode threshold `kDirectMax` (listed (row, strip) pairs a pass
takes without walking the ring) set to other values: -1 (ring mode only),
32, 64, 128 and 1 << 30 (direct mode only), each into `build/nms_bench/`.
Each build runs on the same inputs: the decode output of the released
weights on B = 1, 8 and 32 scenes drawn by `chip_smoke.py`'s generator, and
a random map at 1.5% density (B = 8), checked bit for bit against
`grid_nms_plain` and timed with CUDA events over 20 back-to-back calls
after 3 warm-up calls.  Prints the card's name and power limit, then one
JSON line ``{"nms_variants": {name: {input: ms}}, ...}``.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

VARIANTS = {"ring_only": "-1", "direct_32": "32", "direct_64": "64",
            "direct_128": "128", "direct_only": "1 << 30"}
THRESHOLD = "constexpr int kDirectMax = "


def build_variants(out_dir) -> dict:
    """One shared library per threshold, all nvcc runs started together."""
    from feature_point_cnn_tpu_torch.ops.kernels import CSRC, NVCC_FLAGS, _nvcc
    from feature_point_cnn_tpu_torch.ops.kernels.nms import _SIGNATURES

    text = (CSRC / "grid_nms.cu").read_text()
    line = next(x for x in text.splitlines() if x.startswith(THRESHOLD))
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, value in {"as_built": None, **VARIANTS}.items():
        src = out_dir / f"grid_nms_{name}.cu"
        src.write_text(text if value is None else
                       text.replace(line, f"{THRESHOLD}{value};"))
        lib = out_dir / f"libgrid_nms_{name}.so"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        handle = ctypes.CDLL(str(lib))
        for fn, (restype, argtypes) in _SIGNATURES.items():
            getattr(handle, fn).restype = restype
            getattr(handle, fn).argtypes = list(argtypes)
        libs[name] = handle
    print(f"as built: {line.strip()}")
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch_nms: no CUDA device is available", file=sys.stderr)
        return 1

    from chip_smoke import H, W, card_line, shifted_pair
    from feature_point_cnn_tpu_torch.config import SuperPointConfig
    from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
    from feature_point_cnn_tpu_torch.ops.kernels import BUILD_DIR, stream_of
    from feature_point_cnn_tpu_torch.ops.kernels.decode import decode_threshold_cuda
    from feature_point_cnn_tpu_torch.ops.kernels.nms import grid_nms_plain, nms_layout
    from feature_point_cnn_tpu_torch.utils.weights import released_path

    card = card_line()
    print(f"card: {card}")
    libs = build_variants(BUILD_DIR.parent / "nms_bench")

    cfg = SuperPointConfig()
    fe = SuperPointFrontend(cfg, weights_path=released_path(), device="cuda")
    scenes = np.stack([shifted_pair(args.seed + 200 + i, H, W, 0)[0] for i in range(32)])
    with torch.inference_mode():
        imgs = (torch.from_numpy(scenes).cuda().float() / 255.0).expand(-1, -1, -1, 3)
        logits = fe.model.features(imgs.contiguous())[0]
        decoded = decode_threshold_cuda(logits, cfg.cell, cfg.confidence_thresh)
    vals = np.random.default_rng(args.seed).random((8, H, W), dtype=np.float32)
    vals[vals < 0.985] = 0.0
    inputs = {"decode_b1": decoded[:1].contiguous(), "decode_b8": decoded[:8].contiguous(),
              "decode_b32": decoded, "random_b8": torch.from_numpy(vals).cuda()}
    lay = nms_layout(H, W, cfg.nms_dist)

    def run(lib, x):
        out = torch.empty_like(x)
        rounds = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
        err = lib.grid_nms_launch(x.data_ptr(), out.data_ptr(), None, None, rounds.data_ptr(),
                                  x.shape[0], H, W, cfg.nms_dist, lay.cluster,
                                  int(lay.band_in_shared), stream_of(x))
        if err:
            raise RuntimeError(f"grid_nms_launch: CUDA error {err}")
        return out

    times = {}
    for name, lib in libs.items():
        times[name] = {}
        for iname, x in inputs.items():
            if not torch.equal(run(lib, x), grid_nms_plain(x, cfg.nms_dist)):
                raise RuntimeError(f"{name} is not exact on {iname}")
            for _ in range(3):
                run(lib, x)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(20):
                run(lib, x)
            end.record()
            torch.cuda.synchronize()
            times[name][iname] = start.elapsed_time(end) / 20
        print(f"{name}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times[name].items())
              + f" [{card}]")
    print(card_line())
    print(json.dumps({"nms_variants": times, "card": card, "all_exact": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
