#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0]

Phases, each a hard failure (non-zero exit) when it does not hold:

1. the card's name and power limit; build both CUDA kernels from
   `feature_point_cnn_tpu_torch/csrc/` (one nvcc each, in parallel);
2. decode: the kernel against its plain version on logits of the released
   weights at 480x640, B = 8 (max |diff| <= 1e-6, mask flips only where
   |p - t| <= 1e-6);
3. NMS: the kernel against its plain version, exactly, on the decode
   output, random maps, a monotone ramp and bit-identical plateaus;
4. end to end: `SuperPointFrontend(device="cuda").frame` on a keyframe and
   a batch of 8 frames whose first is the keyframe's scene shifted by 16 px;
   both kernels must have launched, with >= 30 matches of which >= 80% agree
   with the shift to 1 px.  The float32 path (TF32 off) is compared with
   the bf16 path;
5. timing: extract and frame ms/frame at B = 1 and 32, extract with the
   decode kernel on and off, a traced window of frame calls (device busy
   share, time by kernel), and each kernel against its plain version and
   its bound.

It prints a ``{"kernels": [...]}`` line, the card's line again, and last
``{"ok": true, "device": {...}}``.  With no CUDA device it exits 1 and
prints no result.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

H, W = 480, 640
SHIFT = 16           # px; a multiple of the 8-px cell keeps detections equivariant
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores


def polygon_scene(rng: np.random.Generator, h: int, w: int,
                  n_polygons: int = 40) -> np.ndarray:
    """A ``(h, w)`` float32 image in [0, 1]: a shaded background with
    random filled polygons (3-7 vertices) of random grey levels."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.3 + 0.2 * (xx / w) * rng.random() + 0.2 * (yy / h) * rng.random()
    for _ in range(n_polygons):
        n = int(rng.integers(3, 8))
        cy, cx = rng.random() * h, rng.random() * w
        rad = (0.04 + 0.12 * rng.random()) * min(h, w)
        ang = np.sort(rng.random(n) * 2 * np.pi)
        r = rad * (0.5 + 0.5 * rng.random(n))
        vy, vx = cy + r * np.sin(ang), cx + r * np.cos(ang)
        y0, y1 = max(int(vy.min()), 0), min(int(vy.max()) + 1, h)
        x0, x1 = max(int(vx.min()), 0), min(int(vx.max()) + 1, w)
        if y0 >= y1 or x0 >= x1:
            continue
        py, px = yy[y0:y1, x0:x1] + 0.5, xx[y0:y1, x0:x1] + 0.5
        inside = np.zeros(py.shape, bool)
        for i in range(n):  # even-odd crossing rule
            ay, ax, by, bx = vy[i], vx[i], vy[i - 1], vx[i - 1]
            crosses = (ay > py) != (by > py)
            xcross = ax + (py - ay) * (bx - ax) / (by - ay + 1e-12)
            inside ^= crosses & (px < xcross)
        img[y0:y1, x0:x1][inside] = rng.random()
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def shifted_pair(seed: int, h: int, w: int, shift: int):
    """Two u8 gray ``(h, w, 1)`` frames of one scene; content at x in the
    first lies at x - shift in the second."""
    scene = polygon_scene(np.random.default_rng(seed), h, w + shift)
    u8 = np.round(scene * 255).astype(np.uint8)[..., None]
    return u8[:, :w], u8[:, shift:shift + w]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def event_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median wall time of ``fn()`` ending in a device synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def prof_frame(fe, images, key_desc, key_num, card: str, calls: int = 5) -> None:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fe.frame(images, key_desc, key_num)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fe.frame(images, key_desc, key_num)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        (e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: -e.self_device_time_total,
    )
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    b = images.shape[0]
    print(f"profile b{b}: {calls} traced frame calls, wall {wall_ms:.3f} ms, "
          f"device {dev_ms:.3f} ms, busy share {dev_ms / wall_ms:.3f} [{card}]")
    for e in kernels[:12]:
        print(f"  {e.self_device_time_total / 1e3 / calls / b:9.5f} ms/frame "
              f"x{e.count // calls:<4d} {e.key[:90]}")


def nms_inputs(decoded: torch.Tensor, seed: int):
    """The NMS phase's inputs, each (B, H, W) float32 on the card."""
    rng = np.random.default_rng(seed + 1)
    dev = decoded.device
    out = {"decode_output": decoded}
    for dens in (0.01, 0.05, 0.3, 1.0):
        vals = rng.random((4, H, W)).astype(np.float32) * 0.9 + 0.05
        vals[rng.random((4, H, W)) >= dens] = 0.0
        out[f"random_{dens}"] = torch.from_numpy(vals).to(dev)
    ramp = np.arange(H * W, dtype=np.float32).reshape(1, H, W) / (H * W) * 0.9 + 0.05
    out["monotone_ramp"] = torch.from_numpy(ramp).to(dev)
    plate = np.zeros((4, H, W), np.float32)
    plate[0, 80:240, 80:240] = 0.25              # one constant block
    plate[1, ::2, ::2] = 0.9                     # tied checkerboard
    plate[2] = 0.015                             # whole-map plateau
    plate[3, 100:104, 100:104] = 0.5             # tied blocks closer than
    plate[3, 100:104, 110:114] = 0.5             # the window + an isolated
    plate[3, 300, 400] = 0.5                     # tied point
    out["plateaus"] = torch.from_numpy(plate).to(dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from feature_point_cnn_tpu_torch.config import SuperPointConfig
    from feature_point_cnn_tpu_torch.inference.wrapper import (
        SuperPointFrontend,
        extract_fn,
    )
    from feature_point_cnn_tpu_torch.ops import kernels
    from feature_point_cnn_tpu_torch.ops.detection import decode_prob_map
    from feature_point_cnn_tpu_torch.ops.kernels.decode import (
        decode_threshold_cuda,
        decode_threshold_plain,
    )
    from feature_point_cnn_tpu_torch.ops.kernels.nms import (
        grid_nms_cuda,
        grid_nms_plain,
    )
    from feature_point_cnn_tpu_torch.utils.weights import released_path

    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    logs = kernels.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs) or 'cached'}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line:
                print(f"  {name}: {line.strip()}")

    cfg = SuperPointConfig()
    weights = released_path()
    fe = SuperPointFrontend(cfg, weights_path=weights, device="cuda")
    print(f"weights: {weights} compute {cfg.compute_dtype}")
    t = cfg.confidence_thresh

    # 8 frames: the keyframe's scene shifted by SHIFT px, then 7 other scenes
    key_frame, moved = shifted_pair(args.seed, H, W, SHIFT)
    others = [shifted_pair(args.seed + 100 + i, H, W, 0)[0] for i in range(7)]
    batch_u8 = torch.from_numpy(np.stack([moved] + others)).cuda()
    batch = (batch_u8.float() / 255.0).expand(-1, -1, -1, 3).contiguous()

    # ---- 2. decode ------------------------------------------------------
    with torch.inference_mode():
        logits, _ = fe.model.features(batch)
        dec_k = decode_threshold_cuda(logits, cfg.cell, t)
        dec_p = decode_threshold_plain(logits, cfg.cell, t)
        prob = decode_prob_map(logits, cfg.cell)
    torch.cuda.synchronize()
    flip = (dec_k > 0) != (dec_p > 0)
    n_flip = int(flip.sum())
    check(bool(((prob[flip] - t).abs() <= 1e-6).all()), "decode mask flips only at |p-t|<=1e-6")
    dec_err = float((dec_k - dec_p).abs()[~flip].max())
    check(dec_err <= 1e-6, f"decode max|diff| {dec_err} <= 1e-6")
    print(f"decode: logits {tuple(logits.shape)} max|diff| {dec_err:.3g} "
          f"mask flips {n_flip} kept {int((dec_k > 0).sum())}")

    # ---- 3. NMS ---------------------------------------------------------
    nms_rounds = {}
    for name, scores in nms_inputs(dec_k, args.seed).items():
        got = grid_nms_cuda(scores, cfg.nms_dist)
        nms_rounds[name] = grid_nms_cuda.last_rounds
        want = grid_nms_plain(scores, cfg.nms_dist)
        check(torch.equal(got, want), f"NMS exact on {name}")
        print(f"nms: {name} {tuple(scores.shape)} exact, rounds "
              f"{nms_rounds[name]}, kept {int((got > 0).sum())}")

    # ---- 4. end to end: the main path ----------------------------------
    n = min(256, cfg.max_keypoints)
    decode_threshold_cuda.launches = 0
    grid_nms_cuda.launches = 0
    key_in = torch.from_numpy(key_frame[None]).cuda()
    zero_key = torch.zeros((n, cfg.descriptor_dim), dtype=torch.float16, device="cuda")
    k_num, k_packed, _, k_desc = fe.frame(key_in, zero_key, 0)
    num, packed, match_index, _ = fe.frame(batch_u8, k_desc[0], k_num[0])
    torch.cuda.synchronize()
    launches = {"decode_threshold": decode_threshold_cuda.launches,
                "grid_nms": grid_nms_cuda.launches}
    main_rounds = grid_nms_cuda.last_rounds
    print(f"main path launches: {launches} (last NMS rounds {main_rounds})")
    check(all(v > 0 for v in launches.values()), "both kernels ran on the main path")

    mi = match_index[0].cpu().numpy()
    p1, p0 = packed[0].cpu().numpy(), k_packed[0].cpu().numpy()
    m = mi >= 0
    dy = p1[m, 0] - p0[mi[m], 0]
    dx = p1[m, 1] - p0[mi[m], 1] + SHIFT
    on_shift = (np.abs(dy) <= 1) & (np.abs(dx) <= 1)
    n_match, frac = int(m.sum()), float(on_shift.mean()) if m.any() else 0.0
    print(f"e2e: keyframe {int(k_num[0])} kps, shifted frame {int(num[0])} kps, "
          f"{n_match} matches, {frac:.3f} on the {SHIFT}-px shift; "
          f"batch num_valid {num.tolist()}")
    check(n_match >= 30, f"{n_match} >= 30 matches")
    check(frac >= 0.8, f"{frac:.3f} >= 0.8 of matches on the shift")
    check(bool(torch.isfinite(packed).all()), "finite keypoints")

    # float32 with TF32 off against the bf16 path
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fe32 = SuperPointFrontend(cfg.replace(compute_dtype="float32"),
                              weights_path=weights, device="cuda")
    with torch.inference_mode():
        prob32 = fe32.model(batch)[0]
        prob16 = fe.model(batch)[0]
        kp32, _ = fe32.extract(batch)
        kp16, _ = fe.extract(batch)
    set32 = {(b, int(y), int(x)) for b in range(kp32.y.shape[0])
             for y, x, v in zip(kp32.y[b].tolist(), kp32.x[b].tolist(), kp32.valid[b].tolist()) if v}
    set16 = {(b, int(y), int(x)) for b in range(kp16.y.shape[0])
             for y, x, v in zip(kp16.y[b].tolist(), kp16.x[b].tolist(), kp16.valid[b].tolist()) if v}
    overlap = len(set32 & set16) / max(len(set32), 1)
    print(f"f32 vs bf16: prob max|diff| {float((prob32 - prob16).abs().max()):.4g}, "
          f"keypoint overlap {overlap:.4f} ({len(set32)} f32, {len(set16)} bf16)")
    del fe32
    torch.backends.cudnn.allow_tf32 = True

    # ---- 5. timing ------------------------------------------------------
    scenes = np.stack([shifted_pair(args.seed + 200 + i, H, W, 0)[0]
                       for i in range(8)])
    for b in (1, 32):
        imgs_u8 = torch.from_numpy(np.resize(scenes, (b, H, W, 1))).cuda()
        imgs_f = (imgs_u8.float() / 255.0).expand(-1, -1, -1, 3).contiguous()
        with torch.inference_mode():
            fw = host_median_ms(lambda: fe.model.features(imgs_f)) / b
        ex = host_median_ms(lambda: fe.extract(imgs_f)) / b
        fr = host_median_ms(lambda: fe.frame(imgs_u8, k_desc[0], k_num[0])) / b
        print(f"timing b{b}: extract {ex:.4f} ms/frame ({1e3 / ex:.1f} frames/s), "
              f"frame {fr:.4f} ms/frame ({1e3 / fr:.1f} frames/s), of which "
              f"forward {fw:.4f} ms/frame [{card}]")
        # the decode gate's A/B, in turns on/off/off/on: the TPU default
        # (off) does not carry over, so this run decides the port's default
        ab = {"on": [], "off": []}
        for gate in ("on", "off", "off", "on"):
            gcfg = cfg.replace(use_cuda_decode=gate)
            with torch.inference_mode():
                ab[gate].append(host_median_ms(
                    lambda: extract_fn(fe.model, imgs_f, gcfg)) / b)
        print(f"decode gate b{b}: extract on {ab['on']} off {ab['off']} "
              f"ms/frame [{card}]")

    # device busy share and time by kernel, from a traced window of 5 frame
    # calls (tracing adds host time, so the busy share is a lower bound)
    for b in (1, 32):
        imgs_u8 = torch.from_numpy(np.resize(scenes, (b, H, W, 1))).cuda()
        prof_frame(fe, imgs_u8, k_desc[0], k_num[0], card)

    ncell, npix = logits.shape[0] * logits.shape[1] * logits.shape[2], dec_k.numel()
    dec_bytes = logits.numel() * 4 + npix * 4
    dec_ops = ncell * 65 * 5      # sub, exp, add, div, compare per logit
    nms_ops = nms_rounds["decode_output"] * npix * (2 * 2 * 2 * cfg.nms_dist + 4)
    rows = [
        dict(name="decode_threshold", route="cuda",
             source="feature_point_cnn_tpu_torch/csrc/decode_threshold.cu",
             replaces="feature_point_cnn_tpu/ops/pallas/decode.py:41",
             launches=launches["decode_threshold"], max_abs_err=dec_err,
             ms=event_ms(lambda: decode_threshold_cuda(logits, cfg.cell, t), 100),
             plain_ms=event_ms(lambda: decode_threshold_plain(logits, cfg.cell, t), 100),
             bound_ms=1e3 * max(dec_bytes / HBM_BYTES_PER_S, dec_ops / FP32_OPS_PER_S),
             bound_by="bytes" if dec_bytes / HBM_BYTES_PER_S >= dec_ops / FP32_OPS_PER_S
             else "operations",
             library_ms=None, shape=list(logits.shape)),
        dict(name="grid_nms", route="cuda",
             source="feature_point_cnn_tpu_torch/csrc/grid_nms.cu",
             replaces="feature_point_cnn_tpu/ops/pallas/nms.py:112",
             launches=launches["grid_nms"], max_abs_err=0.0,
             ms=event_ms(lambda: grid_nms_cuda(dec_k, cfg.nms_dist), 20),
             plain_ms=event_ms(lambda: grid_nms_plain(dec_k, cfg.nms_dist), 20),
             bound_ms=1e3 * max(2 * npix * 4 / HBM_BYTES_PER_S, nms_ops / FP32_OPS_PER_S),
             bound_by="bytes" if 2 * npix * 4 / HBM_BYTES_PER_S >= nms_ops / FP32_OPS_PER_S
             else "operations",
             library_ms=None, shape=list(dec_k.shape),
             rounds=nms_rounds["decode_output"]),
    ]
    for r in rows:
        print(f"kernel {r['name']} {r['shape']}: {r['ms']:.4f} ms vs plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
