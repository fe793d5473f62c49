#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, self-labeling, evaluation,
tracking, command-line, parallel and native serving paths on one CUDA card
and check them.

    python3 chip_smoke.py [--seed 0]

Phases, each a hard failure (non-zero exit) when it does not hold:

1. the card's name and power limit; whether cv2, PIL, sklearn and
   tensorboard can be found here, with their versions (nothing imported);
   build the CUDA kernels from `feature_point_cnn_tpu_torch/csrc/` (one
   nvcc each, in parallel);
2. decode: the kernel against its plain version on logits of the released
   weights at 480x640, B = 8 and 32, and on ragged (1, 9, 11) logits (max
   |diff| <= 1e-6, mask flips only where |p - t| <= 1e-6); a trace shows
   one CUDA launch a call;
3. NMS: the kernel against its plain version, exactly, on the decode
   output, random maps, a monotone ramp, bit-identical plateaus, a
   1080x1920 map (its bands in device memory) and 33 frames (more clusters
   than run at once); the device's rounds a frame equal the plain loop's; a
   trace shows one CUDA launch a call on the decode output and the ramp;
4. end to end: `SuperPointFrontend(device="cuda").frame` on a keyframe and
   a batch of 8 frames whose first is the keyframe's scene shifted by 16 px;
   both kernels must have launched, with >= 30 matches of which >= 80% agree
   with the shift to 1 px.  The float32 path (TF32 off) is compared with
   the bf16 path;
5. timing: extract and frame ms/frame at B = 1 and 32, a traced window of
   frame calls (device busy
   share, time by kernel), and each kernel against its plain version and
   its bound; the ``fold_bn`` A/B: at float32 (TF32 off) folded prob maps
   within 1e-5 of live BatchNorm's, the same keypoints, no BatchNorm kernel
   in the folded trace; at bf16 frame ms/frame folded and live in turns at
   B = 1 and 32;
6. descriptor loss: the forward and backward kernels against the plain
   version (float32, TF32 off) at three small shapes, at shapes that cross
   every edge of the kernels' tiling (N = 195 = 128 + 64 + 3 with D = 128
   and D = 8) and two that the wrapper pads to whole k-steps (D = 12, 100),
   on all-zero descriptors, and at (32, 30, 40, 128) on descriptors of the
   released weights for a batch of scenes and their warps.  Tolerances:
   value rtol 2e-5; gradients rtol 2e-4 + atol 2e-6 (at full width the atol
   is 2e-6 of the largest gradient entry, since the raw sum's gradients
   reach ~100); a second run equal bit for bit.
   One float32 `torch.bmm` at the same size, TF32 off and on, is timed as
   the card's own yardstick of one product (the port never calls it);
7. training: 20 joint `superpoint_train_step`s through `Trainer` at 240x320,
   batch 32, bf16, fresh seeded parameters, on scenes drawn with numpy: the
   forward and the backward wrapper each launched its kernels once a step
   (a wrapper call is several CUDA launches, counted in the traced window of
   the last phase), everything finite, all heads and the
   running statistics moved, the loss fell; one MagicPoint step leaves the
   descriptor head alone; a joint step with the loss's plain version in
   place of the kernels (`plain_desc_loss`) gives the same loss (rtol 1e-4);
8. training timing: ms/step, its parts, a traced window of 3 steps, peak
   memory;
9. self-labeling: 64 polygon scenes written as 24-bit BMPs at 480x640 and
   labelled by `preprocess_folder` with the MagicPoint snapshot, bf16,
   ``HomographyConfig.for_preprocess()`` (15 warps), batch 16, 240x320: 64
   items of finite in-frame points; decode launched twice a batch and NMS
   once; shards 0/2 and 1/2 equal to the single run bit for bit; one batch
   through the adaptation stages (each timed, ending in a synchronise) equal
   to the written labels; the decode kernel and the plain decode give
   aggregated maps within 1e-5, and the NMS kernel equals plain NMS on that map exactly; a
   traced batch shows both kernels; images/s, busy share, peak memory; both
   kernels at the self-labeling shapes against their plain versions;
10. evaluation: `evaluate_pairs` on 16 scenes at 240x320, K = 512, with the
   released weights under the default and the mild homography family
   (every metric finite but cv2's, decode and NMS once an extract); the
   card's float32 run against the port's CPU run on 4 pairs (within 0.02 on
   repeatability and matching score); RANSAC on the card on exact
   correspondences (< 0.1 px); a 2-sequence HPatches layout written as PPM
   (repeatability 1.0 on its identity sequence);
11. the training data path at full width (240x320, batch 32): 160 polygon
   scenes written as npz items and packed by `pack_split`, opened by
   `PackedPointDataset` and `make_loader` (a `DeviceBatchLoader`, whose
   batches equal the packed rows); MagicPoint and SuperPoint `Trainer`
   epochs with ``train_steps_per_call`` 1 (eager steps) and 4 (replays of
   the captured CUDA graph of the step) at float32, TF32 off, cuDNN
   deterministic: parameters equal within rtol 2e-4 + atol 2e-5 (and
   whether bit-equal); the descriptor-loss kernels in a trace of the
   replays; ``metrics.jsonl`` and the overlay image written (through the
   decode and NMS kernels); eager against graphed ms/step, images/s and
   busy share at bf16; `generate_dataset`'s images/s on the host where cv2
   is installed;
12. tracking, bundle adjustment, VGG and the command line: `eval.tracking.
   main` with the released weights at its defaults (240x320, K = 512, bf16)
   on ``--source synthetic`` and on a polygon scene written as a BMP, 40
   frames and 80 with ``--loops 2 --posegraph`` (on the polygon with a
   96-px sweep, whose loop closures must lower the ATE; decode and NMS
   once a frame); `Tracker.process` ms/frame with its extract apart, and a trace
   of one call (one decode and one NMS launch); the 40-frame sequences at
   float32 on the card against the CPU (ATE within 0.1 px + 5%, keyframes
   within 1, frac_tracked within 0.05); `bundle_adjust` against
   `dense_bundle_adjust_reference` at (P, L, M) = (6, 48, 4) (costs rtol
   1e-4, poses and points 2e-4), then 10 iterations at P = 64, L = 16,384,
   M = 4 (cost down 100x, within 5e-3 of the truth; ms an iteration, peak
   memory); the VGG forward at 480x640 gray, B = 1 and 8, float32 against
   the CPU (prob 1e-4) and ms/frame; `main.main` ``inference`` (60 frames),
   ``train`` as MagicPoint on phase 11's packed split and then joint (the
   descriptor-loss wrappers called), ``export --raw-weights --out`` (the
   ``.npz`` and the checkpoint directory give the same keypoints; the
   `torch.export` program loaded back gives the frontend's keypoints at
   480x640, >= 99% shared);
13. the parallel layer, its ranks processes of this script (``--parallel-
   worker``; the kernels phase 1 built are loaded, not rebuilt), at float32,
   TF32 off, cuDNN deterministic unless said.  Two ranks sharing the one
   card over gloo: one joint `superpoint_train_step` at 240x320, global
   batch 32 (16 a rank), fresh seeded parameters, with ``microbatch_steps``
   1 and 2: loss within rtol 1e-5 of this process's step on the global
   batch, gradients within atol 1e-3 + rtol 1e-2, parameters and BatchNorm
   statistics bit-identical across the ranks, the descriptor-loss kernels
   launched on each; a `Trainer` epoch on the item-sharded
   `DeviceBatchLoader` over phase 11's packed split (global batches equal
   the numpy reference order, rank 0 alone writes the checkpoint);
   `extract_sharded` with the released weights at 480x640, B = 8 (each
   rank's rows bit-equal to `extract` of those rows, the whole batch equal
   to the B = 8 extract: keypoints exactly, descriptors 1e-5; decode and
   NMS on each rank); `preprocess_folder(use_mesh=True)` on 32 of phase
   9's scenes at batch 16 under phase 9's settings (bf16), equal to phase
   9's files bit for bit; `bundle_adjust` over the mesh at P = 64, L =
   16,384, M = 4 (costs rtol 1e-5, poses and points 1e-4 of one rank);
   one 480x640 image W-sharded over the two ranks (480x320 a rank,
   `shard_images_spatial` and `width_group`) through the released model:
   float32 with TF32 off gathered equal to this process's forward (prob
   2e-4, descriptors and logits 1e-4), both ranks' gathered outputs bit
   for bit, 13 exchanges a forward none larger than the max pool's halo,
   no wrapper launched; the same at 8 px a shard (480x16, float32) and
   for a seeded VGG on the gray image (10 exchanges); `extract_spatial`
   of the image at float32 and bf16: the ranks' outputs bit for bit, one
   decode and one NMS launch a rank a call, at float32 >= 0.99 of this
   process's `extract` keypoints with descriptors within 1e-4 where both
   hold the keypoint (bf16 >= 0.9); printed: the bf16 prob map's distance
   from this process's and the top-256 keypoint overlap, bf16 ms a
   sharded forward and peak MiB a rank at 480x640 and 1920x2560 against
   one process, bf16 ms a sharded extract against one process's extract,
   ms a score-map gather, and the bytes a call carries.  W-sharded
   training on the same two ranks: `superpoint_train_step` and
   `magicpoint_train_step` (descriptor frozen) at 240x320 on 2 scenes,
   `SuperPointConfig()`'s widths, seeded parameters, Adam's epsilon 1,
   float32 with TF32 off, against this process's one-process step from the
   same parameters, batch and generator: the loss and its parts rtol 1e-5,
   the F1 within 1e-3, gradient norms rtol 1e-3, parameters atol 2e-6 +
   rtol 1e-4, BatchNorm statistics atol 2e-5 + rtol 1e-4, the ranks'
   parameters and statistics bit for bit, the descriptor-loss kernels
   launched once forward and once backward a rank in the SuperPoint step
   (one item each) and held to the plain version on the inputs the step
   gave them; printed: the gathers' bytes a step, bf16 ms a step a rank
   against one process and peak MiB a rank at 960x1280, B = 1, bf16,
   against one process.
   One rank over NCCL: a joint step from fresh parameters on the global
   batch (loss rtol 1e-5 and gradients atol 1e-3 + rtol 1e-2 of this
   process's step; the parameters' difference is Adam's first update of
   the gradients' difference within rtol 2e-4 + atol 2e-5), then `Trainer`
   epochs with ``train_steps_per_call`` 4 (graph replays with the step's
   collectives captured) and 1 (eager) at Adam's epsilon 1, each within
   rtol 2e-4 + atol 2e-5 of the other and the graphed one of this
   process's non-distributed graphed epoch; a width mesh of one rank gives
   the plain forward and `extract` bit for bit (`extract_spatial`), and
   `spatial.halo` over NCCL pads a block bit for bit.  bf16 ms/step of the two-rank
   step and of this process's step, printed as two processes sharing one
   card, not scaling;
14. export and native serving: the frame program of the released weights
   at 480x640 exported by `SuperPointFrontend.export_native` and compiled
   by AOTInductor on the card (its graph holds both ``fpc`` ops): packed
   B = 1 f32 RGB with live BatchNorm (export's default, bf16), compiled
   in a process of this script beside phase 1's build
   (``--native-compile``), then in turn the full ABI of the same model
   and u8 gray B = 8 and B = 32 from the folded model (bf16).  The packed package on phase 4's keyframe and frames launches
   decode and NMS once a call (counted and traced) and equals the eager
   `frame` at `tests/test_torch_frontend.py`'s tolerances (counts equal,
   >= 99% of rows at the same pixel, coordinates and scores 1e-5,
   descriptors 1e-3, >= 99% of matches), with >= 30 matches on the
   shifted frame; so do the full ABI against its program run eagerly and
   u8 gray B = 8 against the folded eager frame on f32 RGB.  The eager
   bf16 frame's and the package's distances from the float32 frame (TF32
   off) are printed.  The package's ms/frame beside the live and the folded
   eager frame at B = 1 and 32, in turns.  The native host (`csrc/serve/`)
   built by `inference/native.py` with g++ beside the compiles, its camera
   self-test, then 200 frames of ``--source synthetic`` (pipeline depths
   1, 2, 4) and of a replay of a panned scene for the B = 1 and B = 8
   packages: the replay's ``exec`` lines equal Python's run of the package
   (`replay_exec_lines`);
15. SuperGlue's Sinkhorn kernel (`sinkhorn_phase`, in a process of this
   script of its own): a SuperGlue at the published widths on 32 pairs of
   1024 keypoints calls it once a call;
   on its scores the kernel equals the plain loop (the same -inf entries,
   no NaN, max|dZ| <= 1e-5 of max|Z|) on full and ragged pairs; a trace
   shows 2 * 100 + 1 launches a call; its device time beside its bounds
   (the couplings read once an iteration; two exponentials an entry an
   iteration) and the plain loop's time;
16. the VGG's convolution epilogue (`conv_epilogue_phase`): the kernel
   alone at each of the VGG's twelve layer shapes at B = 32, 480x640, bit
   for bit its plain passes, one CUDA launch a call; its device time (a
   trace, warm) and its time after a 256 MB write beside its bytes bound
   and the plain passes' time; then traces of the bf16 VGG forward at B =
   32 through the kernel and through the plain passes (autograd on), for
   the benchmark's module and a channels-last one: 12 kernel launches a
   forward and none of the passes' kernels, the forward's device time by
   kernel, `nchwToNhwc`'s time.

The decode and NMS rows of the ``{"kernels": [...]}`` line hold, at B = 8
and under ``b32`` at B = 32, the kernel's device time from a trace
(``device_ms``), CUDA events over back-to-back calls (``ms``, warm) and
around single calls after a 256 MB write (``cold_ms``); the bound is held
against ``cold_ms``.
Their ``launches`` count the serving path's calls; ``launches_selflabel``
and ``launches_eval`` those of phases 9 and 10, each counted from 0 just
before its path, and ``selflabel_shape`` the kernel at the self-labeling
shape (decode at threshold 0 on the 240 warped views, NMS on the 16
aggregated maps).  ``launches_train_data`` counts each kernel's launches in
phase 11 (a CUDA graph replay counts what its capture counted: the
descriptor-loss rows count the eager steps, the capture's warm-up and the
replays, and ``graph_replay_kernels_traced`` gives the kernels a trace of
one call of 4 replays shows); ``launches_tracking`` (rows 1-2) counts phase
12's tracking entry-point runs and ``launches_cli`` each wrapper's calls in
phase 12's command line; ``launches_parallel`` each wrapper's calls in phase 13,
summed over its processes (``launches_parallel_by_rank``: gloo rank 0,
gloo rank 1, the NCCL rank), each counted from 0 before its path, and
``launches_spatial`` each wrapper's calls in phase 13's W-sharded scenario
(the forwards decode with the plain version; each `extract_spatial` call
launches one decode and one NMS a rank: two calls on each gloo rank, one
on the NCCL rank's width mesh of one; the W-sharded SuperPoint step one
descriptor-loss forward and backward a gloo rank).

``launches_native`` counts each wrapper's launches in phase 14's main path
(the package's calls in this process; the host launches through its own
op library and is not counted).

It prints a ``{"kernels": [...]}`` line, the card's line again, and last
``{"ok": true, "device": {...}}``.  With no CUDA device it exits 1 and
prints no result.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from feature_point_cnn_tpu_torch.utils import profiling

H, W = 480, 640
SHIFT = 16           # px; a multiple of the 8-px cell keeps detections equivariant
TRAIN_STEPS = 20     # joint steps of phase 7: 4 epochs of 160 scenes at batch 32
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
TF32_OPS_PER_S = 495e12     # H100 SXM, TF32 on the tensor cores, dense
# descriptor-loss kernels before their tensor-core redesign (float32 FMA
# sweeps), NVIDIA H100 80GB HBM3 at 700 W, (32, 1200, 128): forward, backward.
# Printed beside this run's times, never part of the result lines.
DL_PREVIOUS_MS = {"fwd": 2.1473, "bwd": 3.6489}
# decode and NMS before their redesign (one warp a cell; two launches a
# round with the host reading a flag), NVIDIA H100 80GB HBM3 at 700 W, B = 8,
# events back to back.  Printed beside this run's times only.
PREVIOUS_MS = {"decode_threshold": 0.0259, "grid_nms": 0.3348}
# the descriptor-loss kernels as a trace names them, with the N x N x D
# products a launch of each runs (a gradient sweep rebuilds a and multiplies
# dg by the chunk)
DL_KERNEL_PRODUCTS = {"wgmma_sweep_kernel": 1, "wgmma_grad_kernel": 2,
                      "split_kernel": 0, "split_transposed_kernel": 0,
                      "sum_kernel": 0}
DL_KERNEL_NAMES = tuple(DL_KERNEL_PRODUCTS)


def polygon_scene(rng: np.random.Generator, h: int, w: int,
                  n_polygons: int = 40, return_points: bool = False):
    """A ``(h, w)`` float32 image in [0, 1]: a shaded background with
    random filled polygons (3-7 vertices) of random grey levels.  With
    ``return_points`` also the ``(N, 2)`` ``(y, x)`` corner points: the
    polygons' vertices that lie in the image and that no later polygon
    covers."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.3 + 0.2 * (xx / w) * rng.random() + 0.2 * (yy / h) * rng.random()
    corners = np.zeros((0, 2), np.float32)
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
        if return_points:
            cy_, cx_ = corners[:, 0].astype(int), corners[:, 1].astype(int)
            inbox = (cy_ >= y0) & (cy_ < y1) & (cx_ >= x0) & (cx_ < x1)
            covered = np.zeros(len(corners), bool)
            covered[inbox] = inside[cy_[inbox] - y0, cx_[inbox] - x0]
            new = np.stack([vy, vx], -1).astype(np.float32)
            new = new[(vy >= 0) & (vy <= h - 1) & (vx >= 0) & (vx <= w - 1)]
            corners = np.concatenate([corners[~covered], new])
    img = np.clip(img, 0.0, 1.0).astype(np.float32)
    return (img, corners) if return_points else img


def write_bmp(path, rgb: np.ndarray) -> None:
    """An ``(h, w, 3)`` uint8 RGB image as an uncompressed 24-bit BMP."""
    h, w, _ = rgb.shape
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)     # bottom-up BGR
    header = (b"BM" + (54 + rows.size).to_bytes(4, "little") + bytes(4)
              + (54).to_bytes(4, "little") + (40).to_bytes(4, "little")
              + w.to_bytes(4, "little") + h.to_bytes(4, "little")
              + (1).to_bytes(2, "little") + (24).to_bytes(2, "little")
              + bytes(4) + rows.size.to_bytes(4, "little") + bytes(16))
    with open(path, "wb") as f:
        f.write(header + rows.tobytes())


def write_ppm(path, rgb: np.ndarray) -> None:
    """An ``(h, w, 3)`` uint8 RGB image as a binary PPM (P6)."""
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode() + np.ascontiguousarray(rgb).tobytes())


def exact_correspondences(seed: int, k: int = 200, outliers: float = 0.3):
    """``(pts1, pts2, valid, h_flat)``: ``k`` ``(y, x)`` points of a 240x320
    view 1 and their exact images under a mild homography in view 2 (``pts1
    = H pts2`` with ``h_flat`` output->input), a share ``outliers`` of them
    moved at random, and all valid."""
    rng = np.random.default_rng(seed)
    h_mat = np.array([[1.05, 0.03, 6.0], [-0.02, 0.97, -4.0], [2e-4, -1e-4, 1.0]])
    pts2_xy = rng.uniform([10, 10], [310, 230], (k, 2))
    p = np.concatenate([pts2_xy, np.ones((k, 1))], 1) @ h_mat.T
    pts1_xy = p[:, :2] / p[:, 2:]
    bad = rng.random(k) < outliers
    pts1_xy[bad] = rng.uniform([0, 0], [320, 240], (int(bad.sum()), 2))
    h_flat = (h_mat.reshape(9) / h_mat[2, 2])[:8].astype(np.float32)
    return (pts1_xy[:, ::-1].astype(np.float32), pts2_xy[:, ::-1].astype(np.float32),
            np.ones(k, bool), h_flat)


class SceneDataset:
    """An in-memory dataset of polygon scenes for `BatchLoader`:
    ``read(i) -> (image (h, w, 3) float32, points (N, 2) (y, x))``."""

    def __init__(self, seed: int, size: int, h: int, w: int):
        rng = np.random.default_rng(seed)
        self.items = []
        for _ in range(size):
            img, pts = polygon_scene(rng, h, w, n_polygons=20, return_points=True)
            self.items.append((np.repeat(img[..., None], 3, axis=-1), pts))

    def __len__(self) -> int:
        return len(self.items)

    def read(self, index: int):
        return self.items[index]


def serving_frames(seed: int):
    """Phase 4's keyframe and its 8 frames ``(8, H, W, 1)`` uint8: the
    keyframe's scene shifted by SHIFT px, then 7 other scenes."""
    key_frame, moved = shifted_pair(seed, H, W, SHIFT)
    others = [shifted_pair(seed + 100 + i, H, W, 0)[0] for i in range(7)]
    return key_frame, np.stack([moved] + others)


def shifted_pair(seed: int, h: int, w: int, shift: int):
    """Two u8 gray ``(h, w, 1)`` frames of one scene; content at x in the
    first lies at x - shift in the second."""
    scene = polygon_scene(np.random.default_rng(seed), h, w + shift)
    u8 = np.round(scene * 255).astype(np.uint8)[..., None]
    return u8[:, :w], u8[:, shift:shift + w]


def replay_exec_lines(model, meta: dict, frames: np.ndarray, device) -> list:
    """Python's run of a native package ``model`` (``aoti_load_package`` or
    an exported module) over raw float32 ``(F, H, W, C)`` frames, as the
    host runs it (`feature_point_cnn_tpu_torch/csrc/serve/
    superpoint_serve.cc`): batches of ``meta["batch"]`` frames, u8 staged as
    the host quantizes, the first execute's outputs fed back as the keyframe.
    Returns the host's ``exec`` lines without the latency, ``(exec,
    keypoints, matches)`` for the first three executes and the last."""
    from feature_point_cnn_tpu_torch.inference.wrapper import DTYPES

    b, packed = meta["batch"], meta["abi"] == "packed"
    key_desc, key = (torch.zeros(s["shape"], dtype=DTYPES[s["dtype"]], device=device)
                     for s in meta["inputs"][1:])
    execs = len(frames) // b
    lines = []
    for f in range(execs):
        x = frames[f * b:(f + 1) * b]
        if meta["input_dtype"] == "u8":
            x = np.clip(x * np.float32(255.0) + np.float32(0.5), 0, 255).astype(np.uint8)
        outs = model(torch.from_numpy(x).to(device), key_desc, key)
        if packed:
            counts = (int(outs[0].sum()), int((outs[2] >= 0).sum()))
            feedback = (outs[4], outs[5]) if b > 1 else (outs[3], outs[0])
        else:
            counts = (int(outs[3].sum()), int(outs[5].sum()))
            feedback = (outs[6], outs[3])
        if f == 0:
            key_desc, key = feedback
        if f < 3 or f + 1 == execs:
            lines.append((f, *counts))
    return lines


def untied_flips(a: dict, b: dict, t: float, radius: int, k: int, tol: float) -> tuple:
    """The keypoints that one of two extracts ``a``, ``b`` of one image
    (B = 1: fields ``y``, ``x``, ``score``, ``valid``) holds and the other
    does not, and those of them that no tie of two maps within ``tol``
    explains: a score within ``tol`` of the threshold ``t``, of a keypoint
    of the other extract within the NMS ``radius``, or of the K-th score
    where ``k`` keypoints fill the extract.  ``(flips, untied)``."""
    def points(e):
        v = e["valid"][0]
        return {(float(y), float(x)): float(sc) for y, x, sc in
                zip(e["y"][0][v].tolist(), e["x"][0][v].tolist(), e["score"][0][v].tolist())}

    pa, pb = points(a), points(b)
    flips = untied = 0
    for mine, other in ((pa, pb), (pb, pa)):
        last = min(mine.values()) if len(mine) == k else None
        for (y, x), sc in mine.items():
            if (y, x) in other:
                continue
            flips += 1
            tied = (abs(sc - t) <= tol or (last is not None and abs(sc - last) <= tol)
                    or any(abs(oy - y) <= radius and abs(ox - x) <= radius
                           and abs(osc - sc) <= tol for (oy, ox), osc in other.items()))
            untied += not tied
    return flips, untied


def keypoint_overlap(a, b) -> float:
    """The share of keypoint set ``b``'s ``(y, x)`` that ``a`` holds too;
    each a ``(y, x, valid)`` of ``(B, K)`` tensors or arrays."""
    def points(y, x, valid):
        y, x, valid = (np.asarray(torch.as_tensor(t).cpu()) for t in (y, x, valid))
        return {(i, yy, xx) for i in range(y.shape[0])
                for yy, xx, v in zip(y[i].tolist(), x[i].tolist(), valid[i].tolist()) if v}

    pa, pb = points(*a), points(*b)
    return len(pa & pb) / max(len(pb), 1)


def host_exec_lines(stdout: str) -> list:
    """The ``[serve] exec`` lines of a host run, as `replay_exec_lines`
    returns them."""
    import re

    return [tuple(int(g) for g in m.groups()) for m in re.finditer(
        r"\[serve\] exec +(\d+): keypoints= *(\d+) matches= *(\d+)", stdout)]


def import_survey() -> dict:
    """Whether cv2, PIL, sklearn and tensorboard can be found here, with
    their distributions' versions, without importing any of them."""
    import importlib.metadata
    import importlib.util

    dists = importlib.metadata.packages_distributions()
    out = {}
    for mod in ("cv2", "PIL", "sklearn", "tensorboard"):
        spec = importlib.util.find_spec(mod)
        versions = {}
        for dist in dists.get(mod, []):
            try:
                versions[dist] = importlib.metadata.version(dist)
            except importlib.metadata.PackageNotFoundError:
                pass
        out[mod] = {"found": spec is not None, "versions": versions}
    return out


@contextlib.contextmanager
def plain_desc_loss():
    """`train/loss.py` with the descriptor loss's plain version in place of
    its kernels' entry point, on CUDA tensors too, for the block."""
    from feature_point_cnn_tpu_torch.ops.kernels.descriptor_loss import (
        hinge_descriptor_loss_plain)
    from feature_point_cnn_tpu_torch.train import loss as L

    kernels = L.hinge_descriptor_loss_cuda
    L.hinge_descriptor_loss_cuda = hinge_descriptor_loss_plain
    try:
        yield
    finally:
        L.hinge_descriptor_loss_cuda = kernels


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def decode_against_plain(lg: torch.Tensor, cell: int, t: float, what: str):
    """The decode kernel on logits ``lg`` held to its plain version: the
    kept mask may flip only where the probability lies within 1e-6 of
    ``t``, and elsewhere they agree within 1e-6.  ``(kernel's map, max|diff|,
    flips)``."""
    from feature_point_cnn_tpu_torch.ops.detection import decode_prob_map
    from feature_point_cnn_tpu_torch.ops.kernels.decode import (
        decode_threshold_cuda, decode_threshold_plain)

    with torch.inference_mode():
        dec_k = decode_threshold_cuda(lg, cell, t)
        dec_p = decode_threshold_plain(lg, cell, t)
        prob = decode_prob_map(lg, cell)
    torch.cuda.synchronize()
    flip = (dec_k > 0) != (dec_p > 0)
    check(bool(((prob[flip] - t).abs() <= 1e-6).all()),
          f"{what}: mask flips only at |p-t|<=1e-6")
    err = float((dec_k - dec_p).abs()[~flip].max())
    check(err <= 1e-6, f"{what}: max|diff| {err} <= 1e-6")
    return dec_k, err, int(flip.sum())


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


def prof_window(fn, calls: int, per_call: int, what: str, unit: str,
                card: str, named=()) -> None:
    """Trace ``calls`` runs of ``fn()`` after 3 untraced ones (a complete
    window, `traced_window`): the device's busy share of the wall time and
    the time by kernel, per ``unit`` (a call holds ``per_call`` of them);
    with ``named``, also the time and launches of the kernels whose names
    hold one of those strings.  Returns the wall and device ms of the window
    and each named kernel's launches a call."""
    events, wall_ms = traced_window(fn, calls, warm=3, named=named)
    kernels = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile {what}: {calls} traced calls, wall {wall_ms:.3f} ms, "
          f"device {dev_ms:.3f} ms, busy share {dev_ms / wall_ms:.3f} [{card}]")
    for e in kernels[:12]:
        print(f"  {e.self_device_time_total / 1e3 / calls / per_call:9.5f} ms/{unit} "
              f"x{e.count // calls:<4d} {e.key[:90]}")
    def short(key: str, k: str) -> str:      # the name with its template arguments
        s = key[key.index(k):]
        return s[:s.index(">") + 1] if s[len(k):len(k) + 1] == "<" else k

    mine = [(short(e.key, k), e) for e in kernels for k in named if k in e.key]
    if mine:
        print(f"  of which the named kernels: "
              f"{sum(e.self_device_time_total for _, e in mine) / 1e3 / calls / per_call:.5f} "
              f"ms/{unit} in {sum(e.count for _, e in mine) // calls} launches: " +
              ", ".join(f"{name} {e.self_device_time_total / 1e3 / calls / per_call:.4f}"
                        for name, e in mine))
    return dict(wall_ms=wall_ms, device_ms=dev_ms,
                launches={k: sum(e.count for name, e in mine if k in name) // calls
                          for k in named})


TRACE_TRIES = 8


def traced_window(fn, calls: int, warm: int = 1, named=()):
    """The profiler's averages of a window of ``calls`` runs of ``fn()``,
    traced after ``warm`` untraced runs, and the window's wall ms.

    The tracer now and then loses device records (5 of 150 windows of a
    frame call on the H100, in the package and the eager frame alike;
    `probe_trace_records.py`): a kernel launched once a call then reads 1
    or 2 records in 3 calls.  So, with ``named``, a window is taken only
    when each kernel whose name holds one of them has a whole number of
    records a call, the same as in the window before; else it is traced
    again.  When ``TRACE_TRIES`` windows fall short, the check fails."""
    from torch.profiler import ProfilerActivity, profile

    seen, last = [], None
    for _ in range(TRACE_TRIES):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.count]
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        counts = {k: sum(e.count for e in device if k in e.key) for k in named}
        whole = bool(device) and all(n % calls == 0 for n in counts.values())
        if whole and (not named or counts == last):
            return events, wall_ms
        if last is not None or not whole:
            print(f"trace: the named kernels' records in {calls} calls {counts} "
                  f"({'not as before' if whole else 'records lost'}), traced again")
        seen.append(counts)
        last = counts if whole else None
    check(False, f"no two windows in {TRACE_TRIES} agree on whole counts of the named "
                 f"kernels' records in {calls} calls: {seen}")


def trace_device(fn, calls: int = 3, named=()) -> dict:
    """Each CUDA operation (kernel, copy, fill) of one run of ``fn()``, from
    a traced window (`traced_window`, complete for the kernels ``named``)
    of ``calls`` runs after one untraced run: ``{name: (launches a run,
    device ms a launch)}``."""
    events, _ = traced_window(fn, calls, named=named)
    return {e.key: (e.count / calls, e.self_device_time_total / 1e3 / e.count)
            for e in events if e.device_type == torch.autograd.DeviceType.CUDA}


def traced_launches(fn, kernel_names, calls: int = 3) -> dict:
    """CUDA launches of each of the named kernels in one run of ``fn()``."""
    ops = trace_device(fn, calls, kernel_names)
    return {k: int(sum(n for key, (n, _) in ops.items() if k in key))
            for k in kernel_names}


def one_launch(fn, kernel: str, what: str, calls: int = 3) -> float:
    """Checks from a trace that a run of ``fn()`` is one CUDA launch, of
    ``kernel``; returns its device ms (mean over the traced runs)."""
    ops = trace_device(fn, calls, (kernel,))
    mine = [(n, ms) for key, (n, ms) in ops.items() if kernel in key]
    check(len(ops) == 1 and len(mine) == 1 and mine[0][0] == 1,
          f"{what}: one CUDA launch a call, of {kernel} (traced {ops})")
    return mine[0][1]


def cold_ms(fn, flush: torch.Tensor, iters: int = 10) -> float:
    """Median device time of single runs of ``fn()``, each after ``flush``
    (more than the 50 MB L2) was written over, so the inputs come from
    device memory.  A sleep queued before the window keeps the host's
    enqueue of ``fn()`` out of it."""
    fn()
    times = []
    for _ in range(iters):
        flush.fill_(1.0)
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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
    for name, shape in (("large_1080x1920", (1, 1080, 1920)),   # bands in device memory
                        ("batch_33", (33, H, W))):              # more clusters than run at once
        vals = rng.random(shape, dtype=np.float32) * 0.9 + 0.05
        vals[rng.random(shape, dtype=np.float32) >= 0.05] = 0.0
        out[name] = torch.from_numpy(vals).to(dev)
    return out


# the kernel rows' names of the tracer's launch counters
KERNEL_COUNTERS = {"decode_threshold": "kernel.decode_threshold",
                   "grid_nms": "kernel.grid_nms",
                   "descriptor_loss_fwd": "kernel.desc_loss_fwd",
                   "descriptor_loss_bwd": "kernel.desc_loss_bwd"}


def kernel_counts(names=tuple(KERNEL_COUNTERS)) -> dict:
    """The tracer's launch counters of the named kernels, by the kernel
    rows' names (a CUDA graph replay counts what its capture counted)."""
    return {k: profiling.COUNTERS[KERNEL_COUNTERS[k]] for k in names}


def zero_kernel_counts() -> None:
    profiling.reset_counters()


SL_IMAGES = 64        # scenes labelled in phase 9: 4 batches of 16
SL_BATCH = 16
SL_SRC = (480, 640)   # their size on disk, cropped to the training size
EVAL_PAIRS = 16       # drawn scenes of phase 10, one warped pair each


def kernel_shape_row(kind: str, x: torch.Tensor, threshold: float, nms_dist: int,
                     cell: int = 8) -> dict:
    """A kernel at a new path's shape: events ms back to back, its plain
    version's, the bound (bytes over 3.35 TB/s or operations over the float32
    peak, as rows 1-2 count them), and max |kernel - plain|."""
    from feature_point_cnn_tpu_torch.ops.kernels.decode import (
        decode_threshold_cuda, decode_threshold_plain)
    from feature_point_cnn_tpu_torch.ops.kernels.nms import (
        grid_nms_cuda, grid_nms_plain, plain_rounds)

    if kind == "decode":
        fn = lambda: decode_threshold_cuda(x, cell, threshold)
        plain = lambda: decode_threshold_plain(x, cell, threshold)
        b, hc, wc, _ = x.shape
        nbytes = x.numel() * 4 + b * hc * wc * cell * cell * 4
        ops = x.numel() * 5
    else:
        fn = lambda: grid_nms_cuda(x, nms_dist)
        plain = lambda: grid_nms_plain(x, nms_dist)
        nbytes = 2 * x.numel() * 4
        ops = sum(plain_rounds(x, nms_dist)) * x.shape[1] * x.shape[2] * (8 * nms_dist + 4)
    err = float((fn() - plain()).abs().max())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    row = dict(shape=list(x.shape), max_abs_err=err, ms=event_ms(fn, 20),
               plain_ms=event_ms(plain, 5), bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    return row


def selflabel_phase(seed: int, card: str) -> dict:
    """Phase 9: self-labeling through `preprocess_folder` at full width."""
    from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
    from feature_point_cnn_tpu_torch.inference.wrapper import (
        SuperPointFrontend, adaptation_fn, adaptation_prob_fn)
    from feature_point_cnn_tpu_torch.ops import kernels
    from feature_point_cnn_tpu_torch.ops.detection import (
        decode_prob_map, extract_keypoints, keypoints_to_numpy)
    from feature_point_cnn_tpu_torch.ops.kernels.decode import decode_threshold_cuda
    from feature_point_cnn_tpu_torch.ops.kernels.nms import grid_nms_cuda, grid_nms_plain
    from feature_point_cnn_tpu_torch.selflabel.adaptation import (
        homography_adaptation, sample_warps, unwarp_and_aggregate, warp_masks, warp_views)
    from feature_point_cnn_tpu_torch.geometry.homography import erode
    from feature_point_cnn_tpu_torch.selflabel.coco import (
        item_generator, load_and_crop, preprocess_folder)
    from feature_point_cnn_tpu_torch.utils.weights import released_path

    torch.backends.cudnn.allow_tf32 = True
    cfg = SuperPointConfig()
    homo = HomographyConfig.for_preprocess()
    bsz = SL_BATCH
    weights = str(Path(released_path()).parent / "magicpoint_synth_r3.npz")
    fe = SuperPointFrontend(cfg, weights_path=weights, device="cuda")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_selflabel_", dir=str(kernels.BUILD_DIR)))
    img_dir = work / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(seed + 90)
    t0 = time.perf_counter()
    for i in range(SL_IMAGES):
        g = (polygon_scene(rng, *SL_SRC) * 255).round().astype(np.uint8)
        write_bmp(img_dir / f"scene_{i:03d}.bmp",
                  np.stack([g, np.roll(g, 3, 1), g[::-1]], -1))
    print(f"selflabel data: {SL_IMAGES} 24-bit BMPs {SL_SRC[0]}x{SL_SRC[1]} written "
          f"in {time.perf_counter() - t0:.2f} s; weights {Path(weights).name}, "
          f"compute {cfg.compute_dtype}, num {homo.num}, batch {bsz}, "
          f"{cfg.train_image_size[0]}x{cfg.train_image_size[1]}")

    # the main path: counts set to 0, preprocess_folder, counts read; each
    # batch's start is stamped (a call returns host arrays, so it has synced)
    zero_kernel_counts()
    stamps = []
    run = fe.run_with_homography_adaptation

    def stamped(*a, **k):
        stamps.append(time.perf_counter())
        return run(*a, **k)

    fe.run_with_homography_adaptation = stamped
    single = work / "single"
    t0 = time.perf_counter()
    written = preprocess_folder(fe, str(img_dir), str(single), homo, batch_size=bsz,
                                seed=seed)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    total_s = stamps[-1] - t0
    del fe.run_with_homography_adaptation
    launches = kernel_counts(("decode_threshold", "grid_nms"))
    n_batches = -(-SL_IMAGES // bsz)
    periods = np.diff(stamps)
    rate = bsz / float(np.median(periods[1:]))
    print(f"selflabel main path: {written} items in {total_s:.3f} s, {n_batches} batches, "
          f"launches {launches}; batch periods {[round(float(x), 4) for x in periods]} s; "
          f"{rate:.2f} images/s (median after the first batch) [{card}]")
    check(written == SL_IMAGES, f"{SL_IMAGES} items written")
    check(launches == {"decode_threshold": 2 * n_batches, "grid_nms": n_batches},
          "decode launched twice a batch and NMS once")

    items = {}
    th, tw = cfg.train_image_size
    for f in sorted(single.glob("*.npz")):
        with np.load(f) as z:
            items[f.name] = (z["image"], z["points"])
    check(len(items) == SL_IMAGES, "every item on disk")
    n_pts = []
    for name, (image, pts) in items.items():
        check(image.shape == (3, th, tw) and image.dtype == np.float32, f"{name} image")
        check(pts.ndim == 2 and pts.shape[0] == 3 and bool(np.isfinite(pts).all()),
              f"{name}: finite (3, N) points")
        check(bool(((pts[0] >= 0) & (pts[0] <= tw - 1) & (pts[1] >= 0)
                    & (pts[1] <= th - 1) & (pts[2] > 0)).all()), f"{name}: points in the frame")
        n_pts.append(pts.shape[1])
    print(f"selflabel items: points an item median {float(np.median(n_pts)):.1f} "
          f"(min {min(n_pts)}, max {max(n_pts)})")
    check(min(n_pts) > 0, "every item has points")

    # shards 0/2 and 1/2 label as the single run, bit for bit
    sharded = work / "sharded"
    n_sh = [preprocess_folder(fe, str(img_dir), str(sharded), homo, batch_size=bsz,
                              seed=seed, shard_index=k, num_shards=2) for k in (0, 1)]
    same = 0
    for name, (image, pts) in items.items():
        with np.load(sharded / name) as z:
            same += int(np.array_equal(z["image"], image) and np.array_equal(z["points"], pts))
    print(f"selflabel shards: {n_sh} items, {same}/{len(items)} equal to the single run")
    check(same == len(items), "shards 0/2 and 1/2 give the single run's labels")

    # one batch through the stages, each ended by a synchronise
    paths = sorted(str(p_) for p_ in img_dir.iterdir())[:bsz]
    batch = np.stack([load_and_crop(p_, (th, tw)) for p_ in paths])
    imgs = torch.from_numpy(batch).cuda()
    gens = lambda: [item_generator(seed, gi) for gi in range(bsz)]
    prob_fn = adaptation_prob_fn(fe.model, cfg)
    parts = {k: [] for k in ("sample", "masks_and_erosion", "warps", "forwards",
                             "unwarp_and_aggregate", "nms_and_topk", "host_write")}
    erosion = []
    out_dir = work / "parts"
    out_dir.mkdir()

    def timed(name, fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name].append((time.perf_counter() - t1) * 1e3)
        return out

    with torch.inference_mode():
        for _ in range(6):
            hs = timed("sample", lambda: sample_warps(gens(), bsz, (th, tw), homo, imgs.device))
            mask, count, hs_inv = timed(
                "masks_and_erosion",
                lambda: warp_masks(hs, (th, tw), homo.valid_border_margin))
            warped = timed("warps", lambda: warp_views(imgs, hs))
            base, probs = timed("forwards", lambda: (prob_fn(imgs), prob_fn(warped)))
            agg = timed("unwarp_and_aggregate", lambda: unwarp_and_aggregate(
                base, probs, mask, count, hs_inv, homo))
            pts = timed("nms_and_topk", lambda: [
                keypoints_to_numpy(kp_, i) for kp_ in [extract_keypoints(agg, cfg)]
                for i in range(bsz)])
            t1 = time.perf_counter()
            for j in range(bsz):
                np.savez_compressed(out_dir / f"{j}.npz",
                                    image=np.transpose(batch[j], (2, 0, 1)), points=pts[j])
            parts["host_write"].append((time.perf_counter() - t1) * 1e3)
            ones = torch.ones((hs.shape[0] * bsz, th, tw), device=imgs.device)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            erode(ones, homo.valid_border_margin)
            erode(ones, homo.valid_border_margin)
            torch.cuda.synchronize()
            erosion.append((time.perf_counter() - t1) * 1e3)
        whole = adaptation_fn(fe.model, imgs, gens(), cfg, homo)
    check(torch.equal(agg, whole), "the timed stages compose to adaptation_fn's map")
    first = sorted(items)[:bsz]
    check(all(np.array_equal(pts[j], items[name][1]) for j, name in enumerate(first)),
          "the timed stages give the first batch's written labels")
    # the aggregated map through the decode kernel ("on") and through the
    # plain decode of the raw map ("off")
    with torch.inference_mode():
        maps = {"on": adaptation_fn(fe.model, imgs, gens(), cfg, homo),
                "off": homography_adaptation(gens(), imgs, lambda x: decode_prob_map(
                    fe.model.features(x, enable_descriptor=False)[0], cfg.cell), homo)}
    med = {k: float(np.median(v[1:])) for k, v in parts.items()}
    total = sum(med.values())
    print("selflabel batch parts (each ended by a synchronise, median of 5 after one): " +
          ", ".join(f"{k} {v:.3f} ms ({v / total:.3f})" for k, v in med.items()) +
          f"; sum {total:.3f} ms ({1e3 * bsz / total:.2f} images/s); of the masks, the "
          f"two erosions of {hs.shape[0] * bsz} masks {float(np.median(erosion[1:])):.3f} ms "
          f"[{card}]")
    gate_err = float((maps["on"] - maps["off"]).abs().max())
    print(f"selflabel decode kernel vs plain: aggregated maps max|diff| {gate_err:.3g}")
    check(gate_err <= 1e-5, "aggregated maps through the decode kernel and the plain "
          "decode agree to 1e-5")
    scores = torch.where(maps["on"] >= cfg.confidence_thresh, maps["on"], 0.0)
    check(torch.equal(grid_nms_cuda(scores, cfg.nms_dist),
                      grid_nms_plain(scores, cfg.nms_dist)),
          "the NMS kernel equals plain grid_nms on the aggregated map")

    # two traced batches (a lost record shows as a count not even): both
    # kernels, the device's busy share; peak memory
    torch.cuda.reset_peak_memory_stats()
    trace = prof_window(lambda: fe.run_with_homography_adaptation(batch, homo, gens()),
                        2, bsz, "selflabel batch", "image", card,
                        named=("decode_row_kernel", "grid_nms_kernel"))
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    print(f"selflabel trace: launches a batch {trace['launches']}, device busy share "
          f"{trace['device_ms'] / trace['wall_ms']:.3f}, peak memory {peak_mb:.0f} MiB [{card}]")
    check(trace["launches"] == {"decode_row_kernel": 2, "grid_nms_kernel": 1},
          "a traced batch shows 2 decode and 1 NMS launches")

    with torch.inference_mode():
        logits240, _ = fe.model.features(warp_views(imgs, sample_warps(
            gens(), bsz, (th, tw), homo, imgs.device)), enable_descriptor=False)
    shapes = {"decode_threshold": kernel_shape_row("decode", logits240, 0.0, cfg.nms_dist),
              "grid_nms": kernel_shape_row("nms", scores, cfg.confidence_thresh, cfg.nms_dist)}
    for name, r in shapes.items():
        print(f"selflabel kernel {name} {r['shape']}: {r['ms']:.4f} ms vs plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"max|diff| {r['max_abs_err']:.3g} [{card}]")
        check(r["max_abs_err"] <= (1e-6 if name == "decode_threshold" else 0.0),
              f"{name} at the self-labeling shape against its plain version")
        check(r["ms"] >= r["bound_ms"], f"{name}: not under its bound")
    del fe, imgs, logits240, maps, scores
    torch.cuda.empty_cache()
    # the scenes and the single run's labels stay for phase 13, which removes them
    return dict(launches=launches, shapes=shapes, work=work)


def eval_phase(seed: int, card: str) -> dict:
    """Phase 10: the two-view evaluation harness with the released weights."""
    from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
    from feature_point_cnn_tpu_torch.eval.benchmark import evaluate_pairs
    from feature_point_cnn_tpu_torch.eval.hpatches import evaluate_hpatches
    from feature_point_cnn_tpu_torch.geometry.homography import flat2mat, warp_points
    from feature_point_cnn_tpu_torch.geometry.warp import warp_image
    from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
    from feature_point_cnn_tpu_torch.ops import kernels
    from feature_point_cnn_tpu_torch.ops.kernels.decode import decode_threshold_cuda
    from feature_point_cnn_tpu_torch.ops.kernels.nms import grid_nms_cuda
    from feature_point_cnn_tpu_torch.slam.twoview import ransac_homography
    from feature_point_cnn_tpu_torch.utils.weights import released_path

    torch.backends.cudnn.allow_tf32 = True
    weights = released_path()
    cfg = SuperPointConfig(max_keypoints=512)
    fe = SuperPointFrontend(cfg, weights_path=weights, device="cuda")
    rng = np.random.default_rng(seed + 100)
    th, tw = cfg.train_image_size
    imgs = [np.repeat(polygon_scene(rng, th, tw)[..., None], 3, -1) for _ in range(EVAL_PAIRS)]
    families = {"default": HomographyConfig(),
                "mild": HomographyConfig(patch_ratio=0.8, max_angle=np.pi / 6)}
    launches = {"decode_threshold": 0, "grid_nms": 0}
    for name, homo in families.items():
        zero_kernel_counts()
        t0 = time.perf_counter()
        agg = evaluate_pairs(fe, imgs, homo, seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = kernel_counts(("decode_threshold", "grid_nms"))
        for k in launches:
            launches[k] += got[k]
        print(f"eval {name} family ({Path(weights).name}, {th}x{tw}, K = 512, "
              f"{EVAL_PAIRS} pairs, {1e3 * wall / EVAL_PAIRS:.1f} ms a pair) [{card}]: "
              + json.dumps({k: round(v, 6) for k, v in agg.items()}))
        check(got == {"decode_threshold": 2 * EVAL_PAIRS, "grid_nms": 2 * EVAL_PAIRS},
              f"eval {name}: decode and NMS once an extract ({got})")
        bad = [k for k, v in agg.items()
               if not np.isfinite(v) and k != "homography_error_cv2"]
        check(not bad, f"eval {name}: finite metrics (not {bad})")

    # the card's float32 run (TF32 off) against the port's CPU plain run
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg.replace(compute_dtype="float32")
    mild = families["mild"]
    fe_cuda = SuperPointFrontend(cfg32, weights_path=weights, device="cuda")
    fe_cpu = SuperPointFrontend(cfg32, weights_path=weights, device="cpu")
    on_card = evaluate_pairs(fe_cuda, imgs[:4], mild, seed=seed)
    on_cpu = evaluate_pairs(fe_cpu, imgs[:4], mild, seed=seed)
    torch.backends.cudnn.allow_tf32 = True
    diffs = {k: abs(on_card[k] - on_cpu[k]) for k in ("repeatability", "matching_score")}
    print(f"eval float32 card vs CPU plain over 4 pairs: " + ", ".join(
        f"{k} {on_card[k]:.4f} vs {on_cpu[k]:.4f}" for k in diffs))
    check(all(d <= 0.02 for d in diffs.values()),
          "card and CPU agree within 0.02 on repeatability and matching score")
    del fe_cuda, fe_cpu

    # RANSAC on the card on the exact correspondences of the CPU test
    p1, p2, valid, h_true = exact_correspondences(0)
    est = ransac_homography(torch.Generator().manual_seed(0), torch.from_numpy(p1).cuda(),
                            torch.from_numpy(p2).cuda(), torch.from_numpy(valid).cuda())
    corners = torch.tensor([[0, 0], [0, tw - 1], [th - 1, tw - 1], [th - 1, 0]],
                           dtype=torch.float32)
    c_err = float((warp_points(corners, est.h_flat.cpu())
                   - warp_points(corners, torch.from_numpy(h_true))).norm(dim=-1).mean())
    print(f"eval ransac on the card: corner error {c_err:.3g} px, "
          f"{int(est.num_inliers)} inliers of {len(p1)}")
    check(c_err < 0.1, "RANSAC on the card recovers the exact correspondences to 0.1 px")

    # a 2-sequence HPatches layout written as PPM with numpy
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_hpatches_", dir=str(kernels.BUILD_DIR)))
    base = (polygon_scene(rng, 480, 640) * 255).round().astype(np.uint8)
    base3 = np.repeat(base[..., None], 3, -1)
    (root / "i_scene").mkdir()
    for k in (1, 2, 3):
        write_ppm(root / "i_scene" / f"{k}.ppm", base3)
        if k > 1:
            np.savetxt(root / "i_scene" / f"H_1_{k}", np.eye(3))
    (root / "v_scene").mkdir()
    h_flat = torch.tensor([1.02, 0.03, -12.0, -0.02, 0.99, 8.0, 2e-5, -1e-5])
    warped = warp_image(torch.from_numpy(base3).float(), h_flat)
    write_ppm(root / "v_scene" / "1.ppm", base3)
    write_ppm(root / "v_scene" / "2.ppm", warped.round().clamp(0, 255).to(torch.uint8).numpy())
    np.savetxt(root / "v_scene" / "H_1_2", torch.linalg.inv(flat2mat(h_flat.double())).numpy())
    hp = evaluate_hpatches(fe, str(root), (th, tw))
    shutil.rmtree(root)
    print("eval hpatches layout: " + json.dumps(
        {s: {k: round(v, 6) for k, v in a.items()} for s, a in hp.items()}))
    check(hp["illumination"]["pairs"] == 2.0
          and abs(hp["illumination"]["repeatability"] - 1.0) < 1e-6,
          "the identity sequence has repeatability 1.0")
    check(hp["viewpoint"]["pairs"] == 1.0, "the viewpoint pair ran")
    return launches


TD_ITEMS = 160        # packed scenes of phase 11: 5 batches of 32 a epoch
TD_K = 4              # steps a call of the graphed runs: one call + a tail of 1
GEN_PER_PRIMITIVE = 8  # host generation timed in phase 11: 9 primitives x 8


def write_scene_items(path: Path, seed: int, n: int, h: int, w: int) -> None:
    """``n`` polygon scenes with their corners as npz items in the on-disk
    contract (``image (1, h, w)`` float32, ``points (3, N)`` [x, y, 1])."""
    rng = np.random.default_rng(seed)
    path.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img, pts = polygon_scene(rng, h, w, n_polygons=20, return_points=True)
        xy = np.vstack([pts[:, ::-1].T, np.ones((1, len(pts)))]).astype(np.float32)
        np.savez_compressed(path / f"scene_{i:04d}.npz", image=img[None], points=xy)


def train_data_phase(seed: int, card: str, survey: dict) -> dict:
    """Phase 11: the training data path at full width: a packed split on
    the card, `Trainer` epochs with k = 1 (eager steps) and k = 4 (replays
    of the captured step), the summaries, the timing; host generation where
    cv2 is installed."""
    from feature_point_cnn_tpu_torch.config import SuperPointConfig
    from feature_point_cnn_tpu_torch.data.device_store import DeviceBatchLoader, make_loader
    from feature_point_cnn_tpu_torch.data.packed import PackedPointDataset, pack_split
    from feature_point_cnn_tpu_torch.ops import kernels
    from feature_point_cnn_tpu_torch.ops.kernels.decode import decode_threshold_cuda
    from feature_point_cnn_tpu_torch.ops.kernels.descriptor_loss import (
        hinge_descriptor_loss_cuda)
    from feature_point_cnn_tpu_torch.ops.kernels.nms import grid_nms_cuda
    from feature_point_cnn_tpu_torch.train.trainer import Trainer

    cfg = SuperPointConfig(lr_schedule="constant")
    th, tw = cfg.train_image_size
    tb = cfg.batch_size
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_data_", dir=str(kernels.BUILD_DIR)))
    t0 = time.perf_counter()
    write_scene_items(work / "npz", seed + 110, TD_ITEMS, th, tw)
    t1 = time.perf_counter()
    meta = pack_split(str(work / "npz"), str(work / "packed" / "train"))
    t2 = time.perf_counter()
    ds = PackedPointDataset(str(work / "packed"), "train", seed=seed)
    loader = make_loader(ds, tb, cfg.max_points, seed=seed, device="cuda")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    check(isinstance(loader, DeviceBatchLoader), "make_loader chose the device loader")
    print(f"train data: {TD_ITEMS} scenes {th}x{tw} written in {t1 - t0:.2f} s, packed "
          f"in {t2 - t1:.2f} s ({meta}), uploaded in {t3 - t2:.2f} s: "
          f"{loader.images.numel() + 4 * (loader.points.numel() + loader.counts.numel())} "
          f"bytes on the card")
    rows = np.sort(ds.index)
    order = np.arange(len(rows))
    np.random.default_rng(seed + 0).shuffle(order)
    for i, b in enumerate(loader.epoch(0)):
        take = rows[order[i * tb:(i + 1) * tb]]
        check(np.array_equal(b["image"].cpu().numpy(), ds.images[take])
              and np.array_equal(b["points_valid"].sum(-1).cpu().numpy(),
                                 np.minimum(ds.counts[take], cfg.max_points)),
              f"device batch {i} equals the packed rows")
    print(f"train data: {len(loader)} device batches equal the packed arrays")

    # k = 1 (eager) against k = 4 (graphed) at float32, TF32 off and cuDNN's
    # deterministic algorithms: the same steps must give the same parameters
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg32 = cfg.replace(compute_dtype="float32")
    launches = {"decode_threshold": 0, "grid_nms": 0, "descriptor_loss_fwd": 0,
                "descriptor_loss_bwd": 0}
    graph_launches = {}
    for phase in ("magicpoint", "superpoint"):
        params = {}
        for k in (1, TD_K):
            zero_kernel_counts()
            ck = work / f"ck_{phase}_{k}"
            tr = Trainer(cfg32.replace(train_steps_per_call=k), phase, loader, None,
                         str(ck), seed=seed, device="cuda", log_every=1)
            t0 = time.perf_counter()
            m = tr.train_epoch(0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tr.writer.close()
            check(tr.state.step == len(loader) and int(tr.state.optimizer.count) == len(loader),
                  f"{phase} k = {k}: {len(loader)} steps taken, none skipped")
            check((tr._graph is not None) == (k > 1), f"{phase} k = {k}: graphed iff k > 1")
            check(all(np.isfinite(v) for v in m.values()), f"{phase} k = {k}: finite metrics")
            got = kernel_counts()
            for key in launches:
                launches[key] += got[key]
            runs = ck / "runs"
            lines = (runs / "metrics.jsonl").read_text().splitlines()
            overlay = runs / f"detector_{phase}_4.ppm"
            print(f"train data {phase} k = {k}: epoch in {wall:.2f} s (first call builds "
                  f"and captures), loss {m['loss']:.4f}, wrapper launches {got}, "
                  f"{len(lines)} metrics.jsonl lines, overlay {overlay.name} "
                  f"{overlay.stat().st_size if overlay.exists() else 'MISSING'} bytes")
            check(len(lines) >= len(loader) and overlay.exists(),
                  f"{phase} k = {k}: scalars and the overlay image written")
            check(got["decode_threshold"] > 0 and got["grid_nms"] > 0,
                  f"{phase} k = {k}: the overlay went through decode and NMS")
            if phase == "superpoint":
                # eager: a step each; graphed: the capture's 2 warm-up
                # steps, then a step each (a replay counts what the capture
                # counted, the capture itself nothing)
                want = len(loader) + (0 if k == 1 else 2)
                check(got["descriptor_loss_fwd"] == got["descriptor_loss_bwd"] == want,
                      f"superpoint k = {k}: descriptor-loss launches counted {want} times")
            params[k] = {n: v.detach().clone() for n, v in tr.state.model.state_dict().items()}
            if k > 1:
                idxs = list(loader.epoch_index_arrays(1))[:k]
                before = profiling.counters()
                tr.train_steps(idxs, 1, 0)
                torch.cuda.synchronize()
                counted = profiling.counted_since(before)
                want = {"train.steps": k}
                if phase == "superpoint":
                    want.update({"kernel.desc_loss_fwd": k, "kernel.desc_loss_bwd": k})
                print(f"train data {phase}: the tracer's counters over one call of {k} "
                      f"replays {counted}")
                check(counted == want, f"{phase}: one call of {k} replays counts {want}")
                graph_launches[phase] = traced_launches(
                    lambda: tr.train_steps(idxs, 1, 0), DL_KERNEL_NAMES, calls=2)
                print(f"train data {phase}: kernels in a traced call of {k} replays "
                      f"{graph_launches[phase]}")
                if phase == "superpoint":
                    # a step: forward split, 3 sweeps, sum; backward 2 splits,
                    # 2 sweeps, 2 gradient sweeps
                    want = {"wgmma_sweep_kernel": 5 * k, "wgmma_grad_kernel": 2 * k,
                            "split_kernel": 2 * k, "split_transposed_kernel": k,
                            "sum_kernel": k}
                    check(graph_launches[phase] == want,
                          f"the descriptor-loss kernels launch inside the graphed "
                          f"step: {want}")
            del tr
        diff = max(float((params[TD_K][n].float() - v.float()).abs().max())
                   for n, v in params[1].items())
        bit = all(torch.equal(params[TD_K][n], v) for n, v in params[1].items())
        print(f"train data {phase}: k = {TD_K} graphed vs k = 1 eager after "
              f"{len(loader)} steps: max |diff| {diff:.3g}, bit-equal {bit}")
        for n, v in params[1].items():
            check(torch.allclose(params[TD_K][n].float(), v.float(), rtol=2e-4, atol=2e-5),
                  f"{phase} {n}: graphed equals eager within rtol 2e-4 + atol 2e-5")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True

    # timing at the training default (bf16): eager steps against replays,
    # in turns eager / graphed / graphed / eager
    trainers = {k: Trainer(cfg.replace(train_steps_per_call=k), "superpoint", loader,
                           None, str(work / f"time_{k}"), seed=seed, device="cuda",
                           write_statistics=False) for k in (1, TD_K)}
    idxs = list(loader.epoch_index_arrays(0))[:TD_K]

    def eager():
        t = trainers[1]
        for j, idx in enumerate(idxs):
            t._fused_step(idx, t._seed(0, j))

    def graphed():
        trainers[TD_K].train_steps(idxs, 0, 0)

    ms = {"eager": [], "graphed": []}
    for name in ("eager", "graphed", "graphed", "eager"):
        fn = eager if name == "eager" else graphed
        ms[name].append(host_median_ms(fn, runs=10) / TD_K)
    busy = {}
    for name, fn in (("eager", eager), ("graphed", graphed)):
        w = prof_window(fn, 3, TD_K, f"train step b{tb} {name}", "step", card,
                        named=DL_KERNEL_NAMES)
        busy[name] = w["device_ms"] / w["wall_ms"]
    for name in ms:
        mean = float(np.mean(ms[name]))
        print(f"train data step b{tb} {name}: {ms[name]} ms/step ({1e3 * tb / mean:.1f} "
              f"images/s), busy share {busy[name]:.3f} [{card}]")
    del trainers

    # host generation of the synthetic shapes (no kernel, no device)
    if survey["cv2"]["found"]:
        # the CLI in a process of its own (a fork of this one would carry
        # the CUDA context); its interpreter start and imports timed apart
        gen_dir = work / "generated"
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", "import feature_point_cnn_tpu_torch.data.generate"],
                       check=True, timeout=300)
        t1 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "feature_point_cnn_tpu_torch.data.generate",
                        str(gen_dir), "--train-size", str(GEN_PER_PRIMITIVE),
                        "--test-size", "0", "--seed", str(seed)],
                       check=True, capture_output=True, text=True, timeout=600)
        t2 = time.perf_counter()
        n = len(list((gen_dir / "train").glob("*.npz")))
        check(n == 9 * GEN_PER_PRIMITIVE, f"generate_dataset wrote {n} items")
        gen_s = (t2 - t1) - (t1 - t0)
        print(f"train data generate_dataset on the host: {n} images 240x320 in "
              f"{t2 - t1:.2f} s, of which {t1 - t0:.2f} s interpreter start and imports: "
              f"{n / gen_s:.1f} images/s generated ({os.cpu_count()} cores)")
    else:
        print("train data generate_dataset: not run (cv2 is not installed here)")
    shutil.rmtree(work / "generated", ignore_errors=True)
    # the packed split stays for phases 12 and 13; phase 13 removes it
    return {"launches": launches, "graph_launches": graph_launches,
            "ms": ms, "busy": busy, "work": work}


TRACK_FRAMES = 40     # the tracking entry point's default sequence of phase 12
BA_SMALL = (6, 48, 4)           # (P, L, M) held to the dense oracle
BA_MAP = (64, 16_384, 4)        # a map a tracker builds: 10 iterations
VGG_SHAPE = (480, 640)
CLI_FRAMES = 60


def tracking_ba_vgg_cli_phase(seed: int, card: str, packed: Path) -> dict:
    """Phase 12: tracking through `eval.tracking.main`, bundle adjustment,
    the VGG family and the command line (`main.main`), at full width."""
    from feature_point_cnn_tpu_torch import main as cli
    from feature_point_cnn_tpu_torch.config import SuperPointConfig
    from feature_point_cnn_tpu_torch.data.packed import pack_split
    from feature_point_cnn_tpu_torch.eval import tracking as ev_tracking
    from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
    from feature_point_cnn_tpu_torch.models.vgg_superpoint import (
        VGG_CONFIG, VGGSuperPoint, init_vgg_superpoint)
    from feature_point_cnn_tpu_torch.slam.bundle import (
        bundle_adjust, dense_bundle_adjust_reference, synthetic_ba_problem)
    from feature_point_cnn_tpu_torch.slam.tracking import Tracker, frontend_extractor
    from feature_point_cnn_tpu_torch.utils.weights import released_path

    torch.backends.cudnn.allow_tf32 = True
    weights = released_path()
    th, tw = 240, 320
    out: dict = {}

    # ---- tracking: the entry point, bf16, K = 512 (its defaults) ----------
    # on its synthetic default (one line-drawing scene: about a dozen
    # keypoints, so the released model re-keys every frame) and on a
    # polygon scene written as a BMP (about 140 keypoints); the polygon's
    # pose-graph run sweeps 96 px, so that keyframes are promoted and the
    # second loop closes on them
    work = packed.parent
    src = work / "track_src"
    src.mkdir()
    poly = polygon_scene(np.random.default_rng(seed + 130), th, tw)
    write_bmp(src / "scene.bmp", np.repeat((poly[..., None] * 255).round().astype(np.uint8),
                                           3, -1))
    zero_kernel_counts()
    track, frames_run = {}, 0
    for source in ("synthetic", str(src)):
        for extra in ([], ["--loops", "2", "--posegraph"] + (
                [] if source == "synthetic" else ["--max-shift", "96"])):
            n = TRACK_FRAMES * (2 if extra else 1)
            t = time.perf_counter()
            res = ev_tracking.main(["--weights-path", weights, "--source", source,
                                    "--frames", str(n)] + extra)
            torch.cuda.synchronize()
            key = f"{'synthetic' if source == 'synthetic' else 'polygon_bmp'}_{n}" + (
                "_posegraph" if extra else "")
            res["seconds"] = time.perf_counter() - t
            track[key] = res
            frames_run += n
            print(f"tracking main {key} ({Path(weights).name}, {th}x{tw}, K = 512, bf16; "
                  f"the run builds its frontend) [{card}]: {json.dumps(res)}")
            bad = [k for k, v in res.items() if not np.isfinite(v)]
            check(not bad and res["frames"] == n, f"tracking {key}: finite results (not {bad})")
            check(("posegraph_ate_rmse_px" in res) == bool(extra),
                  f"tracking {key}: the pose-graph columns iff --posegraph")
    loop = track[f"polygon_bmp_{2 * TRACK_FRAMES}_posegraph"]
    check(loop["num_loop_closures"] > 0
          and loop["posegraph_ate_rmse_px"] < loop["ate_rmse_px"],
          "tracking: the polygon sweep's loop closures lower its ATE")
    out["launches_tracking"] = kernel_counts()
    print(f"tracking main: wrapper launches {out['launches_tracking']} over {frames_run} frames")
    check(out["launches_tracking"]["decode_threshold"] == frames_run
          and out["launches_tracking"]["grid_nms"] == frames_run,
          "tracking: decode and NMS once a frame")
    out["tracking"] = track

    # Tracker.process timed: the whole frame, and its extract apart (a
    # synchronise after the extract; match + RANSAC end in the frame's one
    # host read)
    cfg = SuperPointConfig(max_keypoints=512)
    fe = SuperPointFrontend(cfg, weights_path=weights, device="cuda")
    base = ev_tracking._base_image("synthetic", (th, tw))
    poly3 = np.repeat(poly[..., None], 3, -1)
    params = ev_tracking.smooth_trajectory(TRACK_FRAMES)
    frames = ev_tracking.render_sequence(poly3, params, "cuda").unbind(0)
    ext = frontend_extractor(fe)
    ext_ms: list = []

    def timed_extract(image):
        t = time.perf_counter()
        feats = ext(image)
        torch.cuda.synchronize()
        ext_ms.append((time.perf_counter() - t) * 1e3)
        return feats

    proc_ms = []
    for rep in range(2):                       # the first pass warms up
        tracker = Tracker(extract=timed_extract)
        ext_ms.clear()
        proc_ms = []
        for fr in frames:
            t = time.perf_counter()
            tracker.process(fr)
            proc_ms.append((time.perf_counter() - t) * 1e3)
    proc, extr = float(np.median(proc_ms[1:])), float(np.median(ext_ms[1:]))
    out["tracking_ms"] = {"process": proc, "extract": extr, "match_ransac": proc - extr}
    print(f"tracking Tracker.process on the polygon scene: {proc:.3f} ms/frame median over "
          f"{TRACK_FRAMES - 1} tracked frames, of which extract {extr:.3f} ms and "
          f"match + RANSAC + the host read {proc - extr:.3f} ms [{card}]")
    traced = traced_launches(lambda: tracker.process(frames[5]),
                             ("decode_row_kernel", "grid_nms_kernel"))
    print(f"tracking: kernels in a traced Tracker.process {traced}")
    check(traced == {"decode_row_kernel": 1, "grid_nms_kernel": 1},
          "one decode and one NMS launch a Tracker.process")
    prof_window(lambda: tracker.process(frames[7]), 5, 1, "Tracker.process", "frame", card)
    # where the host's time goes: operators by their own CPU time a frame
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            tracker.process(frames[9])
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
    print("tracking Tracker.process host time by operator, ms/frame (calls/frame): " + ", ".join(
        f"{e.key} {e.self_cpu_time_total / 5e3:.3f} ({e.count // 5})" for e in ops))
    del fe, frames

    # the 40-frame sequence at float32 (TF32 off) on the card and on the CPU,
    # each frame's RANSAC drawing from the same CPU generator
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = cfg.replace(compute_dtype="float32")
    f32 = {}
    fes = {where: SuperPointFrontend(cfg32, weights_path=weights, device=dev)
           for where, dev in (("card", "cuda"), ("cpu", "cpu"))}
    for name, image in (("synthetic", base), ("polygon_bmp", poly3)):
        for where, fe in fes.items():
            t = time.perf_counter()
            f32[f"{name}_{where}"] = r = ev_tracking.evaluate_tracking(
                frontend_extractor(fe), image, n_frames=TRACK_FRAMES, device=fe.device)
            print(f"tracking float32 {name} on the {where}: {json.dumps(r)} "
                  f"({time.perf_counter() - t:.2f} s)")
        a, b = f32[f"{name}_card"], f32[f"{name}_cpu"]
        check(abs(a["ate_rmse_px"] - b["ate_rmse_px"]) <= 0.1 + 0.05 * b["ate_rmse_px"]
              and abs(a["num_keyframes"] - b["num_keyframes"]) <= 1
              and abs(a["frac_tracked"] - b["frac_tracked"]) <= 0.05,
              f"tracking float32 {name}: the card agrees with the CPU (ATE within "
              f"0.1 px + 5%, keyframes within 1, frac_tracked within 0.05)")
    out["tracking_float32"] = f32
    del fes

    # ---- bundle adjustment ------------------------------------------------
    p_, l_, m_ = BA_SMALL
    pc, _, _ = synthetic_ba_problem(np.random.default_rng(seed), p_, l_, m_)
    p1, x1, c1 = bundle_adjust(pc, iters=5)
    p2, x2, c2 = dense_bundle_adjust_reference(pc, iters=5)
    ba_err = {"cost_rel": float(((c1 - c2).abs() / c2.abs()).max()),
              "poses": float((p1 - p2).abs().max()), "points": float((x1 - x2).abs().max())}
    print(f"bundle adjustment {BA_SMALL} on the card, Schur vs the dense oracle, "
          f"5 iterations: {ba_err}")
    check(ba_err["cost_rel"] <= 1e-4 and ba_err["poses"] <= 2e-4
          and ba_err["points"] <= 2e-4,
          "BA: Schur equals the dense oracle (costs rtol 1e-4, poses/points 2e-4)")
    p_, l_, m_ = BA_MAP
    t = time.perf_counter()
    pc, true_poses, true_points = synthetic_ba_problem(
        np.random.default_rng(seed + 1), p_, l_, m_, noise=1e-4, init_noise=0.05)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    check(pc.points.is_cuda, "BA: synthetic_ba_problem puts the problem on the card")
    bundle_adjust(pc, iters=2)                 # warm-up
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    poses, points, costs = bundle_adjust(pc, iters=10)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 20
    costs = costs.cpu().numpy()
    pose_err = float(np.abs(poses.cpu().numpy() - true_poses).max())
    # a landmark whose slots were all dropped is unobservable: it keeps its
    # initial position, and only the observed ones can reach the truth
    observed = pc.obs_valid.any(1).cpu().numpy()
    pts = points.cpu().numpy()
    point_err = float(np.abs(pts[observed] - true_points[observed]).max())
    unobserved_moved = float(np.abs(pts[~observed] - pc.points.cpu().numpy()[~observed]).max(
        initial=0.0))
    out["ba"] = {"shape": list(BA_MAP), "iters": 10,
                 "ms_per_iter": start.elapsed_time(end) / 10, "wall_ms_per_iter": wall / 10,
                 "peak_mib": peak, "cost_first": float(costs[0]), "cost_last": float(costs[-1]),
                 "pose_err": pose_err, "point_err": point_err,
                 "unobserved_points": int((~observed).sum()),
                 "unobserved_moved": unobserved_moved, "host_gen_s": gen_s,
                 "small_vs_dense": ba_err}
    print(f"bundle adjustment P = {p_}, L = {l_}, M = {m_}: {out['ba']['ms_per_iter']:.3f} "
          f"ms an iteration (events; wall {wall / 10:.3f}), peak {peak:.1f} MiB above the "
          f"problem, cost {costs[0]:.4g} -> {costs[-1]:.4g}, max |pose - truth| "
          f"{pose_err:.2e}, max |point - truth| {point_err:.2e} over the "
          f"{int(observed.sum())} observed landmarks ({int((~observed).sum())} with every "
          f"slot dropped moved {unobserved_moved:.2e}); problem drawn and moved to the card in "
          f"{gen_s:.2f} s [{card}]")
    check(costs[-1] < 1e-2 * costs[0], "BA: the cost falls by 100x")
    check(pose_err <= 5e-3 and point_err <= 5e-3,
          "BA: poses and the observed points within 5e-3 of the truth")
    check(unobserved_moved == 0.0, "BA: a landmark with no valid observation stays put")
    del pc, poses, points

    # ---- VGG: float32 card against the CPU, then ms/frame ----------------
    vcfg = VGG_CONFIG.replace(compute_dtype="float32")
    vgg = init_vgg_superpoint(torch.Generator().manual_seed(seed), vcfg, device="cuda").eval()
    vgg_cpu = VGGSuperPoint(vcfg)
    vgg_cpu.load_state_dict({k: v.cpu() for k, v in vgg.state_dict().items()})
    rng = np.random.default_rng(seed + 120)
    x8 = torch.from_numpy(np.stack([polygon_scene(rng, *VGG_SHAPE) for _ in range(8)])[..., None])
    with torch.no_grad():
        ref = vgg_cpu.eval()(x8)
        x8c = x8.cuda()
        vgg_err = {}
        for b in (1, 8):
            got = vgg(x8c[:b])
            vgg_err[b] = {n: float((g.cpu() - r[:b]).abs().max())
                          for n, g, r in zip(("prob", "desc", "logits"), got, ref)}
        print(f"vgg float32 card vs CPU at {VGG_SHAPE}: {vgg_err}")
        check(all(e["prob"] <= 1e-4 for e in vgg_err.values()),
              "VGG: the card's prob map within 1e-4 of the CPU's")
        torch.backends.cudnn.allow_tf32 = True
        vgg_ms = {}
        for dtype in ("float32", "bfloat16"):
            m = VGGSuperPoint(VGG_CONFIG.replace(compute_dtype=dtype)).cuda().eval()
            m.load_state_dict(vgg.state_dict())
            for b in (1, 8):
                vgg_ms[f"{dtype}_b{b}"] = event_ms(lambda: m(x8c[:b]), 20) / b
        print(f"vgg forward ms/frame at {VGG_SHAPE} (float32 with TF32 convolutions, "
              f"bf16): {json.dumps(vgg_ms)} [{card}]")
    out["vgg"] = {"max_abs_err": vgg_err, "ms_per_frame": vgg_ms}
    del vgg, vgg_cpu, m, x8c

    # ---- the command line, in-process -------------------------------------
    pack_split(str(work / "npz"), str(packed / "test"))
    zero_kernel_counts()
    t = time.perf_counter()
    stats = cli.main(["inference", "--weights-path", weights, "--source", "synthetic",
                      "--max-frames", str(CLI_FRAMES), "--no-show"])
    inf_s = time.perf_counter() - t
    c_inf = kernel_counts()
    check(stats["frames"] == CLI_FRAMES and stats["mean_fps"] > 0,
          f"cli inference: {CLI_FRAMES} frames at fps > 0 ({stats})")
    check(c_inf["decode_threshold"] == CLI_FRAMES and c_inf["grid_nms"] == CLI_FRAMES,
          "cli inference: decode and NMS once a frame")
    print(f"cli inference ({Path(weights).name}, 480x640, K = 1024, bf16): {stats} in "
          f"{inf_s:.2f} s [{card}]")
    mp_dir, joint_dir = work / "cli_mp", work / "cli_joint"
    t = time.perf_counter()
    cli.main(["train", "--synthetic-path", str(packed), "--epochs", "1",
              "--checkpoint-path", str(mp_dir)])
    mp_s = time.perf_counter() - t
    c_mp = kernel_counts()
    fwd0, bwd0 = c_mp["descriptor_loss_fwd"], c_mp["descriptor_loss_bwd"]
    t = time.perf_counter()
    cli.main(["train", "--coco-path", str(packed), "--magic-point-weights", str(mp_dir),
              "--epochs", "1", "--checkpoint-path", str(joint_dir)])
    joint_s = time.perf_counter() - t
    c_all = kernel_counts()
    joint_calls = (c_all["descriptor_loss_fwd"] - fwd0, c_all["descriptor_loss_bwd"] - bwd0)
    print(f"cli train: MagicPoint epoch in {mp_s:.2f} s, joint epoch in {joint_s:.2f} s "
          f"(each builds its trainer and evaluates the test split); descriptor-loss "
          f"wrapper calls in the joint run (fwd, bwd) {joint_calls} [{card}]")
    check(joint_calls[0] > 0 and joint_calls[1] > 0,
          "cli train: the joint branch called the descriptor-loss wrappers")
    raw, prog = work / "cli_export.npz", work / "cli_export_program.pt2"
    cli.main(["export", "--weights-path", str(joint_dir), "--raw-weights", str(raw),
              "--out", str(prog)])
    torch.backends.cudnn.allow_tf32 = False
    img = torch.from_numpy(np.repeat(polygon_scene(rng, th, tw)[None, ..., None], 3, -1))
    kps = [SuperPointFrontend(cfg32, weights_path=str(w), device="cuda").extract(img)[0]
           for w in (raw, joint_dir)]
    torch.backends.cudnn.allow_tf32 = True
    same = all(torch.equal(getattr(kps[0], f), getattr(kps[1], f))
               for f in ("y", "x", "score", "valid"))
    print(f"cli export: {raw.name} {raw.stat().st_size} bytes; float32 keypoints from the "
          f".npz and from the checkpoint directory equal: {same} "
          f"({int(kps[0].valid.sum())} valid)")
    check(same, "cli export: the .npz and the directory give the same keypoints")
    # --out: the torch.export extract program at the parser's 480x640, run
    # against the frontend's extract on the same weights (bf16)
    scene = np.repeat(polygon_scene(rng, H, W)[None, ..., None], 3, -1)
    with torch.inference_mode():
        got = torch.export.load(str(prog)).module()(torch.from_numpy(scene).cuda())
    want, _ = SuperPointFrontend(SuperPointConfig(), weights_path=str(joint_dir),
                                 device="cuda").extract(scene)
    n_got, n_want = int(got[3].sum()), int(want.valid.sum())
    shared = keypoint_overlap((got[0], got[1], got[3]), (want.y, want.x, want.valid))
    print(f"cli export --out: {prog.name} {prog.stat().st_size} bytes; the loaded "
          f"program's keypoints {n_got}, extract's {n_want}, shared {shared:.4f}")
    check(n_got == n_want and shared >= 0.99,
          "cli export --out: the loaded program gives extract's keypoints")
    out["launches_cli"] = kernel_counts()
    out["cli"] = {"inference": stats, "inference_s": inf_s, "magicpoint_epoch_s": mp_s,
                  "joint_epoch_s": joint_s, "joint_descriptor_loss_calls": joint_calls}
    return out


PAR_RANKS = 2          # phase 13: two ranks on the one card, over gloo
PAR_BATCH = 32         # its steps' global batch at 240x320, 16 a rank
PAR_SL_IMAGES = 32     # phase 9's scenes labelled again over the mesh, batch 16
PAR_TIMED_STEPS = 10
PAR_TIMEOUT_S = 600
# the NCCL rank's epochs against one process's: with Adam's epsilon at 1 an
# update is lr g / (|g| + 1), smooth in g, so float noise in a gradient
# stays noise; at 1e-8 a near-zero entry moves by +-lr on its sign alone
PAR_ADAM_EPS = 1.0
# the W-sharded scenario of phase 13: the released model on one image split
# over the two ranks at the serving point (480x320 a rank), and the large
# point of its peak memory (bf16, B = 1)
PAR_SPATIAL_HW = (H, W)
PAR_SPATIAL_NARROW_HW = (H, 16)     # 8 px a shard over the two ranks
PAR_SPATIAL_BIG_HW = (1920, 2560)
PAR_SPATIAL_TIMED = 20
PAR_SPATIAL_K = 256      # the top-K of the bf16 keypoint overlap
# W-sharded training: both steps at the training point (240x320) on the
# first 2 scenes of the parallel steps' batch, and a step's peak memory at
# the large point (bf16, B = 1)
PAR_SPATIAL_TRAIN_B = 2
PAR_SPATIAL_TRAIN_BIG_HW = (960, 1280)
PAR_SPATIAL_TRAIN_TIMED = 10


def _deterministic(on: bool) -> None:
    """float32 parity runs: TF32 off and cuDNN's deterministic algorithms;
    off again: the defaults every other phase runs under."""
    torch.backends.cudnn.allow_tf32 = not on
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = on


def _par_step(spec: dict, config, batch: dict, rows: slice) -> dict:
    """One joint step from fresh seeded parameters on ``rows`` of the global
    ``batch``: metrics, the gradients (all-reduced under a group), the new
    parameters and statistics, and the wrappers' launches."""
    from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
    from feature_point_cnn_tpu_torch.train import steps as S
    from feature_point_cnn_tpu_torch.train.optimizer import make_optimizer

    dev = spec["device"]
    model = SuperPoint(config, generator=torch.Generator().manual_seed(spec["seed"] + 13),
                       float32_params=True).to(dev, memory_format=torch.channels_last)
    state = S.create_train_state(model, make_optimizer(config, model.named_parameters()))
    local = {k: v[rows].to(dev) for k, v in batch.items()}
    zero_kernel_counts()
    _, m = S.superpoint_train_step(
        state, local, torch.Generator(device=dev).manual_seed(spec["seed"] + 131),
        config=config)
    if dev == "cuda":
        torch.cuda.synchronize()
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {n: p.grad.detach().float().cpu()
                      for n, p in model.named_parameters() if p.grad is not None},
            "state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "launches": kernel_counts()}


def _sharded_order(spec: dict, sorted_idx: np.ndarray, d: int, b: int, epoch: int):
    """The numpy reference of the item-sharded loader: ``(n_batches, d,
    b / d)`` dataset rows, rank r's block of each global batch in column r."""
    n = len(sorted_idx) - len(sorted_idx) % d
    per, bl = n // d, b // d
    rng = np.random.default_rng(spec["seed"] + epoch)
    orders = [rng.permutation(per) for _ in range(d)]
    return np.stack([np.stack([sorted_idx[r * per + orders[r][i * bl:(i + 1) * bl]]
                               for r in range(d)]) for i in range(n // b)])


def spatial_image(seed: int, h: int, w: int, device) -> torch.Tensor:
    """The W-sharded scenario's image: the scene of phase 4's first frame
    at ``h x w``, ``(1, h, w, 3)`` float32 in [0, 1]."""
    u8 = torch.from_numpy(shifted_pair(seed, h, w, SHIFT)[1][None])
    return (u8.float() / 255.0).expand(-1, -1, -1, 3).contiguous().to(device)


def spatial_frontend(dtype: str, device):
    """The released model's frontend at ``dtype`` (the serving config)."""
    from feature_point_cnn_tpu_torch.config import SuperPointConfig
    from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
    from feature_point_cnn_tpu_torch.utils.weights import released_path

    return SuperPointFrontend(SuperPointConfig(compute_dtype=dtype),
                              weights_path=released_path(), device=device)


def spatial_vgg(seed: int, device):
    """A VGG SuperPoint, float32, its weights drawn from ``seed``."""
    from feature_point_cnn_tpu_torch.models.vgg_superpoint import (
        VGG_CONFIG, init_vgg_superpoint)

    return init_vgg_superpoint(torch.Generator().manual_seed(seed),
                               VGG_CONFIG.replace(compute_dtype="float32"), device=device).eval()


def spatial_extract(fe, images, mesh=None) -> dict:
    """`extract` (``mesh`` None) or `extract_spatial` of ``images``: the
    keypoints' fields and the descriptors on the host."""
    kp, desc = fe.extract(images) if mesh is None else fe.extract_spatial(images, mesh)
    return {**{f: getattr(kp, f).cpu() for f in kp._fields}, "desc": desc.cpu()}


def peak_mib(fn) -> float:
    """Device memory ``fn()`` takes at its peak above what was allocated
    before it, MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def spatial_rank(spec: dict, world: int) -> dict:
    """Phase 13's W-sharded scenario on a gloo rank, over a width mesh of
    ``world`` ranks.  The forwards on this rank's block of one image
    (`shard_images_spatial`, under `width_group`): the released model at
    float32 with TF32 off and at bf16, the same at 8 px a shard (float32),
    and a seeded VGG on the image's gray channel (float32), each with its
    outputs gathered, the exchanges' counts and the wrappers' launches
    (none: a forward decodes with the plain version).  Then
    `extract_spatial` of the image at float32 and bf16: keypoints,
    descriptors, what the exchanges and gathers carried, and the wrappers'
    launches (decode on the block, NMS on the gathered map).  On the card,
    both ranks at once: bf16 ms a sharded forward and peak MiB at the
    serving point and at the large one; bf16 ms a sharded extract and a
    score-map gather."""
    from feature_point_cnn_tpu_torch.parallel import spatial
    from feature_point_cnn_tpu_torch.parallel.mesh import (
        make_spatial_mesh,
        shard_images_spatial,
    )

    dev, (h, w), seed = spec["device"], spec["spatial_hw"], spec["seed"]
    t0 = time.perf_counter()
    smesh = make_spatial_mesh(world)
    image = spatial_image(seed, h, w, dev)
    local = shard_images_spatial(image, smesh)
    fes = {dtype: spatial_frontend(dtype, dev) for dtype in ("float32", "bfloat16")}
    out, logits_blocks = {}, {}
    zero_kernel_counts()

    def sharded(model, x):
        with torch.inference_mode(), spatial.width_group(smesh.group):
            return model(x)

    def forward(name, model, x):
        spatial.reset_counts()
        outs = sharded(model, x)
        counts = dict(spatial.counts)
        logits_blocks[name] = outs[2]
        out[name] = {"gathered": [spatial.gather_width(t, 2, smesh.group).cpu()
                                  for t in outs],
                     "local_shapes": [list(t.shape) for t in outs], "counts": counts}

    for dtype in ("float32", "bfloat16"):
        _deterministic(dtype == "float32")
        forward(dtype, fes[dtype].model, local)
    _deterministic(True)
    nh, nw = spec["spatial_narrow_hw"]
    forward("narrow", fes["float32"].model,
            shard_images_spatial(spatial_image(seed, nh, nw, dev), smesh))
    forward("vgg", spatial_vgg(seed, dev), shard_images_spatial(image[..., :1], smesh))
    if dev == "cuda":
        _deterministic(False)
        model = fes["bfloat16"].model
        torch.distributed.barrier()
        out["ms"] = host_median_ms(lambda: sharded(model, local), runs=spec["spatial_timed"])
        bh, bw = spec["spatial_big_hw"]
        big = torch.rand((1, bh, bw // world, 3), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed))
        out["peak_mib"] = {"serving": peak_mib(lambda: sharded(model, local)),
                           "large": peak_mib(lambda: sharded(model, big))}
        del big
    out["launches"] = kernel_counts()

    # extract_spatial: one decode and one NMS launch a call, counted apart
    zero_kernel_counts()
    out["extract"] = {}
    for dtype in ("float32", "bfloat16"):
        _deterministic(dtype == "float32")
        spatial.reset_counts()
        out["extract"][dtype] = spatial_extract(fes[dtype], image, smesh)
        out["extract"][dtype]["counts"] = dict(spatial.counts)
    out["extract_launches"] = kernel_counts()
    if dev == "cuda":
        # the decode kernel at the shape this path gives it, this rank's
        # logits block, held to its plain version as phase 2 holds it
        out["decode_block"] = {
            dtype: [tuple(logits_blocks[dtype].shape), *decode_against_plain(
                logits_blocks[dtype], fes[dtype].config.cell,
                fes[dtype].config.confidence_thresh, f"decode {dtype} W-sharded block")[1:]]
            for dtype in ("float32", "bfloat16")}
        _deterministic(False)
        fe = fes["bfloat16"]
        block = torch.rand((1, h, w // world), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
        torch.distributed.barrier()
        out["extract_ms"] = host_median_ms(lambda: fe.extract_spatial(image, smesh),
                                           runs=spec["spatial_timed"])
        out["gather_ms"] = host_median_ms(lambda: spatial.gather_width(block, 2, smesh.group),
                                          runs=spec["spatial_timed"])
    out["s"] = time.perf_counter() - t0
    _deterministic(True)
    return out


def spatial_one_rank(spec: dict) -> dict:
    """The NCCL rank's part: a width mesh of one rank gives the plain
    forward and `extract` bit for bit (the extract's launches counted), and
    `spatial.halo` over NCCL pads a block with the op's value bit for bit."""
    import math

    import torch.nn.functional as F

    from feature_point_cnn_tpu_torch.parallel import spatial
    from feature_point_cnn_tpu_torch.parallel.mesh import (
        make_spatial_mesh,
        shard_images_spatial,
    )

    dev, (h, w) = spec["device"], spec["spatial_hw"]
    _deterministic(True)
    smesh = make_spatial_mesh(1)
    images = spatial_image(spec["seed"], h, w, dev)
    fe = spatial_frontend("float32", dev)
    model = fe.model
    x = torch.randn((1, 4, 6, 10), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(spec["seed"]))
    zero_kernel_counts()
    with torch.inference_mode():
        plain = model(images)
        spatial.reset_counts()
        with spatial.width_group(smesh.group):
            got = model(shard_images_spatial(images, smesh))
            forward_exchanges = spatial.counts["exchanges"]
            pads = (spatial.halo(x, 3, 2), spatial.halo(x, 1, 0, -math.inf))
    out = {"bit_equal": all(torch.equal(a, b) for a, b in zip(got, plain)),
           "forward_exchanges": forward_exchanges,
           "halo_exchanges": spatial.counts["exchanges"] - forward_exchanges,
           "halo_equal": (torch.equal(pads[0], F.pad(x, (3, 2)))
                          and torch.equal(pads[1], F.pad(x, (1, 0), value=-math.inf))),
           "launches": kernel_counts()}
    want = spatial_extract(fe, images)
    zero_kernel_counts()
    got = spatial_extract(fe, images, smesh)
    out["extract_launches"] = kernel_counts()
    out["extract_bit_equal"] = all(torch.equal(got[k], v) for k, v in want.items())
    return out


def spatial_reference(spec: dict) -> dict:
    """This process's one-process runs of the W-sharded scenario: the
    forward of the image at float32 (TF32 off; the bf16 prob map and its
    top-K keypoints too), at 8 px a shard's width, and the seeded VGG's;
    `extract` at float32 and bf16; on the card bf16 ms a forward and an
    extract and peak MiB at the serving and the large point."""
    dev, (h, w), seed = spec["device"], spec["spatial_hw"], spec["seed"]
    nh, nw = spec["spatial_narrow_hw"]
    image = spatial_image(seed, h, w, dev)
    ref = {"extract": {}}
    for dtype in ("float32", "bfloat16"):
        _deterministic(dtype == "float32")
        fe = spatial_frontend(dtype, dev)
        with torch.inference_mode():
            ref[dtype] = [t.cpu() for t in fe.model(image)]
            if dtype == "float32":
                ref["narrow"] = [t.cpu() for t in fe.model(spatial_image(seed, nh, nw, dev))]
                ref["vgg"] = [t.cpu() for t in spatial_vgg(seed, dev)(image[..., :1])]
        ref["extract"][dtype] = spatial_extract(fe, image)
    ref["keypoints"] = spatial_keypoints(ref["bfloat16"][0], dev)
    if dev == "cuda":
        model = fe.model
        bh, bw = spec["spatial_big_hw"]
        big = torch.rand((1, bh, bw, 3), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed))
        with torch.inference_mode():
            ref["ms"] = host_median_ms(lambda: model(image), runs=spec["spatial_timed"])
            ref["peak_mib"] = {"serving": peak_mib(lambda: model(image)),
                               "large": peak_mib(lambda: model(big))}
        ref["extract_ms"] = host_median_ms(lambda: fe.extract(image), runs=spec["spatial_timed"])
        del big, model
    del fe
    _deterministic(False)
    return ref


def spatial_keypoints(prob: torch.Tensor, device):
    """The top-`PAR_SPATIAL_K` keypoints of a whole prob map, ``(y, x,
    valid)``."""
    from feature_point_cnn_tpu_torch.config import SuperPointConfig
    from feature_point_cnn_tpu_torch.ops.detection import extract_keypoints

    kp = extract_keypoints(prob.to(device), SuperPointConfig(max_keypoints=PAR_SPATIAL_K))
    return kp.y.cpu(), kp.x.cpu(), kp.valid.cpu()


def spatial_train_step(spec: dict, kind: str, dtype: str, batch: dict, smesh=None) -> dict:
    """One `superpoint_train_step` (``kind`` ``"superpoint"``) or
    `magicpoint_train_step` (descriptor frozen) from the seeded parameters
    at `SuperPointConfig()`'s widths, ``adam_eps`` 1, on ``batch`` (whole,
    on the host): W-sharded over ``smesh`` (this rank's block of the image,
    under `width_group`) or, with ``smesh`` None, one process.  Returns
    ``step`` (a call takes one more step), the metrics, the state after the
    step on the host, the wrappers' launches in the step (counted from 0)
    and what the width group's gathers carried."""
    from feature_point_cnn_tpu_torch.config import SuperPointConfig
    from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
    from feature_point_cnn_tpu_torch.parallel import spatial
    from feature_point_cnn_tpu_torch.parallel.mesh import shard_images_spatial
    from feature_point_cnn_tpu_torch.train import steps as S
    from feature_point_cnn_tpu_torch.train.optimizer import make_optimizer

    dev = spec["device"]
    cfg = SuperPointConfig(lr_schedule="constant", compute_dtype=dtype,
                           train_image_size=tuple(batch["image"].shape[1:3]),
                           batch_size=batch["image"].shape[0], adam_eps=1.0)
    model = SuperPoint(cfg, generator=torch.Generator().manual_seed(spec["seed"] + 14),
                       float32_params=True).to(dev, memory_format=torch.channels_last)
    frozen = "descriptor" if kind == "magicpoint" else None
    state = S.create_train_state(model, make_optimizer(cfg, model.named_parameters(),
                                                       frozen_subtree=frozen))
    local = {k: v.to(dev) for k, v in batch.items()}
    if smesh is not None:
        local["image"] = shard_images_spatial(local["image"], smesh)
    fn = S.superpoint_train_step if kind == "superpoint" else S.magicpoint_train_step
    gen = torch.Generator(device=dev).manual_seed(spec["seed"] + 141)

    def step():
        with spatial.width_group(None if smesh is None else smesh.group):
            return fn(state, local, gen, config=cfg)[1]

    zero_kernel_counts()
    spatial.reset_counts()
    m = step()
    if dev == "cuda":
        torch.cuda.synchronize()
    return {"step": step, "metrics": {k: float(v) for k, v in m.items()},
            "state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "launches": kernel_counts(), "gathers": dict(spatial.counts)}


def spatial_train_batch(spec: dict, batch: dict) -> dict:
    """The W-sharded steps' batch: the first `PAR_SPATIAL_TRAIN_B` scenes of
    the parallel steps' global batch at the training point."""
    return {k: v[:spec["spatial_train_b"]] for k, v in batch.items()}


def spatial_big_batch(spec: dict) -> dict:
    """The peak-memory batch: one random image at `PAR_SPATIAL_TRAIN_BIG_HW`
    with 32 points."""
    bh, bw = spec["spatial_train_big_hw"]
    g = torch.Generator().manual_seed(spec["seed"] + 142)
    return {"image": torch.rand((1, bh, bw, 3), generator=g),
            "points": torch.rand((1, 32, 2), generator=g) * torch.tensor([bh - 1.0, bw - 1.0]),
            "points_valid": torch.ones((1, 32), dtype=torch.bool)}


def spatial_train_rank(spec: dict, world: int, batch: dict) -> dict:
    """Phase 13's W-sharded training on a gloo rank: `superpoint_train_step`
    and `magicpoint_train_step` over the width mesh of ``world`` ranks at
    float32 (TF32 off), their launches counted from 0 before each; the
    descriptor-loss kernel on the inputs this rank's step gave it against
    its plain version; on the card, bf16 ms a step and peak MiB at
    `PAR_SPATIAL_TRAIN_BIG_HW`, B = 1."""
    from feature_point_cnn_tpu_torch.ops.kernels.descriptor_loss import (
        hinge_descriptor_loss_cuda, hinge_descriptor_loss_plain)
    from feature_point_cnn_tpu_torch.parallel.mesh import make_spatial_mesh
    from feature_point_cnn_tpu_torch.train import loss as L

    t0 = time.perf_counter()
    smesh = make_spatial_mesh(world)
    small = spatial_train_batch(spec, batch)
    _deterministic(True)
    seen = []

    def recording(*args):
        seen.append([a.detach().clone() if torch.is_tensor(a) else a for a in args])
        return hinge_descriptor_loss_cuda(*args)

    L.hinge_descriptor_loss_cuda = recording
    try:
        out = {kind: spatial_train_step(spec, kind, "float32", small, smesh)
               for kind in ("superpoint", "magicpoint")}
    finally:
        L.hinge_descriptor_loss_cuda = hinge_descriptor_loss_cuda
    for r in out.values():
        del r["step"]
    out["loss_inputs"] = [tuple(a[0].shape) for a in seen]
    if spec["device"] == "cuda" and seen:
        # the kernels at the shape this path gives them, against the plain
        # version, as phase 6 holds them
        args = seen[0]

        def value_and_grads(fn):
            d = args[0].clone().requires_grad_(True)
            wd = args[1].clone().requires_grad_(True)
            v = fn(d, wd, *args[2:])
            v.backward()
            return v.detach(), d.grad, wd.grad

        got, want = value_and_grads(hinge_descriptor_loss_cuda), \
            value_and_grads(hinge_descriptor_loss_plain)
        torch.cuda.synchronize()
        gmax = max(float(w_.abs().max()) for w_ in want[1:])
        out["kernel_check"] = {
            "shape": tuple(args[0].shape),
            "value": [float(got[0]), float(want[0])],
            "value_ok": bool(torch.allclose(got[0], want[0], rtol=2e-5, atol=0.0)),
            "grad_err": max(float((g - w_).abs().max()) for g, w_ in zip(got[1:], want[1:])),
            "grad_max": gmax,
            "grads_ok": all(bool(torch.allclose(g, w_, rtol=2e-4, atol=2e-6 * gmax))
                            for g, w_ in zip(got[1:], want[1:]))}
        _deterministic(False)
        torch.distributed.barrier()
        step16 = spatial_train_step(spec, "superpoint", "bfloat16", small, smesh)
        torch.distributed.barrier()
        out["ms"] = host_median_ms(step16["step"], runs=spec["spatial_train_timed"])
        del step16
        big = spatial_train_step(spec, "superpoint", "bfloat16", spatial_big_batch(spec),
                                 smesh)
        torch.distributed.barrier()
        out["peak_mib"] = peak_mib(big["step"])
        del big
        torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    _deterministic(True)
    return out


def spatial_train_reference(spec: dict, batch: dict) -> dict:
    """This process's one-process steps of the W-sharded training: both at
    float32 (TF32 off) from the same parameters, batch and generator; on
    the card bf16 ms a step and peak MiB at `PAR_SPATIAL_TRAIN_BIG_HW`."""
    small = spatial_train_batch(spec, batch)
    _deterministic(True)
    ref = {kind: spatial_train_step(spec, kind, "float32", small)
           for kind in ("superpoint", "magicpoint")}
    for r in ref.values():
        del r["step"]
    if spec["device"] == "cuda":
        _deterministic(False)
        step16 = spatial_train_step(spec, "superpoint", "bfloat16", small)
        ref["ms"] = host_median_ms(step16["step"], runs=spec["spatial_train_timed"])
        del step16
        big = spatial_train_step(spec, "superpoint", "bfloat16", spatial_big_batch(spec))
        ref["peak_mib"] = peak_mib(big["step"])
        del big
        torch.cuda.empty_cache()
    _deterministic(False)
    return ref


def parallel_worker(role: str, rank: int, world: int, port: int, work: Path) -> int:
    """One rank of phase 13: ``role`` ``gloo`` (the two ranks sharing the
    card) or ``nccl`` (one rank, the graphed trainer).  Writes
    ``<work>/<role>_<rank>.pt``."""
    from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
    from feature_point_cnn_tpu_torch.data.device_store import DeviceBatchLoader, make_loader
    from feature_point_cnn_tpu_torch.data.packed import PackedPointDataset
    from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
    from feature_point_cnn_tpu_torch.parallel import distributed
    from feature_point_cnn_tpu_torch.parallel.mesh import batch_sharding
    from feature_point_cnn_tpu_torch.selflabel.coco import preprocess_folder
    from feature_point_cnn_tpu_torch.slam.bundle import bundle_adjust, synthetic_ba_problem
    from feature_point_cnn_tpu_torch.train import steps as S
    from feature_point_cnn_tpu_torch.train.trainer import Trainer
    from feature_point_cnn_tpu_torch.utils.weights import released_path

    spec = json.loads((work / "spec.json").read_text())
    dev, seed = spec["device"], spec["seed"]
    distributed.initialize(f"localhost:{port}", world, rank, device=dev,
                           backend="gloo" if role == "gloo" else None)
    mesh = distributed.global_mesh()
    check((mesh.size, mesh.rank) == (world, rank), f"{role} rank {rank}: mesh {mesh}")
    cfg32 = SuperPointConfig(lr_schedule="constant", compute_dtype="float32",
                             train_image_size=tuple(spec["hw"]), batch_size=spec["batch"])
    packed = spec["packed"]
    out = {"role": role, "rank": rank, "backend": str(torch.distributed.get_backend())}
    _deterministic(True)

    if role == "nccl":
        # one joint step from fresh parameters on the global batch, as the
        # parent's one-process step; then an epoch of k = 4 graph replays
        # with the step's collectives captured and the same epoch of eager
        # steps, as phase 11 runs them but at adam_eps = spec["adam_eps"]
        out["step"] = _par_step(spec, cfg32, torch.load(work / "batch.pt"), slice(None))
        ds = PackedPointDataset(packed, "train", seed=seed)
        loader = make_loader(ds, spec["batch"], cfg32.max_points, seed=seed, device=dev)
        zero_kernel_counts()
        for k in (spec["k"], 1):
            tr = Trainer(cfg32.replace(train_steps_per_call=k, adam_eps=spec["adam_eps"]),
                         "superpoint", loader, None, str(work / f"ck_nccl_{k}"), seed=seed,
                         device=dev, log_every=1)
            m = tr.train_epoch(0)
            tr.writer.close()
            out[f"k{k}"] = {
                "steps": tr.state.step, "graphed": tr._graph is not None,
                "loss": m.get("loss"),
                "state": {n: v.detach().cpu() for n, v in tr.state.model.state_dict().items()}}
            if k > 1:
                out["launches"] = {n: c + out["step"]["launches"][n]
                                   for n, c in kernel_counts().items()}
                if dev == "cuda":
                    # what the card runs of NCCL in a call of k replays
                    idxs = list(loader.epoch_index_arrays(1))[:k]
                    ops = trace_device(lambda: tr.train_steps(idxs, 1, 0), calls=1)
                    out["nccl_ops"] = {n: c for n, (c, _) in ops.items()
                                       if "nccl" in n.lower()}
            del tr
        out["spatial_one"] = spatial_one_rank(spec)
        torch.save(out, work / f"{role}_{rank}.pt")
        torch.distributed.destroy_process_group()
        return 0

    batch = torch.load(work / "batch.pt")
    rows = batch_sharding(mesh, spec["batch"])
    launches = {k: 0 for k in kernel_counts()}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    # 1-2. the joint step at full width, microbatch_steps 1 and 2
    for k in (1, 2):
        r = _par_step(spec, cfg32.replace(microbatch_steps=k), batch, rows)
        out[f"step_k{k}"] = r
        add(r["launches"])

    # 3. Trainer on the item-sharded loader over phase 11's packed split
    ds = PackedPointDataset(packed, "train", seed=seed)
    loader = DeviceBatchLoader(ds, spec["batch"], cfg32.max_points, device=dev, seed=seed,
                               items_placement="sharded")
    seen = []
    plain_gather = loader.gather_fn()

    def recording_gather(images, points, counts, idx):
        got = plain_gather(images, points, counts, idx)
        seen.append((idx.cpu().numpy().copy(),
                     got["image"].to(torch.int64).sum(dim=(1, 2, 3)).cpu().numpy()))
        return got

    loader.gather_fn = lambda: recording_gather
    zero_kernel_counts()
    tr = Trainer(cfg32, "superpoint", loader, None, str(work / "ck_sharded"), seed=seed,
                 device=dev, log_every=1)
    tr.train(epochs=1)
    add(kernel_counts())
    out["trainer"] = {"steps": tr.state.step, "seen": seen, "launches": kernel_counts(),
                      "per_rank_items": loader.images.shape[0],
                      "state": {k: v.detach().cpu()
                                for k, v in tr.state.model.state_dict().items()}}
    del tr, loader

    # 4. extract_sharded with the released weights, float32
    fe = SuperPointFrontend(SuperPointConfig(compute_dtype="float32"),
                            weights_path=released_path(), device=dev)
    frames = torch.from_numpy(serving_frames(seed)[1][:, :spec["extract_hw"][0],
                                                      :spec["extract_hw"][1]])
    images = (frames.float() / 255.0).expand(-1, -1, -1, 3).contiguous()
    erows = batch_sharding(mesh, images.shape[0])
    zero_kernel_counts()
    kp, desc = fe.extract_sharded(images, mesh)
    ext_launches = kernel_counts()
    add(ext_launches)
    lkp, ldesc = fe.extract(images[erows])
    wkp, wdesc = fe.extract(images)

    def cpu(k, d):
        return {**{f: getattr(k, f).cpu() for f in k._fields}, "desc": d.cpu()}

    out["extract"] = {"sharded": cpu(kp, desc), "local": cpu(lkp, ldesc),
                      "whole": cpu(wkp, wdesc), "launches": ext_launches,
                      "rows": [erows.start, erows.stop]}
    del fe

    # 5. self-labeling over the mesh, under phase 9's settings (bf16)
    _deterministic(False)
    fe = SuperPointFrontend(SuperPointConfig(train_image_size=tuple(spec["hw"])),
                            weights_path=str(Path(released_path()).parent
                                             / "magicpoint_synth_r3.npz"), device=dev)
    zero_kernel_counts()
    t0 = time.perf_counter()
    written = preprocess_folder(fe, spec["bmp_dir"], str(work / "sl_mesh"),
                                HomographyConfig.for_preprocess().replace(
                                    num=spec["homo_num"]),
                                batch_size=spec["sl_batch"], seed=seed)
    out["selflabel"] = {"written": written, "s": time.perf_counter() - t0,
                        "launches": kernel_counts()}
    add(kernel_counts())
    del fe

    # 6. landmark-sharded bundle adjustment
    _deterministic(True)
    problem, _, _ = synthetic_ba_problem(np.random.default_rng(seed + 120), *spec["ba"],
                                         device=dev)
    poses, points, costs = bundle_adjust(problem, mesh, iters=10)
    out["ba"] = {"poses": poses.cpu(), "points": points.cpu(), "costs": costs.cpu()}
    out["launches"] = launches

    # 7. one image W-sharded over the two ranks (its launches apart): the
    # forward and extract, then both train steps
    out["spatial"] = spatial_rank(spec, world)
    out["spatial_train"] = spatial_train_rank(spec, world, batch)

    # bf16 ms/step, both ranks at once on the one card
    _deterministic(False)
    cfg = cfg32.replace(compute_dtype="bfloat16")
    from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
    from feature_point_cnn_tpu_torch.train.optimizer import make_optimizer

    model = SuperPoint(cfg, generator=torch.Generator().manual_seed(seed + 13),
                       float32_params=True).to(dev, memory_format=torch.channels_last)
    state = S.create_train_state(model, make_optimizer(cfg, model.named_parameters()))
    local = {k: v[rows].to(dev) for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.distributed.barrier()
    if dev == "cuda":
        out["step_ms_bf16"] = host_median_ms(
            lambda: S.superpoint_train_step(state, local, gen, config=cfg),
            runs=spec["timed_steps"])
    torch.save(out, work / f"{role}_{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def _launch_ranks(role: str, world: int, work: Path) -> list:
    """Start ``world`` ranks of ``role`` as processes of this script, wait for
    them (``PAR_TIMEOUT_S``), fail the phase if one fails, and return their
    outputs in rank order."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "LOCAL_RANK": "0"}
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    logs = [work / f"{role}_{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--parallel-worker", role,
                 "--rank", str(r), "--world", str(world), "--port", str(port),
                 "--work", str(work)], stdout=f, stderr=subprocess.STDOUT, env=env))
    deadline = time.perf_counter() + PAR_TIMEOUT_S
    try:
        for r, p in enumerate(procs):
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        for r, p in enumerate(procs):
            tail = "\n".join(logs[r].read_text().splitlines()[-40:])
            check(p.returncode == 0, f"{role} rank {r} exited {p.returncode}:\n{tail}")
    except subprocess.TimeoutExpired:
        check(False, f"{role} ranks did not finish in {PAR_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(work / f"{role}_{r}.pt", weights_only=False) for r in range(world)]


def _max_err(a: list, b: list) -> dict:
    return {k: float((x - y).abs().max()) for k, x, y in zip(("prob", "desc", "logits"), a, b)}


def _forward_gates(what: str, err: dict, same: bool, counts: dict, exchanges: int,
                   d: int, rows: int) -> None:
    """The gates of a W-sharded forward; ``counts`` the exchanges' by dtype,
    none larger than the strips of the widest halo, ``(d, 2, B, 64, rows,
    1)``."""
    check(err["prob"] <= 2e-4 and err["desc"] <= 1e-4 and err["logits"] <= 1e-4,
          f"spatial {what}: the gathered forward equals one process's (prob 2e-4, "
          "descriptors and logits 1e-4)")
    check(same, f"spatial {what}: every rank gathers the same outputs bit for bit")
    check(all(c["exchanges"] == exchanges and 0 < c["largest_bytes"]
              <= d * 2 * 64 * rows * (4 if dtype == "float32" else 2)
              for dtype, c in counts.items()),
          f"spatial {what}: {exchanges} exchanges a forward, none larger than its "
          "widest halo")


def spatial_check(spec: dict, ref: dict, got: list, card: str) -> dict:
    """Phase 13's W-sharded gates on the gloo ranks' outputs.  Forwards
    (the image at float32, TF32 off; 8 px a shard; the VGG): gathered =
    this process's forward (prob atol 2e-4, JAX's; logits and descriptors
    1e-4), the ranks' gathered outputs bit-identical, every exchange
    halo-sized, no wrapper launched.  `extract_spatial`: the ranks' outputs
    bit-identical, one decode and one NMS launch a rank a call, and at
    float32 >= 0.99 of this process's keypoints with descriptors within
    1e-4 where both hold the keypoint (bf16: >= 0.9).  At float32 every
    keypoint of either extract is in the other, but for flips that a tie
    within the forward's prob tolerance (2e-4) explains (`untied_flips`).
    The decode kernel on each rank's logits block agrees with its plain
    version (`decode_against_plain`).  Printed: the bf16 forward's
    distance and top-256 overlap, and the cost."""
    (h, w), d = spec["spatial_hw"], len(got)
    nh, nw = spec["spatial_narrow_hw"]
    err = _max_err(got[0]["float32"]["gathered"], ref["float32"])

    def same(name):
        return all(torch.equal(a, b) for g in got[1:]
                   for a, b in zip(g[name]["gathered"], got[0][name]["gathered"]))

    counts = {dtype: got[0][dtype]["counts"] for dtype in ("float32", "bfloat16")}
    full_pool_input = 64 * (h // 2) * (w // 2) * 4
    print(f"parallel spatial: one {h}x{w} image over {d} ranks sharing the card over gloo, "
          f"{got[0]['float32']['local_shapes']} a rank; float32 (TF32 off) gathered vs "
          f"this process's forward max|diff| prob {err['prob']:.3g}, desc {err['desc']:.3g}, "
          f"logits {err['logits']:.3g}; ranks' gathered outputs bit-identical "
          f"{same('float32') and same('bfloat16')}; a forward's exchanges "
          f"{counts['float32']} float32, {counts['bfloat16']} bf16 (the largest "
          f"{counts['float32']['largest_bytes']} B against a full-width pool input of "
          f"{full_pool_input} B); wrapper launches a rank {[g['launches'] for g in got]}; "
          f"{[round(g['s'], 1) for g in got]} s a rank")
    # the widest halo: the ResNet's max pool at H/2 rows, the VGG's second
    # convolution at H
    _forward_gates("float32", err, same("float32") and same("bfloat16"), counts, 13, d, h // 2)
    check(all(v == 0 for g in got for v in g["launches"].values()),
          "spatial: the forwards launch no wrapper")
    narrow_err = _max_err(got[0]["narrow"]["gathered"], ref["narrow"])
    vgg_err = _max_err(got[0]["vgg"]["gathered"], ref["vgg"])
    print(f"parallel spatial at 8 px a shard ({nh}x{nw}, {got[0]['narrow']['local_shapes']} "
          f"a rank), float32: max|diff| {narrow_err}, exchanges {got[0]['narrow']['counts']}; "
          f"VGG {h}x{w} gray ({got[0]['vgg']['local_shapes']} a rank), float32: max|diff| "
          f"{vgg_err}, exchanges {got[0]['vgg']['counts']}")
    _forward_gates("8 px a shard", narrow_err, same("narrow"),
                   {"float32": got[0]["narrow"]["counts"]}, 13, d, nh // 2)
    _forward_gates("VGG", vgg_err, same("vgg"), {"float32": got[0]["vgg"]["counts"]}, 10, d, h)

    prob16 = got[0]["bfloat16"]["gathered"][0]
    dist16 = float((prob16 - ref["bfloat16"][0]).abs().max())
    overlap = keypoint_overlap(spatial_keypoints(prob16, spec["device"]), ref["keypoints"])
    out = {"err_f32": err, "bit_identical": same("float32") and same("bfloat16"),
           "counts": counts, "bf16_prob_dist": dist16, "bf16_topk_overlap": overlap,
           "narrow_err": narrow_err, "vgg_err": vgg_err, "s": [g["s"] for g in got]}
    print(f"parallel spatial bf16: prob max|sharded - one process| {dist16:.4g}, top-"
          f"{PAR_SPATIAL_K} keypoint overlap {overlap:.4f}")

    ext = {}
    for dtype, floor in (("float32", 0.99), ("bfloat16", 0.9)):
        mine, want = got[0]["extract"][dtype], ref["extract"][dtype]
        shared = (mine["valid"] & want["valid"] & (mine["y"] == want["y"])
                  & (mine["x"] == want["x"]))
        ext[dtype] = {
            "overlap": keypoint_overlap((mine["y"], mine["x"], mine["valid"]),
                                        (want["y"], want["x"], want["valid"])),
            "keypoints": [int(mine["valid"].sum()), int(want["valid"].sum())],
            "desc_err": float((mine["desc"] - want["desc"])[shared].abs().max())
                        if bool(shared.any()) else 0.0,
            "ranks_equal": all(torch.equal(g["extract"][dtype][k], v)
                               for g in got[1:] for k, v in mine.items() if k != "counts"),
            "bytes": {k: mine["counts"][k] for k in ("bytes", "gather_bytes")}}
        e = ext[dtype]
        print(f"parallel extract_spatial {dtype}: keypoints {e['keypoints'][0]} (one process "
              f"{e['keypoints'][1]}), overlap with this process's extract {e['overlap']:.4f}, "
              f"descriptors max|diff| where both hold the keypoint {e['desc_err']:.3g}; ranks "
              f"bit-identical {e['ranks_equal']}; {mine['counts']['exchanges']} exchanges "
              f"({e['bytes']['bytes']} B) and {mine['counts']['gathers']} gathers "
              f"({e['bytes']['gather_bytes']} B) a call")
        check(e["ranks_equal"], f"extract_spatial {dtype}: every rank holds the same outputs")
        check(e["overlap"] >= floor, f"extract_spatial {dtype}: >= {floor} of this process's "
                                     "keypoints")
        if dtype == "float32":
            from feature_point_cnn_tpu_torch.config import SuperPointConfig

            cfg = SuperPointConfig()
            flips, untied = untied_flips(mine, want, cfg.confidence_thresh, cfg.nms_dist,
                                         cfg.max_keypoints, 2e-4)
            e["flips"] = [flips, untied]
            print(f"parallel extract_spatial float32: {flips} keypoints in one extract "
                  f"and not the other, {untied} of them not at a tie within 2e-4")
            check(untied == 0, "extract_spatial float32: every keypoint of either extract "
                               "in the other, but for ties within 2e-4")
            check(e["desc_err"] <= 1e-4, "extract_spatial float32: descriptors within 1e-4 "
                                         "of this process's where both hold the keypoint")
    launches = [g["extract_launches"] for g in got]
    print(f"parallel extract_spatial wrapper launches a rank for its 2 calls {launches}")
    if spec["device"] == "cuda":
        out["decode_block"] = [g["decode_block"] for g in got]
        print(f"parallel extract_spatial: the decode kernel on each rank's logits block "
              f"against its plain version, [shape, max|diff|, mask flips] by dtype a rank "
              f"{out['decode_block']}")
    if spec["device"] == "cuda":
        check(all(n["decode_threshold"] == 2 and n["grid_nms"] == 2
                  and n["descriptor_loss_fwd"] == n["descriptor_loss_bwd"] == 0
                  for n in launches),
              "extract_spatial: one decode and one NMS launch a rank a call")
    out["extract"] = ext
    if spec["device"] == "cuda":
        out.update(ms=[g["ms"] for g in got], one_ms=ref["ms"],
                   peak_mib=[g["peak_mib"] for g in got], one_peak_mib=ref["peak_mib"],
                   extract_ms=[g["extract_ms"] for g in got], one_extract_ms=ref["extract_ms"],
                   gather_ms=[g["gather_ms"] for g in got])
        print(f"parallel spatial cost, TWO PROCESSES SHARING ONE CARD (the route, not "
              f"scaling): bf16 sharded forward {out['ms']} ms a rank against one process "
              f"{ref['ms']:.3f} ms; {counts['bfloat16']['exchanges']} exchanges, "
              f"{counts['bfloat16']['bytes']} B a forward; peak MiB a rank {out['peak_mib']} "
              f"against one process {ref['peak_mib']} (serving {h}x{w}, large "
              f"{spec['spatial_big_hw'][0]}x{spec['spatial_big_hw'][1]}, B = 1) [{card}]")
        print(f"parallel extract_spatial cost, TWO PROCESSES SHARING ONE CARD (the route, not "
              f"scaling): bf16 {out['extract_ms']} ms a call a rank against one process's "
              f"extract {ref['extract_ms']:.3f} ms; a {h}x{w // d} float32 score-map gather "
              f"{out['gather_ms']} ms; {ext['bfloat16']['bytes']} B a call [{card}]")
    return out


def spatial_train_check(spec: dict, ref: dict, got: list, card: str) -> dict:
    """Phase 13's W-sharded training gates, each step at float32 (TF32 off)
    against this process's one-process step from the same parameters,
    batch and generator: the loss and its parts within rtol 1e-5, the F1
    within 1e-3 (two of the 1,200 cells of a sample), each head's gradient
    norm within rtol 1e-3, every parameter within atol 2e-6 + rtol 1e-4 and
    every BatchNorm statistic within atol 2e-5 + rtol 1e-4; the ranks'
    parameters and statistics bit for bit; the descriptor-loss kernels
    launched once forward and once backward on each rank in the SuperPoint
    step (none in the MagicPoint step), and on the card the kernel on the
    inputs the step gave it within phase 6's tolerances of its plain
    version.  Printed: the gathers' bytes a step (the descriptor maps'
    share), bf16 ms a step a rank and peak MiB a rank at the large point
    against one process."""
    d = len(got)
    out = {}
    for kind in ("superpoint", "magicpoint"):
        want, mine = ref[kind], got[0][kind]
        errs = {}
        for k, v in want["metrics"].items():
            errs[k] = abs(mine["metrics"][k] - v) / (1.0 if k == "f1" else max(abs(v), 1e-30))
        state_ratio, stat_ratio = 0.0, 0.0
        for k, v in want["state"].items():
            if not v.is_floating_point():
                continue
            diff = (mine["state"][k].double() - v.double()).abs()
            if "running" in k:
                stat_ratio = max(stat_ratio, float((diff / (2e-5 + 1e-4 * v.double().abs())).max()))
            else:
                state_ratio = max(state_ratio, float((diff / (2e-6 + 1e-4 * v.double().abs())).max()))
        same = all(torch.equal(v, g[kind]["state"][k]) for g in got[1:]
                   for k, v in mine["state"].items())
        launches = [(g[kind]["launches"]["descriptor_loss_fwd"],
                     g[kind]["launches"]["descriptor_loss_bwd"]) for g in got]
        out[kind] = {"errs": errs, "param_ratio": state_ratio, "stat_ratio": stat_ratio,
                     "bit_identical": same, "launches": launches,
                     "gather_bytes": mine["gathers"]["gather_bytes"],
                     "gathers": mine["gathers"]["gathers"]}
        print(f"parallel spatial train {kind}: {d} ranks, the {spec['hw'][0]}x{spec['hw'][1]} "
              f"batch of {spec['spatial_train_b']} W-sharded, float32 (TF32 off), against one "
              f"process: metrics' relative differences {errs} (f1 absolute); parameters "
              f"{state_ratio:.3g} and statistics {stat_ratio:.3g} of their tolerances; ranks "
              f"bit-identical {same}; descriptor-loss launches (forward, backward) a rank "
              f"{launches}; {mine['gathers']['gathers']} gathers, "
              f"{mine['gathers']['gather_bytes']} B a step")
        loss_keys = [k for k in want["metrics"] if "loss" in k]
        norm_keys = [k for k in want["metrics"] if k.startswith("grad_norm")]
        check(all(errs[k] <= 1e-5 for k in loss_keys),
              f"spatial train {kind}: the loss and its parts within rtol 1e-5 of one process")
        check(errs["f1"] <= 1e-3, f"spatial train {kind}: f1 within 1e-3 of one process")
        check(all(errs[k] <= 1e-3 for k in norm_keys),
              f"spatial train {kind}: gradient norms within rtol 1e-3 of one process")
        check(state_ratio <= 1.0, f"spatial train {kind}: parameters within atol 2e-6 + "
                                  "rtol 1e-4 of one process")
        check(stat_ratio <= 1.0, f"spatial train {kind}: BatchNorm statistics within atol "
                                 "2e-5 + rtol 1e-4 of one process")
        check(same, f"spatial train {kind}: the ranks' parameters and statistics bit for bit")
        if spec["device"] == "cuda":
            want_launches = (1, 1) if kind == "superpoint" else (0, 0)
            check(all(n == want_launches for n in launches),
                  f"spatial train {kind}: descriptor-loss launches {want_launches} a rank")
    b, (h, w) = spec["spatial_train_b"], spec["hw"]
    desc_bytes = 2 * b * (h // 8) * (w // 8) * 128 * 4
    print(f"parallel spatial train: the descriptor loss's inputs a rank "
          f"{[g['loss_inputs'] for g in got]}; the two float32 descriptor maps gathered "
          f"whole {desc_bytes} B a step forward and their gradients as much backward, of "
          f"the step's {out['superpoint']['gather_bytes']} B of gathers; at B = 32 the maps "
          f"would be {desc_bytes * 32 // b} B")
    if spec["device"] == "cuda":
        kc = [g["kernel_check"] for g in got]
        print(f"parallel spatial train: the descriptor-loss kernels on each rank's inputs "
              f"against the plain version {kc}")
        check(all(k["value_ok"] and k["grads_ok"] for k in kc),
              "spatial train: the descriptor-loss kernels on the path's inputs equal the "
              "plain version (value rtol 2e-5, gradients rtol 2e-4 + atol 2e-6 of the "
              "largest)")
        out.update(kernel_check=kc, ms=[g["ms"] for g in got], one_ms=ref["ms"],
                   peak_mib=[g["peak_mib"] for g in got], one_peak_mib=ref["peak_mib"],
                   desc_bytes=desc_bytes)
        bh, bw = spec["spatial_train_big_hw"]
        print(f"parallel spatial train cost, TWO PROCESSES SHARING ONE CARD (the route, not "
              f"scaling): bf16 superpoint_train_step of {b} at {h}x{w} {out['ms']} ms a rank "
              f"against one process {ref['ms']:.3f} ms; peak MiB a rank at {bh}x{bw}, B = 1, "
              f"bf16 {out['peak_mib']} against one process {ref['peak_mib']:.1f} [{card}]")
    return out


def parallel_phase(seed: int, card: str, sl_work: Path, packed: Path,
                   spec_over: dict = None) -> dict:
    """Phase 13: the parallel layer.  Two ranks on the one card over gloo
    (the data-parallel joint step, at microbatch 1 and 2; `Trainer` on the
    item-sharded loader; `extract_sharded`; self-labeling over the mesh;
    landmark-sharded BA), then one rank over NCCL (graphed `Trainer`), each
    held to this process's one-process run."""
    from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
    from feature_point_cnn_tpu_torch.data.datasets import BatchLoader
    from feature_point_cnn_tpu_torch.data.device_store import make_loader
    from feature_point_cnn_tpu_torch.data.packed import PackedPointDataset
    from feature_point_cnn_tpu_torch.ops import kernels
    from feature_point_cnn_tpu_torch.slam.bundle import bundle_adjust, synthetic_ba_problem
    from feature_point_cnn_tpu_torch.train import steps as S
    from feature_point_cnn_tpu_torch.train.trainer import Trainer

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_", dir=str(kernels.BUILD_DIR)))
    spec = {"seed": seed, "device": "cuda", "hw": [240, 320], "batch": PAR_BATCH,
            "packed": str(packed), "bmp_dir": str(work / "bmp"), "sl_batch": SL_BATCH,
            "ba": list(BA_MAP), "extract_hw": [H, W], "timed_steps": PAR_TIMED_STEPS,
            "k": TD_K, "homo_num": HomographyConfig.for_preprocess().num,
            "adam_eps": PAR_ADAM_EPS, "spatial_hw": list(PAR_SPATIAL_HW),
            "spatial_narrow_hw": list(PAR_SPATIAL_NARROW_HW),
            "spatial_big_hw": list(PAR_SPATIAL_BIG_HW), "spatial_timed": PAR_SPATIAL_TIMED,
            "spatial_train_b": PAR_SPATIAL_TRAIN_B,
            "spatial_train_big_hw": list(PAR_SPATIAL_TRAIN_BIG_HW),
            "spatial_train_timed": PAR_SPATIAL_TRAIN_TIMED,
            **(spec_over or {})}
    dev, (th, tw), b = spec["device"], spec["hw"], spec["batch"]
    (work / "spec.json").write_text(json.dumps(spec))
    (work / "bmp").mkdir()
    names = sorted(p.name for p in (sl_work / "images").iterdir())[:PAR_SL_IMAGES]
    for name in names:
        shutil.copy(sl_work / "images" / name, work / "bmp" / name)
    cfg32 = SuperPointConfig(lr_schedule="constant", compute_dtype="float32",
                             train_image_size=(th, tw), batch_size=b)
    item = next(BatchLoader(SceneDataset(seed + 130, b, th, tw), b, cfg32.max_points,
                            shuffle=False).epoch(0))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in item.items()}
    torch.save(batch, work / "batch.pt")

    # the one-process references, the card to itself
    _deterministic(True)
    ref = {k: _par_step(spec, cfg32.replace(microbatch_steps=k), batch, slice(None))
           for k in (1, 2)}
    problem, _, _ = synthetic_ba_problem(np.random.default_rng(seed + 120), *spec["ba"],
                                         device=dev)
    ba_ref = bundle_adjust(problem, iters=10)
    sref = spatial_reference(spec)
    tref = spatial_train_reference(spec, batch)
    _deterministic(False)
    cfg = cfg32.replace(compute_dtype="bfloat16")
    one_ms = None
    if dev == "cuda":
        from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
        from feature_point_cnn_tpu_torch.train.optimizer import make_optimizer

        model = SuperPoint(cfg, generator=torch.Generator().manual_seed(seed + 13),
                           float32_params=True).to(dev, memory_format=torch.channels_last)
        state = S.create_train_state(model, make_optimizer(cfg, model.named_parameters()))
        gbatch = {k: v.to(dev) for k, v in batch.items()}
        gen = torch.Generator(device=dev).manual_seed(seed)
        one_ms = host_median_ms(lambda: S.superpoint_train_step(state, gbatch, gen, config=cfg),
                                runs=spec["timed_steps"])
        del model, state, gbatch
        torch.cuda.empty_cache()

    # ---- two ranks over gloo ---------------------------------------------
    t0 = time.perf_counter()
    ranks = _launch_ranks("gloo", PAR_RANKS, work)
    gloo_s = time.perf_counter() - t0
    print(f"parallel: {PAR_RANKS} ranks over {ranks[0]['backend']} on the one card ran in "
          f"{gloo_s:.1f} s (processes started, kernels loaded from the build cache)")
    on_card = dev == "cuda"

    for k in (1, 2):
        want, got = ref[k], [r[f"step_k{k}"] for r in ranks]
        loss = [g["metrics"]["loss"] for g in got]
        worst = max(float(((g - want["grads"][n]).abs()
                           / (1e-3 + 1e-2 * want["grads"][n].abs())).max())
                    for n, g in got[0]["grads"].items())
        bit = all(torch.equal(v, got[1]["state"][n]) for n, v in got[0]["state"].items())
        print(f"parallel step k = {k}: loss {loss} vs one process {want['metrics']['loss']:.6f}; "
              f"gradients' worst |diff| / (1e-3 + 1e-2 |g|) {worst:.3f}; "
              f"parameters and statistics bit-identical across ranks {bit}; "
              f"descriptor-loss wrappers a rank "
              f"{[(g['launches']['descriptor_loss_fwd'], g['launches']['descriptor_loss_bwd']) for g in got]}")
        check(all(abs(l_ - want["metrics"]["loss"]) <= 1e-5 * abs(want["metrics"]["loss"])
                  for l_ in loss), f"step k = {k}: loss within rtol 1e-5 of one process")
        check(got[0]["grads"].keys() == want["grads"].keys() and worst <= 1.0,
              f"step k = {k}: gradients within atol 1e-3 + rtol 1e-2")
        check(bit, f"step k = {k}: parameters and statistics bit-identical across ranks")
        if on_card:
            check(all(g["launches"]["descriptor_loss_fwd"] == k
                      and g["launches"]["descriptor_loss_bwd"] == k for g in got),
                  f"step k = {k}: the descriptor-loss kernels launched on each rank")

    ds = PackedPointDataset(str(packed), "train", seed=seed)
    sorted_idx = np.sort(ds.index)
    order = _sharded_order(spec, sorted_idx, PAR_RANKS, b, 0)
    tr = [r["trainer"] for r in ranks]
    per = tr[0]["per_rank_items"]
    for r, t in enumerate(tr):
        check(t["steps"] == len(order), f"trainer rank {r}: {len(order)} steps")
        for i, (idx, sums) in enumerate(t["seen"]):
            items = sorted_idx[r * per + idx]
            check(np.array_equal(items, order[i, r]), f"trainer rank {r} batch {i}: "
                  f"the numpy reference order")
            check(np.array_equal(sums, ds.images[items].astype(np.int64).sum(axis=(1, 2, 3))),
                  f"trainer rank {r} batch {i}: the packed rows")
    bit = all(torch.equal(v, tr[1]["state"][n]) for n, v in tr[0]["state"].items())
    finite = all(bool(torch.isfinite(v.float()).all()) for v in tr[0]["state"].values())
    cks = sorted(p.name for p in (work / "ck_sharded").glob("ckpt_*.pt"))
    print(f"parallel trainer: {len(order)} steps of {b} on the item-sharded loader "
          f"({per} items a rank), global batches equal the numpy order; parameters "
          f"bit-identical across ranks {bit}, finite {finite}; checkpoints {cks}; "
          f"wrapper launches a rank {[t['launches'] for t in tr]}")
    check(bit and finite and cks == ["ckpt_0.pt"],
          "trainer: identical finite parameters, rank 0 wrote the checkpoint")

    ex = [r["extract"] for r in ranks]
    for r, e in enumerate(ex):
        lo, hi = e["rows"]
        same = all(torch.equal(e["sharded"][f][lo:hi], e["local"][f]) for f in e["local"])
        whole = all(torch.equal(e["sharded"][f], e["whole"][f]) for f in ("y", "x", "valid"))
        derr = float((e["sharded"]["desc"] - e["whole"]["desc"]).abs().max())
        print(f"parallel extract_sharded rank {r}: its rows bit-equal to extract of them "
              f"{same}; keypoints equal to the B = 8 extract {whole}, descriptors "
              f"max|diff| {derr:.3g}; launches {e['launches']}")
        check(same, f"extract_sharded rank {r}: its rows bit-equal")
        check(whole and derr <= 1e-5, f"extract_sharded rank {r}: equals the B = 8 extract")
        check(all(torch.equal(e["sharded"][f], ex[0]["sharded"][f]) for f in e["sharded"]),
              "extract_sharded: every rank holds the same batch")
        if on_card:
            check(e["launches"]["decode_threshold"] >= 1 and e["launches"]["grid_nms"] >= 1,
                  f"extract_sharded rank {r}: decode and NMS launched")

    sl = [r["selflabel"] for r in ranks]
    single, mesh_out = sl_work / "single", work / "sl_mesh"
    stems = [Path(n).stem + ".npz" for n in names]
    differ = [n for n in stems
              if not all(np.array_equal(np.load(single / n)[f], np.load(mesh_out / n)[f])
                         and np.load(single / n)[f].dtype == np.load(mesh_out / n)[f].dtype
                         for f in ("image", "points"))]
    print(f"parallel selflabel: {[s['written'] for s in sl]} items a rank in "
          f"{[round(s['s'], 2) for s in sl]} s; {len(stems) - len(differ)} of {len(stems)} "
          f"equal to phase 9's single run bit for bit; launches {[s['launches'] for s in sl]}")
    check(sum(s["written"] for s in sl) == len(stems) and not differ,
          f"use_mesh labels equal the single run (differ: {differ[:4]})")

    ba = ranks[0]["ba"]
    cerr = float(((ba["costs"] - ba_ref[2].cpu()).abs() / ba_ref[2].cpu().abs()).max())
    perr = float((ba["poses"] - ba_ref[0].cpu()).abs().max())
    xerr = float((ba["points"] - ba_ref[1].cpu()).abs().max())
    print(f"parallel BA {tuple(spec['ba'])}: costs rel {cerr:.3g}, poses {perr:.3g}, "
          f"points {xerr:.3g} against one rank; ranks equal "
          f"{all(torch.equal(ba[k], ranks[1]['ba'][k]) for k in ba)}")
    check(cerr <= 1e-5 and perr <= 1e-4 and xerr <= 1e-4,
          "sharded BA within rtol 1e-5 (costs) and 1e-4 (poses, points) of one rank")

    sp = spatial_check(spec, sref, [r["spatial"] for r in ranks], card)
    sp["train"] = spatial_train_check(spec, tref, [r["spatial_train"] for r in ranks], card)

    # ---- one rank over NCCL: the graphed trainer ---------------------------
    # the reference: this process's k = 4 graphed epoch at the NCCL rank's
    # adam_eps
    _deterministic(True)
    k4 = spec["k"]
    plain = Trainer(cfg32.replace(train_steps_per_call=k4, adam_eps=spec["adam_eps"]),
                    "superpoint", make_loader(ds, b, cfg32.max_points, seed=seed, device=dev),
                    None, str(work / "ck_plain"), seed=seed, device=dev,
                    write_statistics=False)
    plain.train_epoch(0)
    plain_state = {n: v.detach().cpu() for n, v in plain.state.model.state_dict().items()}
    del plain
    _deterministic(False)
    t0 = time.perf_counter()
    nccl = _launch_ranks("nccl", 1, work)[0]
    graphed, eager = nccl[f"k{k4}"], nccl["k1"]
    steps = len(ds.index) // b
    check(graphed["steps"] == eager["steps"] == steps
          and (graphed["graphed"] or not on_card) and not eager["graphed"],
          f"the NCCL trainer took {steps} steps, k = {k4} as graph replays")

    def compare(a, b_):
        return (max(float((a[n].float() - v.float()).abs().max()) for n, v in b_.items()),
                all(torch.equal(a[n], v) for n, v in b_.items()),
                all(torch.allclose(a[n].float(), v.float(), rtol=2e-4, atol=2e-5)
                    for n, v in b_.items()))

    # one step from the same fresh parameters: the loss and the gradients are
    # one process's, and the parameters differ by what Adam's first update,
    # lr s g / (s |g| + eps) with s the clip's scale, makes of the gradients'
    # difference: up to 2 lr where s |g| is near eps or the sign of a ~0
    # gradient (a conv bias ahead of a BatchNorm) is rounding noise
    one, want = nccl["step"], ref[1]
    lr, eps, clip = cfg32.learning_rate, cfg32.adam_eps, cfg32.grad_clip_norm

    def first_update(grads):
        norm = float(torch.stack([g.double().norm() for g in grads.values()]).norm())
        sc = clip / norm if clip > 0 and norm >= clip else 1.0
        return norm, sc, {n: sc * g.double() / (sc * g.double().abs() + eps)
                          for n, g in grads.items()}

    norm_one, sc_one, u_one = first_update(one["grads"])
    norm_want, sc_want, u_want = first_update(want["grads"])
    worst = max(float(((g - want["grads"][n]).abs()
                       / (1e-3 + 1e-2 * want["grads"][n].abs())).max())
                for n, g in one["grads"].items())
    far = flips = entries = 0
    moved = near = resid = 0.0
    for n, g in one["grads"].items():
        a, w = one["state"][n].double(), want["state"][n].double()
        tol = 2e-5 + 2e-4 * w.abs()
        diff = a - w
        resid = max(resid, float(((diff + lr * (u_one[n] - u_want[n])).abs() / tol).max()))
        off = diff.abs() > tol
        entries += g.numel()
        if bool(off.any()):
            gw = want["grads"][n].double()
            far += int(off.sum())
            flips += int((g.double() * gw <= 0)[off].sum())
            moved = max(moved, float(diff.abs()[off].max()) / lr)
            near = max(near, float((sc_want * gw.abs())[off].max()) / eps)
    print(f"parallel {nccl['backend']} rank, one step from fresh parameters: loss "
          f"{one['metrics']['loss']:.6f} vs one process {want['metrics']['loss']:.6f}; "
          f"gradients' worst |diff| / (1e-3 + 1e-2 |g|) {worst:.3g}; gradient norms "
          f"{norm_one:.6g} / {norm_want:.6g} (clip scales {sc_one:.4g} / {sc_want:.4g}); "
          f"parameter entries beyond rtol 2e-4 + atol 2e-5: {far} of {entries}, {flips} "
          f"of them gradient sign flips, the largest s|g| there {near:.3g} eps, moved at "
          f"most {moved:.4g} lr; |diff - Adam's first update of the gradients' "
          f"difference| / (2e-5 + 2e-4 |p|) at most {resid:.3g}")
    check(abs(one["metrics"]["loss"] - want["metrics"]["loss"])
          <= 1e-5 * abs(want["metrics"]["loss"]),
          "NCCL one step: loss within rtol 1e-5 of one process")
    check(one["grads"].keys() == want["grads"].keys() and worst <= 1.0,
          "NCCL one step: gradients within atol 1e-3 + rtol 1e-2 of one process")
    check(resid <= 1.0, "NCCL one step: the parameters differ from one process's by "
                        "Adam's first update of the gradients' difference, within "
                        "rtol 2e-4 + atol 2e-5")

    ge = compare(graphed["state"], eager["state"])
    gp = compare(graphed["state"], plain_state)
    print(f"parallel {nccl['backend']} rank: two Trainer epochs (adam_eps "
          f"{spec['adam_eps']:g}) in {time.perf_counter() - t0:.1f} s; k = {k4} graphed "
          f"against k = 1 eager on the same rank: max|diff| {ge[0]:.3g}, bit-equal {ge[1]}; "
          f"against this process's non-distributed k = {k4} epoch: max|diff| {gp[0]:.3g}, "
          f"bit-equal {gp[1]}, within rtol 2e-4 + atol 2e-5 {gp[2]}; NCCL operations in "
          f"a traced call of {k4} replays {nccl.get('nccl_ops')}; wrapper launches "
          f"{nccl['launches']}")
    check(ge[2], "NCCL: graphed epoch within rtol 2e-4 + atol 2e-5 of the eager epoch")
    check(gp[2], f"NCCL: graphed epoch within rtol 2e-4 + atol 2e-5 of the non-distributed "
                 f"k = {k4} epoch")

    one = nccl["spatial_one"]
    print(f"parallel spatial {nccl['backend']} rank: a width mesh of one rank gives the "
          f"plain forward bit for bit {one['bit_equal']} ({one['forward_exchanges']} "
          f"exchanges) and extract bit for bit {one['extract_bit_equal']} (launches "
          f"{one['extract_launches']}); spatial.halo over {nccl['backend']} pads bit for bit "
          f"{one['halo_equal']} ({one['halo_exchanges']} exchanges)")
    check(one["bit_equal"] and one["forward_exchanges"] == 0,
          "spatial: a width mesh of one rank is the plain forward bit for bit")
    check(one["extract_bit_equal"], "extract_spatial on a width mesh of one rank is "
                                    "extract bit for bit")
    if on_card:
        check(one["extract_launches"]["decode_threshold"] == 1
              and one["extract_launches"]["grid_nms"] == 1,
              "extract_spatial on a width mesh of one: one decode and one NMS launch")
    check(one["halo_equal"] and one["halo_exchanges"] == 2,
          "spatial: the halo exchange over NCCL pads bit for bit")

    two_ms = [r.get("step_ms_bf16") for r in ranks]
    if on_card:
        print(f"parallel timing, TWO PROCESSES SHARING ONE CARD (not scaling): bf16 joint "
              f"step of {b // PAR_RANKS} a rank {two_ms} ms/step, one process at "
              f"{b} {one_ms:.3f} ms/step [{card}]")
    launches = {k: sum(r["launches"][k] for r in ranks) + nccl["launches"][k]
                for k in ranks[0]["launches"]}
    by_rank = {k: [r["launches"][k] for r in ranks] + [nccl["launches"][k]]
               for k in launches}
    spatial_launches = {k: sum(r["spatial"]["launches"][k] + r["spatial"]["extract_launches"][k]
                               + r["spatial_train"]["superpoint"]["launches"][k]
                               + r["spatial_train"]["magicpoint"]["launches"][k]
                               for r in ranks)
                        + one["launches"][k] + one["extract_launches"][k] for k in launches}
    shutil.rmtree(work)
    shutil.rmtree(sl_work)
    shutil.rmtree(packed.parent)
    return {"launches": launches, "by_rank": by_rank, "two_rank_ms": two_ms,
            "one_process_ms": one_ms, "gloo_s": gloo_s,
            "launches_spatial": spatial_launches, "spatial": sp}


NATIVE_FRAMES = 200      # frames of each host run in phase 14
NATIVE_BATCH = 8         # the u8 gray bundle's batch
NATIVE_TIMEOUT_S = 600   # the compile beside phase 1
# phase 14's bundles: (frontend, export_native's arguments).  "live": the
# released model with live BatchNorm, bf16 (export's default); "fold":
# BatchNorm folded (export --fold-bn), bf16.  The full ABI reuses the
# packed program's compiled kernels
NATIVE_BUNDLES = {
    "packed": ("live", dict()),
    "full": ("live", dict(abi="full")),
    f"u8gray_b{NATIVE_BATCH}": ("fold", dict(batch=NATIVE_BATCH, input_dtype="u8",
                                             input_channels=1)),
    "u8gray_b32": ("fold", dict(batch=32, input_dtype="u8", input_channels=1)),
}


def frame_agreement(got, want, what: str, hold: bool = True) -> dict:
    """Packed frame outputs ``got`` against ``want`` (each ``(num_valid,
    kp_packed, match_index, desc16)`` with a batch axis); with ``hold``,
    held to the frontend tests' tolerances: counts equal, >= 99% of keypoint
    rows at the same pixel, coordinates and scores there within 1e-5, f16
    descriptors within 1e-3, >= 99% of match slots equal."""
    got = [np.asarray(t.cpu()) for t in got]
    want = [np.asarray(t.cpu()) for t in want]
    same = (got[1][..., :2] == want[1][..., :2]).all(-1)
    stats = dict(
        num_valid_equal=bool((got[0] == want[0]).all()),
        rows_same=float(same.mean()),
        coord_err=float(np.abs(got[1][same] - want[1][same]).max(initial=0.0)),
        desc_err=float(np.abs(got[3][same].astype(np.float32)
                              - want[3][same].astype(np.float32)).max(initial=0.0)),
        match_same=float((got[2] == want[2]).mean()))
    print(f"native {what}: {stats}")
    if not hold:
        return stats
    check(stats["num_valid_equal"], f"{what}: keypoint counts equal")
    check(stats["rows_same"] >= 0.99, f"{what}: >= 99% of keypoints the same")
    check(stats["coord_err"] <= 1e-5, f"{what}: coordinates and scores within 1e-5")
    check(stats["desc_err"] <= 1e-3, f"{what}: descriptors within 1e-3")
    check(stats["match_same"] >= 0.99, f"{what}: >= 99% of matches the same")
    return stats


def _packed_view(outs, batch: int):
    """A bundle's outputs as ``(num_valid, kp_packed, match_index, desc)``
    with a batch axis: the full ABI's arrays packed as the packed ABI packs
    them, the unbatched packed ABI's given its axis."""
    if len(outs) == 7:
        y, x, score, valid, mi, mv, desc = (t[None] for t in outs)
        return (valid.sum(-1, dtype=torch.int32), torch.stack([y, x, score], -1),
                torch.where(mv, mi, -1), desc)
    return tuple(t[None] for t in outs[:4]) if batch == 1 else tuple(outs[:4])


def run_host(binary: Path, args: list, what: str, card: str) -> str:
    out = subprocess.run([str(binary), *map(str, args)], capture_output=True, text=True,
                         timeout=600)
    check(out.returncode == 0, f"host {what}: exit {out.returncode}\n{out.stderr[-3000:]}")
    for line in out.stdout.splitlines():
        if "steady-state" in line or "loaded" in line:
            print(f"host {what}: {line} [{card}]")
    return out.stdout


def native_frontend(which: str):
    """Phase 14's frontends of the released weights (`NATIVE_BUNDLES`)."""
    from feature_point_cnn_tpu_torch.config import SuperPointConfig
    from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
    from feature_point_cnn_tpu_torch.utils.weights import released_path

    cfg = {"live": SuperPointConfig(), "fold": SuperPointConfig(fold_bn=True),
           "f32": SuperPointConfig(compute_dtype="float32")}[which]
    return SuperPointFrontend(cfg, weights_path=released_path(), device="cuda")


def export_bundle(fe, name: str, work: Path) -> float:
    """`export_native` of phase 14's bundle ``name`` from the frontend
    ``fe`` into ``work / name``; returns its seconds."""
    import torch._inductor.config as inductor_config

    # AOTInductor links its C++ wrapper with -fopenmp: take the g++ on PATH
    # (nvcc's host compiler), which links OpenMP, over a CXX that may not
    inductor_config.cpp.cxx = (None, shutil.which("g++") or os.environ.get("CXX", "g++"))
    t = time.perf_counter()
    fe.export_native(str(work / name), (H, W), **NATIVE_BUNDLES[name][1])
    return time.perf_counter() - t


def native_compile_worker(name: str, work: Path) -> int:
    """``--native-compile NAME``: `export_bundle` in a process of its own,
    so that the first (cold) compile runs beside phase 1's build; its last
    line is its seconds."""
    secs = export_bundle(native_frontend(NATIVE_BUNDLES[name][0]), name, work)
    print(json.dumps({"export_compile_s": secs}))
    return 0


def start_native_compile(name: str, work: Path) -> subprocess.Popen:
    """`native_compile_worker` for the bundle ``name``, killed at exit if it
    still runs."""
    import atexit

    with open(work / f"compile_{name}.log", "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--native-compile", name,
             "--work", str(work)], stdout=f, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and (proc.kill(), proc.wait()))
    return proc


def finish_native_compile(proc: subprocess.Popen, name: str, work: Path) -> float:
    """Wait for a compile worker (``NATIVE_TIMEOUT_S``), fail if it failed,
    and return the bundle's export and compile seconds."""
    try:
        proc.wait(timeout=NATIVE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        check(False, f"the compile of {name} did not finish in {NATIVE_TIMEOUT_S} s")
    log = (work / f"compile_{name}.log").read_text()
    check(proc.returncode == 0, f"compile of {name} exited {proc.returncode}:\n{log[-3000:]}")
    return json.loads(next(line for line in reversed(log.splitlines())
                           if line.startswith('{"export_compile_s"')))["export_compile_s"]


SG_PAIRS, SG_KEYPOINTS = 32, 1024   # phase 15: the benchmark's SuperGlue batch
EXP_PER_S = 16 * 132 * 1.98e9       # H100 SXM: 16 exponentials a clock an SM, 132 SMs
SINKHORN_KERNELS = ("band_kernel", "column_kernel", "output_kernel")


def transport_close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Checks a Sinkhorn kernel's Z against the plain loop's: the same
    shape and -inf entries, no NaN, finite entries within 1e-5 of the
    largest finite magnitude (float32 summation order over 100
    iterations); returns the largest gap over that magnitude."""
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}")
    check(not bool(got.isnan().any()), f"{what}: no NaN")
    check(torch.equal(got == float("-inf"), want == float("-inf")),
          f"{what}: the same -inf entries")
    finite = want.isfinite()
    check(torch.equal(got.isfinite(), finite), f"{what}: the same finite entries")
    if not finite.any():
        return 0.0
    rel = float((got[finite] - want[finite]).abs().max() / want[finite].abs().max())
    check(rel <= 1e-5, f"{what}: max|dZ| {rel:.3g} of max|Z| <= 1e-5")
    return rel


def sinkhorn_phase(seed: int, card: str) -> dict:
    """Phase 15: SuperGlue's Sinkhorn kernel at the benchmark's shape, on
    the scores of a SuperGlue at the published widths (seeded weights, 32
    pairs of 1024 random keypoints): one wrapper call a SuperGlue call,
    the kernel against the plain loop on full and ragged pairs, its device
    time beside its two bounds and the plain loop's time.  Returns the
    ``kernels`` line's row."""
    import torch.nn.functional as F

    from feature_point_cnn_tpu_torch.config import SuperGlueConfig
    from feature_point_cnn_tpu_torch.models import superglue
    from feature_point_cnn_tpu_torch.ops.kernels import sinkhorn

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    sg = superglue.SuperGlue(SuperGlueConfig(), generator=g).to(dev).eval()
    b, n = SG_PAIRS, SG_KEYPOINTS

    def side():
        kp = torch.stack([torch.rand(b, n, generator=g) * (H - 1),
                          torch.rand(b, n, generator=g) * (W - 1),
                          torch.rand(b, n, generator=g)], -1)
        desc = F.normalize(torch.randn(b, n, 256, generator=g), dim=-1)
        return kp.to(dev), desc.half().to(dev)

    (kp0, d0), (kp1, d1) = side(), side()
    num = torch.full((b,), n, dtype=torch.int32, device=dev)
    seen, real = [], superglue.log_optimal_transport

    def capture(*args):
        seen.append(args)
        return real(*args)

    superglue.log_optimal_transport = capture
    try:
        with torch.inference_mode():
            before = profiling.counters()
            for _ in range(2):
                sg(kp0, d0, num, kp1, d1, num, (H, W))
            torch.cuda.synchronize()
            gained = profiling.counted_since(before)
    finally:
        superglue.log_optimal_transport = real
    check(gained.get("kernel.sinkhorn") == 2, f"one Sinkhorn kernel call a SuperGlue call: {gained}")
    scores, alpha, valid0, valid1, iters = seen[0]
    m = scores.shape[2]
    # ragged pairs on the same scores: 0, 1, ragged and full counts
    counts = torch.tensor([n] * 16 + [1000, 731, 1, 0] * 4, device=dev)
    ragged = (torch.arange(n, device=dev) < counts[:, None],
              torch.arange(m, device=dev) < counts.flip(0)[:, None])
    with torch.inference_mode():
        errs = {}
        for what, (v0, v1) in (("full", (valid0, valid1)), ("ragged", ragged)):
            got = sinkhorn.log_optimal_transport(scores, alpha, v0, v1, iters)
            want = sinkhorn.log_optimal_transport_plain(scores, alpha, v0, v1, iters)
            errs[what] = transport_close(got, want, f"sinkhorn {what} {tuple(scores.shape)}")
        del got, want

        def kernel():
            sinkhorn.log_optimal_transport(scores, alpha, valid0, valid1, iters)

        def plain():
            sinkhorn.log_optimal_transport_plain(scores, alpha, valid0, valid1, iters)

        ms = event_ms(kernel, 10, warmup=2)
        plain_ms = event_ms(plain, 3, warmup=1)
        ops = trace_device(kernel, calls=2, named=SINKHORN_KERNELS)
    mine = {k: (n_, ms_) for k, (n_, ms_) in ops.items()
            if any(s in k for s in SINKHORN_KERNELS)}
    launches = {s: int(sum(n_ for k, (n_, _) in mine.items() if s in k))
                for s in SINKHORN_KERNELS}
    check(launches == {"band_kernel": iters, "column_kernel": iters, "output_kernel": 1},
          f"sinkhorn: 2 * iters + 1 kernel launches a call, got {launches}")
    device_ms = sum(n_ * ms_ for n_, ms_ in mine.values())
    entries = b * (n + 1) * (m + 1)
    bytes_ms = 1e3 * iters * 4 * entries / HBM_BYTES_PER_S
    exp_ms = 1e3 * 2 * iters * entries / EXP_PER_S
    check(device_ms >= max(bytes_ms, exp_ms), "sinkhorn: device time not under its bound")
    row = dict(
        name="sinkhorn", route="cuda", source="feature_point_cnn_tpu_torch/csrc/sinkhorn.cu",
        replaces=None, launches=gained["kernel.sinkhorn"] // 2, shape=[b, n, m],
        iterations=iters, cuda_launches_per_call=launches,
        device_ms=device_ms, ms=ms, plain_ms=plain_ms, bound_ms=bytes_ms,
        bound_by="bytes: the couplings read once an iteration", bound_exp_ms=exp_ms,
        bound_share=bytes_ms / device_ms, max_rel_err=errs,
        by_kernel_ms={k: n_ * ms_ for k, (n_, ms_) in mine.items()},
        other_ops_per_call=sum(n_ for k, (n_, _) in ops.items() if k not in mine))
    print(f"kernel sinkhorn {row['shape']} x {iters}: device {device_ms:.3f} ms, events "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms ({plain_ms / ms:.1f}x); bounds "
          f"{bytes_ms:.3f} ms bytes ({row['bound_share']:.1%}), {exp_ms:.3f} ms exps; "
          f"max|dZ|/max|Z| {errs} [{card}]")
    return row


# the VGG's twelve convolutions at 480x640 and what follows each: (C, H, W,
# relu, pool, float32 out)
VGG_EPILOGUES = {
    "encoder_conv0_a": (64, 480, 640, True, False, False),
    "encoder_conv0_b": (64, 480, 640, True, True, False),
    "encoder_conv1_a": (64, 240, 320, True, False, False),
    "encoder_conv1_b": (64, 240, 320, True, True, False),
    "encoder_conv2_a": (128, 120, 160, True, False, False),
    "encoder_conv2_b": (128, 120, 160, True, True, False),
    "encoder_conv3_a": (128, 60, 80, True, False, False),
    "encoder_conv3_b": (128, 60, 80, True, False, False),
    "detector_conv_a": (256, 60, 80, True, False, False),
    "detector_conv_b": (65, 60, 80, False, False, True),
    "descriptor_conv_a": (256, 60, 80, True, False, False),
    "descriptor_conv_b": (256, 60, 80, False, False, True),
}
EPILOGUE_KERNELS = ("flat_kernel", "pool_kernel")
# the passes the epilogue replaces, as a trace names their kernels
EPILOGUE_REPLACES = ("elementwise_kernel", "max_pool_forward")


def epilogue_bytes(b: int, c: int, h: int, w: int, pool: bool, f32: bool) -> int:
    """Bytes one epilogue call must move: the bf16 input read once, the
    output written once."""
    out = b * c * (h // 2) * (w // 2) if pool else b * c * h * w
    return 2 * b * c * h * w + (4 if f32 else 2) * out


def conv_epilogue_phase(seed: int, card: str) -> dict:
    """Phase 16: the VGG's convolution epilogue at B = 32, 480x640: each
    layer's call against its plain passes and its bound, then the bf16
    forward through the kernel and through the plain passes, traced.
    Returns the ``kernels`` line's row."""
    from feature_point_cnn_tpu_torch.models.vgg_superpoint import VGG_CONFIG, VGGSuperPoint
    from feature_point_cnn_tpu_torch.ops.kernels import conv_epilogue as ep

    dev, b = torch.device("cuda"), 32
    g = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    layers = {}
    with torch.inference_mode():
        for name, (c, h, w, relu, pool, f32) in VGG_EPILOGUES.items():
            y = (torch.randn((b, h, w, c), generator=g, device=dev) * 2).to(
                torch.bfloat16).permute(0, 3, 1, 2)
            bias = torch.randn((c,), generator=g, device=dev) * 0.05

            def kernel():
                return ep.conv_epilogue(y, bias, relu, pool, f32)

            def plain():
                return ep.conv_epilogue_plain(y, bias, relu, pool, f32)

            got, want = kernel(), plain()
            view = torch.int32 if f32 else torch.int16
            check(torch.equal(got.contiguous().view(view), want.contiguous().view(view)),
                  f"conv_epilogue {name}: the kernel's bits are the plain passes'")
            del got, want
            device_ms = one_launch(kernel, "pool_kernel" if pool else "flat_kernel",
                                   f"conv_epilogue {name}")
            bound_ms = 1e3 * epilogue_bytes(b, c, h, w, pool, f32) / HBM_BYTES_PER_S
            layers[name] = dict(device_ms=device_ms, cold_ms=cold_ms(kernel, flush),
                                plain_ms=event_ms(plain, 5, warmup=1), bound_ms=bound_ms)
            del y, bias
    del flush
    for name, r in layers.items():
        print(f"  epilogue {name}: device {r['device_ms']:.4f} ms, cold {r['cold_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f} ({r['bound_ms'] / r['cold_ms']:.1%} of cold), "
              f"plain {r['plain_ms']:.4f}")
    sums = {k: sum(r[k] for r in layers.values())
            for k in ("device_ms", "cold_ms", "plain_ms", "bound_ms")}

    # the forward at B = 32 through the kernel and through the plain passes
    image = torch.rand((b, H, W, 1), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(seed + 1))
    forwards = {}
    for layout in ("contiguous", "channels_last"):
        model = VGGSuperPoint(VGG_CONFIG, generator=torch.Generator().manual_seed(seed))
        model = (model.to(dev, memory_format=torch.channels_last) if layout == "channels_last"
                 else model.to(dev)).eval()

        def fused():
            with torch.inference_mode():
                model(image)

        def passes():
            with torch.enable_grad():
                model(image)

        before = profiling.counters()
        fused()
        torch.cuda.synchronize()
        counted = profiling.counted_since(before)
        check(counted == {"kernel.conv_epilogue": 12},
              f"VGG forward ({layout}): 12 epilogue calls, got {counted}")
        for route, fn in (("kernel", fused), ("passes", passes)):
            ops = trace_device(fn, calls=3, named=EPILOGUE_KERNELS if route == "kernel" else ())
            by = sorted(((n * ms, n, k) for k, (n, ms) in ops.items()), reverse=True)
            mine = {k: n for k, (n, _) in ops.items() if any(s in k for s in EPILOGUE_KERNELS)}
            passed = {k: n for k, (n, _) in ops.items() if any(s in k for s in EPILOGUE_REPLACES)}
            forwards[f"{layout}.{route}"] = dict(
                device_ms=sum(t for t, _, _ in by),
                epilogue_ms=sum(n * ops[k][1] for k, n in mine.items()),
                epilogue_launches=sum(mine.values()),
                replaced_ms=sum(n * ops[k][1] for k, n in passed.items()),
                nchw_to_nhwc_ms=sum(t for t, _, k in by if "nchwToNhwc" in k),
                top=[(k[:90], n, t) for t, n, k in by[:8]])
            if route == "kernel":
                check(sum(mine.values()) == 12 and not any(
                          "max_pool_forward" in k for k in passed),
                      f"VGG forward ({layout}) through the kernel: 12 launches and no "
                      f"max-pool ({mine}, {passed})")
        del model
    for k, f in forwards.items():
        print(f"VGG bf16 forward B = {b} {k}: device {f['device_ms']:.3f} ms "
              f"({f['device_ms'] / b:.4f} ms/frame), epilogue {f['epilogue_ms']:.3f} ms in "
              f"{f['epilogue_launches']} launches, replaced passes {f['replaced_ms']:.3f} ms, "
              f"nchwToNhwc {f['nchw_to_nhwc_ms']:.3f} ms [{card}]")
        for name, n, t in f["top"]:
            print(f"    {t:9.4f} ms x{n:<4g} {name}")
    row = dict(
        name="conv_epilogue", route="cuda",
        source="feature_point_cnn_tpu_torch/csrc/conv_epilogue.cu", replaces=None,
        launches=12, shape=[b, H, W], layers=layers, **{f"sum_{k}": v for k, v in sums.items()},
        bound_share_cold=sums["bound_ms"] / sums["cold_ms"],
        bound_share_forward=sums["bound_ms"] / forwards["contiguous.kernel"]["epilogue_ms"],
        forwards=forwards)
    print(f"kernel conv_epilogue, 12 layers at B = {b}: device {sums['device_ms']:.3f} ms "
          f"(warm), cold {sums['cold_ms']:.3f} ms, in the forward "
          f"{forwards['contiguous.kernel']['epilogue_ms']:.3f} ms; bound "
          f"{sums['bound_ms']:.3f} ms ({row['bound_share_cold']:.1%} of cold, "
          f"{row['bound_share_forward']:.1%} in the forward); plain passes "
          f"{sums['plain_ms']:.3f} ms [{card}]")
    return row


def native_phase(seed: int, card: str, fe, work: Path, packed_s: float) -> dict:
    """Phase 14: the frame program exported as AOTInductor packages on the
    card and held to the eager `frame`, and the native host built and run.
    ``fe``: the released weights' frontend (live BatchNorm, bf16); ``work``
    holds the "packed" bundle, compiled in ``packed_s`` seconds beside
    phase 1; the other bundles compile here in turn, beside the host's
    build."""
    from concurrent.futures import ThreadPoolExecutor

    from torch._inductor import aoti_load_package

    from feature_point_cnn_tpu_torch.inference import native
    from feature_point_cnn_tpu_torch.inference.wrapper import (
        KERNEL_OPS,
        FullExport,
        graph_ops,
    )

    t_phase = time.perf_counter()
    pool = ThreadPoolExecutor(1)

    def timed_build():
        t = time.perf_counter()
        return native.build("cuda"), time.perf_counter() - t

    host_build = pool.submit(timed_build)
    cfg = fe.config
    frontends = {"live": fe, "fold": native_frontend("fold")}
    secs = {"export_compile_packed": packed_s}
    t = time.perf_counter()
    ep, _ = fe.native_program((H, W))
    secs["export_packed"] = time.perf_counter() - t
    ops = graph_ops(ep)
    print(f"native: the packed program's graph calls {sorted(o for o in ops if 'fpc' in o)} "
          f"among {len(ops)} operators; exported in {secs['export_packed']:.2f} s")
    check(KERNEL_OPS <= ops, "the exported frame program calls both fpc ops")
    sizes, packages, metas = {}, {}, {}

    def load(name):
        t = time.perf_counter()
        packages[name] = aoti_load_package(str(work / name / "model.pt2"))
        secs[f"load_{name}"] = time.perf_counter() - t
        sizes[name] = (work / name / "model.pt2").stat().st_size
        metas[name] = json.loads((work / name / "meta.json").read_text())
        print(f"native: {name} ({NATIVE_BUNDLES[name][0]}) exported and compiled in "
              f"{secs[f'export_compile_{name}']:.2f} s, loaded in {secs[f'load_{name}']:.2f} s, "
              f"model.pt2 {sizes[name]} bytes [{card}]")

    load("packed")
    # the main path: the packed package on phase 4's keyframe and frames,
    # f32 RGB a frame a call, against the eager frame on the same inputs
    # (the package's keyframe outputs fed to both)
    key_frame, frames = serving_frames(seed)
    rgb = lambda u8: torch.from_numpy(u8).cuda().float().div(255.0).expand(
        *u8.shape[:-1], 3).contiguous()
    pk, n = packages["packed"], metas["packed"]["top_n"]
    zero = (torch.zeros((n, cfg.descriptor_dim), dtype=torch.float16, device="cuda"),
            torch.zeros((), dtype=torch.int32, device="cuda"))
    zero_kernel_counts()
    key_out = pk(rgb(key_frame[None]), *zero)
    outs = [pk(rgb(frames[i:i + 1]), key_out[3], key_out[0]) for i in range(len(frames))]
    torch.cuda.synchronize()
    launches = kernel_counts()
    print(f"native main path launches: {launches}")
    check(launches["decode_threshold"] == launches["grid_nms"] == len(frames) + 1,
          "the package launched decode and NMS once a call")
    key = (key_out[3], key_out[0])

    def eager_frames(f, imgs):
        with torch.inference_mode():
            return [torch.cat(t) for t in zip(*(f.frame(rgb(imgs[i:i + 1]), *key)
                                                 for i in range(len(imgs))))]

    got = [torch.cat(t) for t in zip(*(_packed_view(o, 1) for o in outs))]
    with torch.inference_mode():
        want_key = fe.frame(rgb(key_frame[None]), *zero)
    want = eager_frames(fe, frames)
    stats = {"keyframe": frame_agreement(_packed_view(key_out, 1), want_key,
                                         "packed keyframe vs eager"),
             "packed": frame_agreement(got, want, "packed vs eager frame")}
    n_match = int((got[2][0] >= 0).sum())
    print(f"native: the shifted frame has {n_match} matches to its keyframe")
    check(n_match >= 30, f"{n_match} >= 30 matches on the shifted pair")
    check(bool(torch.isfinite(got[1]).all()), "finite keypoints")
    traced = traced_launches(lambda: pk(rgb(frames[:1]), *key),
                             ("decode_row_kernel", "grid_nms_kernel"))
    print(f"native: a traced package call launches {traced}")
    check(traced == {"decode_row_kernel": 1, "grid_nms_kernel": 1},
          "one decode and one NMS launch a package call")

    # the other bundles, compiled in turn
    for name in NATIVE_BUNDLES:
        if name != "packed":
            secs[f"export_compile_{name}"] = export_bundle(
                frontends[NATIVE_BUNDLES[name][0]], name, work)
            load(name)

    # u8 gray B = 8 against the folded eager frame on the same frames as f32 RGB
    fold = frontends["fold"]
    with torch.inference_mode():
        u8 = packages[f"u8gray_b{NATIVE_BATCH}"](torch.from_numpy(frames).cuda(), *key)
        stats["u8gray"] = frame_agreement(_packed_view(u8, NATIVE_BATCH),
                                          fold.frame(rgb(frames), *key),
                                          f"u8 gray B = {NATIVE_BATCH} vs eager f32 RGB")
    # the full ABI against its program run eagerly, on the keyframe and the
    # shifted frame
    k = cfg.max_keypoints
    full_eager = FullExport(fe.model, cfg)
    fk = (torch.zeros((k, cfg.descriptor_dim), device="cuda"),
          torch.zeros(k, dtype=torch.bool, device="cuda"))
    with torch.inference_mode():
        full_key = packages["full"](rgb(key_frame[None]), *fk)
        stats["full"] = frame_agreement(
            _packed_view(packages["full"](rgb(frames[:1]), full_key[6], full_key[3]), 1),
            _packed_view(full_eager(rgb(frames[:1]), full_key[6], full_key[3]), 1),
            "full ABI vs the program run eagerly")
    # the float32 witness: the eager bf16 frame's and the package's distances
    # from the float32 frame (TF32 off) on the same frames and keyframe
    torch.backends.cudnn.allow_tf32 = False
    want32 = eager_frames(native_frontend("f32"), frames)
    torch.backends.cudnn.allow_tf32 = True
    stats["eager_vs_f32"] = frame_agreement(want, want32, "eager bf16 vs float32 frame",
                                            hold=False)
    stats["package_vs_f32"] = frame_agreement(got, want32, "packed vs float32 frame",
                                              hold=False)

    # ms/frame in turns: the package, the live and the folded eager frame, at
    # B = 1 (f32 RGB, live package) and B = 32 (u8 gray, folded package)
    scenes = np.stack([shifted_pair(seed + 200 + i, H, W, 0)[0] for i in range(8)])
    timing = {}
    for b, name in ((1, "packed"), (32, "u8gray_b32")):
        imgs = torch.from_numpy(np.resize(scenes, (b, H, W, 1))).cuda()
        if b == 1:
            imgs = rgb(np.resize(scenes, (1, H, W, 1)))
        calls = {"package": lambda: packages[name](imgs, *key),
                 "eager_live": lambda: fe.frame(imgs, *key),
                 "eager_fold": lambda: fold.frame(imgs, *key)}
        ab = {side: [] for side in calls}
        for side in list(calls) + list(calls)[::-1]:
            ab[side].append(host_median_ms(calls[side]) / b)
        timing[f"b{b}"] = ab
        print(f"native b{b} ms/frame ({name}): "
              + ", ".join(f"{k_} {v}" for k_, v in ab.items()) + f" [{card}]")

    # the host: synthetic frames and a replay of a panned scene, against
    # Python's run of the same package on the replay
    host, secs["host_build"] = host_build.result()
    pool.shutdown()
    print(f"native host built in {secs['host_build']:.2f} s")
    check(subprocess.run([str(host["camera_selftest"])], capture_output=True,
                         timeout=60).returncode == 0, "camera selftest")
    wide = polygon_scene(np.random.default_rng(seed + 14), H, W + NATIVE_FRAMES)
    pan = np.stack([wide[:, i:i + W] for i in range(NATIVE_FRAMES)])[..., None]
    host_runs = {}
    for name in ("packed", f"u8gray_b{NATIVE_BATCH}"):
        meta = metas[name]
        execs = NATIVE_FRAMES // meta["batch"]
        raw = work / f"{name}.raw"
        replay = np.ascontiguousarray(np.broadcast_to(pan, pan.shape[:-1] + (meta["channels"],)),
                                      dtype=np.float32)
        replay.tofile(raw)
        synthetic = run_host(host["superpoint_serve"], ["--model", work / name, "--frames",
                                                        execs, "--pipeline", "1,2,4"],
                             f"{name} synthetic", card)
        replayed = run_host(host["superpoint_serve"], ["--model", work / name, "--frames",
                                                       execs, "--source", raw],
                            f"{name} replay", card)
        raw.unlink()
        want_lines = replay_exec_lines(packages[name], meta, replay, "cuda")
        got_lines = host_exec_lines(replayed)
        print(f"host {name} replay exec lines {got_lines}, Python's {want_lines}")
        check(got_lines == want_lines, f"host {name}: the replay's exec lines equal Python's")
        host_runs[name] = dict(synthetic=[l for l in synthetic.splitlines() if "steady" in l],
                               replay=[l for l in replayed.splitlines() if "steady" in l])
    shutil.rmtree(work)
    secs["phase"] = time.perf_counter() - t_phase
    return dict(launches=launches, secs=secs, sizes=sizes, agreement=stats, timing=timing,
                host=host_runs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # phase 13 starts its ranks as processes of this script
    ap.add_argument("--parallel-worker", choices=("gloo", "nccl"), help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--work", type=Path, help=argparse.SUPPRESS)
    # phase 14 compiles its bundles in processes of this script
    ap.add_argument("--native-compile", choices=tuple(NATIVE_BUNDLES), help=argparse.SUPPRESS)
    # phase 15 runs in a process of this script
    ap.add_argument("--sinkhorn-worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.native_compile:
        return native_compile_worker(args.native_compile, args.work)
    if args.sinkhorn_worker:
        print(json.dumps(sinkhorn_phase(args.seed, card_line())))
        return 0
    if args.parallel_worker:
        return parallel_worker(args.parallel_worker, args.rank, args.world, args.port,
                               args.work)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
    from feature_point_cnn_tpu_torch.data.datasets import BatchLoader
    from feature_point_cnn_tpu_torch.geometry.homography import (
        homographic_augmentation_batch,
        warp_points,
    )
    from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
    from feature_point_cnn_tpu_torch.ops import kernels
    from feature_point_cnn_tpu_torch.ops.detection import decode_prob_map
    from feature_point_cnn_tpu_torch.ops.kernels.decode import (
        cell_row_layout,
        decode_threshold_cuda,
        decode_threshold_plain,
    )
    from feature_point_cnn_tpu_torch.ops.kernels.descriptor_loss import (
        hinge_descriptor_loss_cuda,
        hinge_descriptor_loss_plain,
    )
    from feature_point_cnn_tpu_torch.ops.kernels.nms import (
        grid_nms_cuda,
        grid_nms_plain,
        max_active_clusters,
        nms_layout,
        plain_rounds,
    )
    from feature_point_cnn_tpu_torch.train import loss as L
    from feature_point_cnn_tpu_torch.train import steps as S
    from feature_point_cnn_tpu_torch.train.optimizer import make_optimizer
    from feature_point_cnn_tpu_torch.train.trainer import Trainer
    from feature_point_cnn_tpu_torch.utils.weights import released_path

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    survey = import_survey()
    print("import survey: " + json.dumps(survey))

    # ---- 1. build -------------------------------------------------------
    # phase 14's first AOTInductor compile (the slow one: Triton, the C++
    # runtime) runs in a process of its own beside the build; phase 2 waits
    # for it, so that nothing else shares the card with a check
    kernels.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    native_work = Path(tempfile.mkdtemp(prefix="chip_smoke_native_",
                                        dir=str(kernels.BUILD_DIR.parent)))
    cold_compile = start_native_compile("packed", native_work)
    t0 = time.perf_counter()
    logs = kernels.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs) or 'cached'}")
    for name, log in logs.items():
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Used" in line:
                spills = lines[i - 1].strip() if i and "spill" in lines[i - 1] else ""
                print(f"  {name}: {line.strip()}; {spills}")

    cfg = SuperPointConfig()
    weights = released_path()
    fe = SuperPointFrontend(cfg, weights_path=weights, device="cuda")
    print(f"weights: {weights} compute {cfg.compute_dtype}")
    t = cfg.confidence_thresh

    key_frame, frames = serving_frames(args.seed)
    batch_u8 = torch.from_numpy(frames).cuda()
    batch = (batch_u8.float() / 255.0).expand(-1, -1, -1, 3).contiguous()

    print(f"[phase 1 done at {time.perf_counter() - t_start:.1f} s]")
    # ---- 2. decode ------------------------------------------------------
    t0 = time.perf_counter()
    native_compile_s = finish_native_compile(cold_compile, "packed", native_work)
    print(f"native: waited {time.perf_counter() - t0:.2f} s for phase 14's first compile "
          f"({native_compile_s:.2f} s, beside the build)")
    rng2 = np.random.default_rng(args.seed + 2)
    with torch.inference_mode():
        logits, _ = fe.model.features(batch)
        logits32, _ = fe.model.features(batch.repeat(4, 1, 1, 1))
    ragged = torch.from_numpy((rng2.standard_normal((1, 9, 11, 65)) * 4)
                              .astype(np.float32)).cuda()
    dec_err, decoded = 0.0, {}
    for name, lg in (("b8", logits), ("b32", logits32), ("ragged", ragged)):
        dec_k, err, n_flip = decode_against_plain(lg, cfg.cell, t, f"decode {name}")
        dec_err = max(dec_err, err)
        decoded[name] = dec_k
        print(f"decode: {name} logits {tuple(lg.shape)} max|diff| {err:.3g} "
              f"mask flips {n_flip} kept {int((dec_k > 0).sum())}")
    for name, lg in (("b8", logits), ("ragged", ragged)):
        one_launch(lambda: decode_threshold_cuda(lg, cfg.cell, t), "decode_row_kernel",
                   f"decode {name}")
    print("decode: one CUDA launch a call (traced at B = 8 and on the ragged logits)")
    dec_k, dec32 = decoded["b8"], decoded["b32"]

    print(f"[phase 2 done at {time.perf_counter() - t_start:.1f} s]")
    # ---- 3. NMS ---------------------------------------------------------
    nms_rounds = {}
    for name, scores in nms_inputs(dec_k, args.seed).items():
        got = grid_nms_cuda(scores, cfg.nms_dist)
        rounds = grid_nms_cuda.last_rounds
        want = grid_nms_plain(scores, cfg.nms_dist)
        want_rounds = plain_rounds(scores, cfg.nms_dist)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"NMS exact on {name}")
        nms_rounds[name] = rounds.tolist()
        check(nms_rounds[name] == want_rounds,
              f"NMS rounds on {name}: device {nms_rounds[name]} vs plain {want_rounds}")
        print(f"nms: {name} {tuple(scores.shape)} exact, rounds a frame (device = plain) "
              f"{nms_rounds[name] if len(want_rounds) <= 8 else f'{min(want_rounds)}-{max(want_rounds)}'}, "
              f"kept {int((got > 0).sum())}")
        if name in ("decode_output", "monotone_ramp"):
            one_launch(lambda: grid_nms_cuda(scores, cfg.nms_dist), "grid_nms_kernel",
                       f"NMS {name}")
            print(f"nms: {name} is one CUDA launch a call (traced), "
                  f"{max(nms_rounds[name])} rounds on the device")

    print(f"[phase 3 done at {time.perf_counter() - t_start:.1f} s]")
    # ---- 4. end to end: the main path ----------------------------------
    n = min(256, cfg.max_keypoints)
    zero_kernel_counts()
    key_in = torch.from_numpy(key_frame[None]).cuda()
    zero_key = torch.zeros((n, cfg.descriptor_dim), dtype=torch.float16, device="cuda")
    k_num, k_packed, _, k_desc = fe.frame(key_in, zero_key, 0)
    num, packed, match_index, _ = fe.frame(batch_u8, k_desc[0], k_num[0])
    torch.cuda.synchronize()
    launches = kernel_counts(("decode_threshold", "grid_nms"))
    main_rounds = grid_nms_cuda.last_rounds.tolist()
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

    print(f"[phase 4 done at {time.perf_counter() - t_start:.1f} s]")
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

    # device busy share and time by kernel, from a traced window of 5 frame
    # calls (tracing adds host time, so the busy share is a lower bound)
    for b in (1, 32):
        imgs_u8 = torch.from_numpy(np.resize(scenes, (b, H, W, 1))).cuda()
        prof_window(lambda: fe.frame(imgs_u8, k_desc[0], k_num[0]), 5, b,
                    f"b{b} frame", "frame", card)

    # the fold_bn A/B: BatchNorm folded into the convolutions at load
    # against live BatchNorm.  Float32 with TF32 off first: prob maps within
    # 1e-5, the same keypoints, and no BatchNorm kernel in the folded trace
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = cfg.replace(compute_dtype="float32")
    fes = {fold: SuperPointFrontend(cfg32.replace(fold_bn=fold), weights_path=weights,
                                    device="cuda") for fold in (False, True)}
    with torch.inference_mode():
        probs = {fold: f.model(batch)[0] for fold, f in fes.items()}
        kps = {fold: f.extract(batch)[0] for fold, f in fes.items()}
    fold_err = float((probs[True] - probs[False]).abs().max())
    same_kp = all(torch.equal(getattr(kps[True], f_), getattr(kps[False], f_))
                  for f_ in ("y", "x", "valid"))
    print(f"fold_bn float32: prob max|folded - live| {fold_err:.3g}, keypoints equal "
          f"{same_kp} ({int(kps[True].valid.sum())} keypoints)")
    check(fold_err <= 1e-5, "folded prob maps within 1e-5 of live BatchNorm")
    check(same_kp, "folded keypoints equal live BatchNorm's")
    bn_kernels, traced = {}, {}
    for fold, f in fes.items():
        with torch.inference_mode():
            traced[fold] = trace_device(lambda: f.model.features(batch))
        bn_kernels[fold] = {k: n for k, (n, _) in traced[fold].items()
                            if "bn_" in k.lower() or "batch_norm" in k.lower()}
    print(f"fold_bn trace: BatchNorm kernels live {sum(bn_kernels[False].values()):.0f} "
          f"launches {sorted(bn_kernels[False])[:3]}, folded "
          f"{sum(bn_kernels[True].values()):.0f}")
    check(bool(bn_kernels[False]) and not bn_kernels[True],
          f"BatchNorm kernels in the live trace and none in the folded one "
          f"(live {sorted(traced[False])}, folded {sorted(traced[True])})")
    del fes, probs, kps
    torch.backends.cudnn.allow_tf32 = True
    # then the serving default (bf16): frame ms/frame, on and off in turns
    fe_fold = SuperPointFrontend(cfg.replace(fold_bn=True), weights_path=weights,
                                 device="cuda")
    fold_ms = {}
    for b in (1, 32):
        imgs_u8 = torch.from_numpy(np.resize(scenes, (b, H, W, 1))).cuda()
        ab = {"on": [], "off": []}
        for gate in ("on", "off", "off", "on"):
            f = fe_fold if gate == "on" else fe
            ab[gate].append(host_median_ms(
                lambda: f.frame(imgs_u8, k_desc[0], k_num[0])) / b)
        fold_ms[b] = ab
        print(f"fold_bn b{b}: frame fold on {ab['on']} off {ab['off']} ms/frame [{card}]")
    imgs_u8 = torch.from_numpy(np.resize(scenes, (32, H, W, 1))).cuda()
    prof_window(lambda: fe_fold.frame(imgs_u8, k_desc[0], k_num[0]), 5, 32,
                "b32 frame fold_bn", "frame", card)
    del fe_fold


    # rows 1-2 at the main path's B = 8 and at B = 32: the device's own time
    # (trace, back to back), events back to back ("ms", warm: the input is
    # in L2 as the main path finds it) and around single launches after a
    # 256 MB write ("cold_ms": the input comes from device memory).  The
    # bound check and the share of the bound use cold_ms.
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    nms_lay = nms_layout(H, W, cfg.nms_dist)

    def measure(kind, x, rounds):
        b_ = x.shape[0]
        if kind == "decode":
            fn = lambda: decode_threshold_cuda(x, cfg.cell, t)
            plain = lambda: decode_threshold_plain(x, cfg.cell, t)
            nbytes = x.numel() * 4 + b_ * H * W * 4
            ops = x.numel() // 65 * 65 * 5     # sub, exp, add, div, compare a logit
        else:
            fn = lambda: grid_nms_cuda(x, cfg.nms_dist)
            plain = lambda: grid_nms_plain(x, cfg.nms_dist)
            nbytes = 2 * x.numel() * 4
            # the rounds this input needs, each two separable window maxima
            ops = sum(rounds) * H * W * (2 * 2 * 2 * cfg.nms_dist + 4)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
        m = dict(shape=list(x.shape),
                 device_ms=one_launch(fn, "decode_row_kernel" if kind == "decode"
                                      else "grid_nms_kernel", f"{kind} B = {b_}", calls=10),
                 ms=event_ms(fn, 100 if kind == "decode" else 20),
                 cold_ms=cold_ms(fn, flush),
                 plain_ms=event_ms(plain, 20 if kind == "decode" else 5),
                 bound_ms=1e3 * max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
        m["bound_share"] = m["bound_ms"] / m["cold_ms"]
        return m

    dec8, dec32m = measure("decode", logits, None), measure("decode", logits32, None)
    nms8 = measure("nms", dec_k, nms_rounds["decode_output"])
    rounds32 = plain_rounds(dec32, cfg.nms_dist)
    nms32 = measure("nms", dec32, rounds32)
    seg = cell_row_layout(logits.shape[2])
    rows = [
        dict(name="decode_threshold", route="cuda",
             source="feature_point_cnn_tpu_torch/csrc/decode_threshold.cu",
             replaces="feature_point_cnn_tpu/ops/pallas/decode.py:41",
             launches=launches["decode_threshold"], max_abs_err=dec_err,
             **{k: dec8[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None, shape=dec8["shape"], device_ms=dec8["device_ms"],
             cold_ms=dec8["cold_ms"], bound_share=dec8["bound_share"],
             bound_check="cold_ms", cuda_launches_per_call=1,
             segment_cells=seg["seg"], smem_bytes_per_block=seg["smem_bytes"],
             bulk_copy=seg["bulk"], b32=dec32m),
        dict(name="grid_nms", route="cuda",
             source="feature_point_cnn_tpu_torch/csrc/grid_nms.cu",
             replaces="feature_point_cnn_tpu/ops/pallas/nms.py:112",
             launches=launches["grid_nms"], max_abs_err=0.0,
             **{k: nms8[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None, shape=nms8["shape"], device_ms=nms8["device_ms"],
             cold_ms=nms8["cold_ms"], bound_share=nms8["bound_share"],
             bound_check="cold_ms", cuda_launches_per_call=1,
             rounds=nms_rounds["decode_output"],
             cluster_ctas=nms_lay.cluster, smem_bytes_per_cta=nms_lay.smem_bytes,
             band_in_shared=nms_lay.band_in_shared,
             max_active_clusters=max_active_clusters(H, W, cfg.nms_dist),
             b32=dict(nms32, rounds=rounds32)),
    ]
    for r in rows:
        prev = PREVIOUS_MS[r["name"]]
        print(f"kernel {r['name']}: B = 8 device {r['device_ms']:.4f} ms, warm {r['ms']:.4f}, "
              f"cold {r['cold_ms']:.4f} (the design before, warm: {prev:.4f}); B = 32 device "
              f"{r['b32']['device_ms']:.4f}, warm {r['b32']['ms']:.4f}, cold "
              f"{r['b32']['cold_ms']:.4f}, bound {r['b32']['bound_ms']:.4f} "
              f"({r['b32']['bound_share']:.2f} of cold) [{card}]")
    del flush, logits32, dec32, decoded, ragged   # out of the training phases' peak

    print(f"[phase 5 done at {time.perf_counter() - t_start:.1f} s]")
    # ---- 6. descriptor loss: kernels against the plain version ----------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = SuperPointConfig(lr_schedule="constant")
    th, tw = tcfg.train_image_size
    tb = tcfg.batch_size
    hinge = (tcfg.lambda_d, tcfg.positive_margin, tcfg.negative_margin, tcfg.cell)

    def value_and_grads(fn, d, wd, *rest):
        d = d.detach().clone().requires_grad_(True)
        wd = wd.detach().clone().requires_grad_(True)
        v = fn(d, wd, *rest)
        v.backward()
        return v.detach(), d.grad, wd.grad

    rng6 = np.random.default_rng(args.seed + 6)
    homog6 = torch.tensor([1.02, 0.01, 3.0, -0.02, 0.98, -2.0, 1e-4, -1e-4],
                          device="cuda")
    for shape in ((2, 6, 8, 32), (1, 8, 16, 16), (2, 10, 14, 8), (2, 13, 15, 128),
                  (2, 13, 15, 8), (2, 10, 14, 12), (1, 9, 15, 100), (1, 4, 4, 8)):
        b6, hc6, wc6, _ = shape
        zero = shape == (1, 4, 4, 8)       # the zero-row hazard of the rsqrt form
        desc = torch.from_numpy(rng6.standard_normal((2, *shape)).astype(np.float32)).cuda()
        if zero:
            desc.zero_()
        mask6 = torch.from_numpy(rng6.random((b6, hc6, wc6)) > 0.15).cuda().float()
        loss6 = lambda d, wd: L.descriptor_loss(d, wd, homog6.expand(b6, 8), mask6, tcfg)
        got = value_and_grads(loss6, desc[0], desc[1])
        with plain_desc_loss():
            want = value_and_grads(loss6, desc[0], desc[1])
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in got), f"finite at {shape}")
        torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=0.0)
        for g, w_ in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w_, rtol=2e-4, atol=2e-6)
        print(f"desc loss {shape}{' zero descriptors' if zero else ''}: value "
              f"{float(got[0]):.6f} vs plain {float(want[0]):.6f}, grad max|diff| "
              f"{max(float((g - w_).abs().max()) for g, w_ in zip(got[1:], want[1:])):.3g}")

    # full width: descriptors of the released weights for scenes and warps
    scenes_t = SceneDataset(args.seed + 60, tb, th, tw)
    imgs_t = torch.from_numpy(np.stack([s_[0] for s_ in scenes_t.items])).cuda()
    gen6 = torch.Generator(device="cuda").manual_seed(args.seed + 6)
    no_pts = torch.zeros((tb, 1, 2), device="cuda")
    warped_t, _, _, _, homog_t = homographic_augmentation_batch(
        gen6, imgs_t, no_pts, torch.zeros((tb, 1), dtype=torch.bool, device="cuda"),
        HomographyConfig())
    with torch.no_grad():
        desc2 = fe.model.features(torch.cat([imgs_t, warped_t]))[1]
    hc_t, wc_t = tcfg.grid_size(th, tw)
    n_t, dim_t = hc_t * wc_t, tcfg.descriptor_dim
    d_t = L._l2_normalize(desc2[:tb].reshape(tb, n_t, dim_t), -1).clone()
    wd_t = L._l2_normalize(desc2[tb:].reshape(tb, n_t, dim_t), -1).clone()
    centers_t = L._cell_centers(hc_t, wc_t, tcfg.cell, "cuda")
    wcent_t = warp_points(centers_t, homog_t)
    mask_t = (torch.rand((tb, n_t), generator=gen6, device="cuda") > 0.15).float()
    full_args = (wcent_t, centers_t, mask_t, *hinge)
    got = value_and_grads(hinge_descriptor_loss_cuda, d_t, wd_t, *full_args)
    want = value_and_grads(hinge_descriptor_loss_plain, d_t, wd_t, *full_args)
    again = value_and_grads(hinge_descriptor_loss_cuda, d_t, wd_t, *full_args)
    torch.cuda.synchronize()
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          "descriptor-loss kernels repeat bit for bit")
    dl_fwd_err = float((got[0] - want[0]).abs())
    torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=0.0)
    gmax = max(float(w_.abs().max()) for w_ in want[1:])
    dl_bwd_err = max(float((g - w_).abs().max()) for g, w_ in zip(got[1:], want[1:]))
    for g, w_ in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w_, rtol=2e-4, atol=2e-6 * gmax)
    print(f"desc loss full width {(tb, hc_t, wc_t, dim_t)}: mask zeros "
          f"{1 - float(mask_t.mean()):.3f}, correspondences "
          f"{float(((wcent_t[:, :, None] - centers_t[None, None]).square().sum(-1) < 56.25).sum()) / tb:.0f}"
          f"/item, value {float(got[0]):.4f} vs plain {float(want[0]):.4f} "
          f"(|diff| {dl_fwd_err:.3g}), grad max|diff| {dl_bwd_err:.3g} of max|grad| {gmax:.3g}")
    del got, want, again

    # the card's own yardstick of one N x N x D product: cuBLAS through
    # torch.bmm, float32 and TF32 (printed only; the port never calls it)
    yard = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        yard[tf32] = event_ms(lambda: torch.bmm(d_t, wd_t.transpose(1, 2)), 20)
    torch.backends.cuda.matmul.allow_tf32 = False
    prod_flop = 2.0 * tb * n_t * n_t * dim_t
    print(f"product yardstick {(tb, n_t, dim_t)}: torch.bmm float32 {yard[False]:.4f} ms "
          f"({prod_flop / yard[False] / 1e9:.1f} TFLOP/s), allow_tf32 {yard[True]:.4f} ms "
          f"({prod_flop / yard[True] / 1e9:.1f} TFLOP/s), writing the (B, N, N) product [{card}]")

    print(f"[phase 6 done at {time.perf_counter() - t_start:.1f} s]")
    # ---- 7. the training path at full width -----------------------------
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    dataset = SceneDataset(args.seed + 70, tb * 5, th, tw)
    loader = BatchLoader(dataset, tb, tcfg.max_points, seed=args.seed)
    print(f"train data: {len(dataset)} scenes {th}x{tw}, "
          f"{np.mean([len(p_) for _, p_ in dataset.items]):.1f} corner points a "
          f"scene, made in {time.perf_counter() - t0:.2f} s")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir=str(kernels.BUILD_DIR))
    trainer = Trainer(tcfg, "superpoint", loader, None, ckpt_dir, seed=args.seed,
                      device="cuda", log_every=1, write_statistics=False)
    model_t = trainer.state.model
    before = {k: v.detach().clone() for k, v in model_t.state_dict().items()}
    zero_kernel_counts()
    epochs = [trainer.train_epoch(e) for e in range(TRAIN_STEPS // len(loader))]
    torch.cuda.synchronize()
    dl_launches = kernel_counts(("descriptor_loss_fwd", "descriptor_loss_bwd"))
    shutil.rmtree(ckpt_dir)
    print(f"training path launches: {dl_launches} in {trainer.state.step} steps")
    check(trainer.state.step == TRAIN_STEPS, f"{TRAIN_STEPS} steps taken")
    check(all(v == TRAIN_STEPS for v in dl_launches.values()),
          "the forward and backward wrappers launched once a step")
    for e, m in enumerate(epochs):
        print(f"  epoch {e} (mean of {len(loader)} steps): " +
              " ".join(f"{k}={v:.4f}" for k, v in m.items()))
        check(all(np.isfinite(v) for v in m.values()), f"finite metrics, epoch {e}")
    check(int(trainer.state.optimizer.count) == TRAIN_STEPS, "no step was skipped")
    check(epochs[-1]["loss"] < epochs[0]["loss"],
          "mean loss of the last 5 steps below that of the first 5")
    after = model_t.state_dict()
    for head in ("encoder", "detector", "descriptor"):
        moved = [k for k in after if k.startswith(head) and k.endswith("weight")
                 and not torch.equal(after[k], before[k])]
        check(len(moved) > 0, f"{head} parameters moved")
    check(all(not torch.equal(after[k], before[k]) for k in after
              if k.endswith("running_var")), "running statistics moved")

    def fresh_state(frozen=None, config=tcfg):
        """A TrainState on a copy of the trained model, with a new optimizer."""
        m = copy.deepcopy(model_t)
        return S.create_train_state(
            m, make_optimizer(config, m.named_parameters(), frozen_subtree=frozen))

    batch_t = trainer._to_device(next(loader.epoch(0)))
    gen7 = torch.Generator(device="cuda")
    mp_state = fresh_state("descriptor")
    mp_before = {k: v.detach().clone() for k, v in mp_state.model.state_dict().items()}
    _, mp_metrics = S.magicpoint_train_step(
        mp_state, batch_t, gen7.manual_seed(args.seed), config=tcfg)
    mp_after = mp_state.model.state_dict()
    check(all(torch.equal(mp_after[k], mp_before[k]) for k in mp_after
              if k.startswith("descriptor")), "MagicPoint step leaves the descriptor head")
    check(not torch.equal(mp_after["detector.layer.0.conv1.weight"],
                          mp_before["detector.layer.0.conv1.weight"]),
          "MagicPoint step moves the detector")
    check(bool(torch.isfinite(mp_metrics["loss"])), "finite MagicPoint loss")
    print(f"magicpoint step: loss {float(mp_metrics['loss']):.4f} "
          f"f1 {float(mp_metrics['f1']):.4f}; descriptor head unchanged")
    del mp_state

    def joint_loss():
        _, gm = S.superpoint_train_step(
            fresh_state(), batch_t, gen7.manual_seed(args.seed + 1), config=tcfg)
        return float(gm["loss"])

    kernel_loss = joint_loss()
    with plain_desc_loss():
        plain_loss = joint_loss()
    print(f"kernels vs plain descriptor loss: total loss {kernel_loss:.6f} vs {plain_loss:.6f}")
    check(abs(kernel_loss - plain_loss) <= 1e-4 * abs(plain_loss),
          "the plain descriptor loss gives the same loss to rtol 1e-4")

    print(f"[phase 7 done at {time.perf_counter() - t_start:.1f} s]")
    # ---- 8. training timing ----------------------------------------------
    st = fresh_state()
    torch.cuda.reset_peak_memory_stats()
    step_ms = [host_median_ms(lambda: S.superpoint_train_step(st, batch_t, gen7, config=tcfg),
                              runs=10) for _ in range(2)]
    print(f"train step b{tb}: {step_ms} ms/step ({1e3 * tb / float(np.mean(step_ms)):.1f} "
          f"images/s), peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB "
          f"[{card}]")

    parts = {k: [] for k in ("augment", "forward", "loss", "backward", "update")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name].append((time.perf_counter() - t1) * 1e3)
        return out

    for it in range(8):
        warped, labels, wlabels, cmask, homog, images = timed(
            "augment", lambda: S._augment_and_encode(batch_t, gen7, tcfg, HomographyConfig()))
        st.model.train().zero_grad(set_to_none=True)
        logits2, descs2 = timed(
            "forward", lambda: st.model.features(torch.cat([images, warped])))
        losses = timed("loss", lambda: L.global_loss(
            logits2[:tb], labels, logits2[tb:], wlabels, descs2[:tb], descs2[tb:],
            homog, cmask, tcfg))
        timed("backward", losses["total"].backward)
        timed("update", st.optimizer.step)
    med = {k: float(np.median(v[3:])) for k, v in parts.items()}
    total = sum(med.values())
    print(f"train step parts (each ended by a synchronise, median of 5): " +
          ", ".join(f"{k} {v:.3f} ms ({v / total:.2f})" for k, v in med.items()) +
          f"; sum {total:.3f} ms [{card}]")
    prof_window(lambda: S.superpoint_train_step(st, batch_t, gen7, config=tcfg),
                3, 1, f"b{tb} train step", "step", card, named=DL_KERNEL_NAMES)
    del st

    prod = 2.0 * tb * n_t * n_t * dim_t         # one N x N x D product
    dl_in = 4 * (2 * d_t.numel() + wcent_t.numel() + centers_t.numel() + mask_t.numel())
    fwd_bytes = dl_in + 4 * (2 * tb * n_t + 1)  # + rr, c and the loss out
    bwd_bytes = dl_in + 4 * (2 * tb * n_t + 1) + 4 * 2 * d_t.numel()
    d_req = d_t.detach().clone().requires_grad_(True)
    wd_req = wd_t.detach().clone().requires_grad_(True)
    v_k = hinge_descriptor_loss_cuda(d_req, wd_req, *full_args)
    v_p = hinge_descriptor_loss_plain(d_req, wd_req, *full_args)
    dl_ms = {
        "k_fwd": event_ms(lambda: hinge_descriptor_loss_cuda(d_req, wd_req, *full_args), 20),
        "p_fwd": event_ms(lambda: hinge_descriptor_loss_plain(d_req, wd_req, *full_args), 20),
        "k_bwd": event_ms(lambda: torch.autograd.grad(v_k, (d_req, wd_req), retain_graph=True), 20),
        "p_bwd": event_ms(lambda: torch.autograd.grad(v_p, (d_req, wd_req), retain_graph=True), 20),
    }
    dl_cuda_launches = {
        "fwd": traced_launches(
            lambda: hinge_descriptor_loss_cuda(d_req, wd_req, *full_args),
            DL_KERNEL_NAMES),
        "bwd": traced_launches(
            lambda: torch.autograd.grad(v_k, (d_req, wd_req), retain_graph=True),
            DL_KERNEL_NAMES),
    }
    # products run, from the trace: full width went through the tensor-core
    # sweeps if and only if these are their launches
    dl_products = {k: sum(DL_KERNEL_PRODUCTS[name] * count for name, count in v.items())
                   for k, v in dl_cuda_launches.items()}
    print(f"descriptor-loss launches a call: {dl_cuda_launches}")
    check(all(v > 0 for v in dl_products.values()),
          "the traced wrapper calls show the tensor-core sweeps' launches")
    # The bound counts the products the function needs, as the TPU kernel
    # computes it: 2 forward (a for the row sums, a again for the hinge), 4
    # backward (2 rebuilt, 2 gradient products).  The port's sweeps run more
    # (`products_run`, from the trace); the extra ones are the design's
    # cost, not part of the bound.
    # The kernels reach float32 accuracy on the tensor cores with three TF32
    # products for one, so the least time is at a third of the TF32 peak;
    # the bound at the float32 FMA peak is kept beside it.
    for name, n_prod, nbytes, err in (("fwd", 2, fwd_bytes, dl_fwd_err),
                                      ("bwd", 4, bwd_bytes, dl_bwd_err)):
        t_ops, t_bytes = n_prod * prod / (TF32_OPS_PER_S / 3), nbytes / HBM_BYTES_PER_S
        rows.append(dict(
            name=f"descriptor_loss_{name}", route="cuda",
            source="feature_point_cnn_tpu_torch/csrc/descriptor_loss.cu",
            replaces="feature_point_cnn_tpu/ops/pallas/descriptor_loss.py:"
                     + ("189" if name == "fwd" else "219"),
            launches=dl_launches[f"descriptor_loss_{name}"], max_abs_err=err,
            ms=dl_ms[f"k_{name}"], plain_ms=dl_ms[f"p_{name}"],
            bound_ms=1e3 * max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None, shape=[tb, n_t, dim_t],
            wrapper_calls_per_step=dl_launches[f"descriptor_loss_{name}"]
            / trainer.state.step,
            cuda_launches_per_call=sum(dl_cuda_launches[name].values()),
            plain_fwd_bwd_ms=dl_ms["p_fwd"] + dl_ms["p_bwd"],
            bound_rate="3xTF32 on the tensor cores, 495/3 TFLOP/s",
            bound_fma_ms=1e3 * max(n_prod * prod / FP32_OPS_PER_S, t_bytes),
            products_run=dl_products[name],
            achieved_tflops=dl_products[name] * prod / dl_ms[f"k_{name}"] / 1e9))
        r, prev = rows[-1], DL_PREVIOUS_MS[name]
        print(f"kernel {r['name']}: {r['ms']:.4f} ms against {prev:.4f} ms "
              f"before the tensor-core redesign ({prev / r['ms']:.2f}x"
              f"{'' if r['ms'] < prev else ', NOT faster'}), "
              f"{r['achieved_tflops']:.1f} TFLOP/s over {r['products_run']} products run "
              f"({n_prod} needed), bound at the float32 FMA peak "
              f"{r['bound_fma_ms']:.4f} ms [{card}]")
    for r in rows:
        timed = r.get("bound_check", "ms")
        print(f"kernel {r['name']} {r['shape']}: {r['ms']:.4f} ms vs plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"held against {timed} {r[timed]:.4f}")
        check(r[timed] >= r["bound_ms"], f"{r['name']}: {timed} not under its bound")
        if "b32" in r:
            check(r["b32"][timed] >= r["b32"]["bound_ms"],
                  f"{r['name']} B = 32: {timed} not under its bound")
    del d_req, wd_req, v_k, v_p, d_t, wd_t, desc2, batch_t
    torch.cuda.empty_cache()

    print(f"[phase 8 done at {time.perf_counter() - t_start:.1f} s]")
    # ---- 9. self-labeling -------------------------------------------------
    sl = selflabel_phase(args.seed, card)

    print(f"[phase 9 done at {time.perf_counter() - t_start:.1f} s]")
    # ---- 10. two-view evaluation ------------------------------------------
    ev = eval_phase(args.seed, card)

    print(f"[phase 10 done at {time.perf_counter() - t_start:.1f} s]")
    # ---- 11. the training data path ---------------------------------------
    td = train_data_phase(args.seed, card, survey)

    print(f"[phase 11 done at {time.perf_counter() - t_start:.1f} s]")
    # ---- 12. tracking, bundle adjustment, VGG and the command line --------
    sc = tracking_ba_vgg_cli_phase(args.seed, card, td["work"] / "packed")
    for r in rows[:2]:
        r["launches_selflabel"] = sl["launches"][r["name"]]
        r["launches_eval"] = ev[r["name"]]
        r["launches_tracking"] = sc["launches_tracking"][r["name"]]
        r["selflabel_shape"] = sl["shapes"][r["name"]]
    for r in rows:
        # wrapper calls of phase 11 (rows 1-2: the overlay's extract; rows
        # 3a/3b: eager steps, warm-up and capture; replays do not call them)
        r["launches_train_data"] = td["launches"][r["name"]]
        # wrapper calls of phase 12's command line (inference, both trainings)
        r["launches_cli"] = sc["launches_cli"][r["name"]]
    print(json.dumps({"phase12": {k: v for k, v in sc.items()
                                  if not k.startswith("launches")}}))
    for r in rows[2:]:
        r["graph_replay_kernels_traced"] = td["graph_launches"].get("superpoint")

    print(f"[phase 12 done at {time.perf_counter() - t_start:.1f} s]")
    # ---- 13. the parallel layer -------------------------------------------
    pa = parallel_phase(args.seed, card, sl["work"], td["work"] / "packed")
    for r in rows:
        # wrapper calls of phase 13, summed over its processes (two gloo
        # ranks, then the NCCL rank), each counted from 0 before its path
        r["launches_parallel"] = pa["launches"][r["name"]]
        r["launches_parallel_by_rank"] = pa["by_rank"][r["name"]]
        # wrapper calls of phase 13's W-sharded scenario (both gloo ranks and
        # the NCCL rank's width mesh of one): the forwards decode plainly,
        # each extract_spatial launches one decode and one NMS a rank, the
        # W-sharded SuperPoint step one descriptor-loss forward and backward
        r["launches_spatial"] = pa["launches_spatial"][r["name"]]
    print(f"[phase 13 done at {time.perf_counter() - t_start:.1f} s]")
    # ---- 14. export and native serving -----------------------------------
    na = native_phase(args.seed, card, fe, native_work, native_compile_s)
    print(f"[phase 14 done at {time.perf_counter() - t_start:.1f} s]")
    for r in rows:
        # wrapper launches of phase 14's main path: the package's calls in
        # this process (keyframe and 8 frames); the host's are its own
        r["launches_native"] = na["launches"][r["name"]]
    print(json.dumps({"phase14": {k: v for k, v in na.items() if k != "launches"}}))
    # ---- 15. SuperGlue's Sinkhorn kernel ----------------------------------
    # in a process of its own: in the one that ran phases 1-14 the profiler
    # drops a few of the kernel's 201 launch records a call in every traced
    # window, as many in each, which `traced_window` cannot tell from a
    # whole window; a fresh process keeps them all
    sk = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--sinkhorn-worker",
                         "--seed", str(args.seed)], capture_output=True, text=True,
                        timeout=600)
    print(sk.stdout, end="")
    check(sk.returncode == 0, f"phase 15's process exited {sk.returncode}: {sk.stderr[-3000:]}")
    rows.append(json.loads(sk.stdout.strip().splitlines()[-1]))
    print(f"[phase 15 done at {time.perf_counter() - t_start:.1f} s]")
    # ---- 16. the VGG's convolution epilogue -------------------------------
    rows.append(conv_epilogue_phase(args.seed, card))
    print(f"[phase 16 done at {time.perf_counter() - t_start:.1f} s]")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
