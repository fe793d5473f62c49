"""Visual-tracking evaluation: track a rendered Sim(2) sequence and report
its ATE (`feature_point_cnn_tpu/eval/tracking.py:33-200`).

A video is rendered by warping a base image along a smooth ground-truth
Sim(2) trajectory (one batched `warp_image` call on the device), the
`slam.tracking.Tracker` runs on it with a feature provider (the
`SuperPointFrontend` through `frontend_extractor`), and the estimated
trajectory is scored with `slam.trajectory`'s ATE and match and inlier
statistics.  ``posegraph=True`` adds loop-closure detection and pose-graph
refinement.

Usage (on the card; ``main(argv, device="cpu")`` runs it on the CPU):
    python -m feature_point_cnn_tpu_torch.eval.tracking --weights-path W \
        [--source synthetic|<image-or-dir>] [--frames 40] [--loops 2 --posegraph]

``--weights-path`` is a ``weights/*.npz`` snapshot or a directory of the
port's checkpoints, and needs a trained descriptor head.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict

import numpy as np
import torch

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.device import resolve_device
from feature_point_cnn_tpu_torch.geometry.warp import warp_image
from feature_point_cnn_tpu_torch.slam.twoview import sim2_from_homography


def sim2_h_flat(theta: float, scale: float, tx: float, ty: float) -> np.ndarray:
    """Flat (8,) homography (warp_image's output->input, (x, y) coords) of a
    similarity about the origin: ``in = scale*R(theta)*out + t``."""
    c, s = np.cos(theta), np.sin(theta)
    return np.asarray(
        [scale * c, -scale * s, tx, scale * s, scale * c, ty, 0.0, 0.0],
        np.float32,
    )


def smooth_trajectory(
    n_frames: int,
    max_shift: float = 24.0,
    max_theta: float = 0.06,
    max_log_scale: float = 0.03,
    loops: int = 1,
) -> np.ndarray:
    """(N, 4) ground-truth warp parameters (theta, scale, tx, ty), frame 0 =
    identity, a sinusoidal camera sweep; ``loops > 1`` repeats the sweep so
    the camera revisits earlier viewpoints (loop closures need that)."""
    t = np.linspace(0.0, loops * 2.0 * np.pi, n_frames)
    theta = max_theta * np.sin(t)
    scale = np.exp(max_log_scale * np.sin(2.0 * t))
    tx = max_shift * np.sin(t)
    ty = max_shift * 0.6 * (1.0 - np.cos(t))
    return np.stack([theta, scale, tx, ty], -1).astype(np.float32)


def render_sequence(base: np.ndarray, params: np.ndarray, device=None) -> torch.Tensor:
    """Warp ``base (H, W, C)`` by each (theta, scale, tx, ty) in one batched
    call on ``device``: ``(N, H, W, C)`` float32 frames there."""
    dev = resolve_device(device)
    hs = torch.from_numpy(np.stack([sim2_h_flat(*p) for p in params])).to(dev)
    image = torch.as_tensor(np.asarray(base, np.float32), device=dev)
    return warp_image(image.expand(len(params), *image.shape), hs)


def evaluate_tracking(
    extract: Callable,
    base: np.ndarray,
    n_frames: int = 40,
    min_inliers: int = 30,
    max_shift: float = 24.0,
    loops: int = 1,
    posegraph: bool = False,
    loop_min_inliers: int = 25,
    device=None,
) -> Dict[str, object]:
    """Track the rendered sequence; returns ATE and tracking statistics.

    ``extract``: ``image -> FrameFeatures`` (e.g.
    `slam.tracking.frontend_extractor(frontend)`); frames are rendered on
    ``device`` (``None``: ``cuda``) and handed to it one by one.  With
    ``posegraph=True`` the odometry is also refined by loop closures and the
    Sim(2) pose graph, and the result carries both ATE columns (use
    ``loops >= 2`` so the trajectory revisits old viewpoints).
    """
    from feature_point_cnn_tpu_torch.slam.tracking import (
        Tracker,
        detect_loop_closures,
        refine_with_pose_graph,
    )
    from feature_point_cnn_tpu_torch.slam.trajectory import absolute_trajectory_error

    params = smooth_trajectory(n_frames, max_shift=max_shift, loops=loops)
    frames = render_sequence(base, params, device)
    # frame 0 is the identity warp and the tracker's first keyframe, so the
    # ground-truth pose of frame i is the Sim(2) projection of its render
    # transform, in the plain (x, y) warp convention
    gt = sim2_from_homography(torch.from_numpy(
        np.stack([sim2_h_flat(*p) for p in params])).T).T.numpy()
    tracker = Tracker(extract=extract, min_inliers=min_inliers)
    results = tracker.track(frames.unbind(0))
    est = np.stack([r["pose"] for r in results])
    ate = absolute_trajectory_error(est[1:, 2:4], gt[1:, 2:4], align=False)
    tracked = [bool(r.get("tracked", False)) for r in results[1:]]
    out = {
        "frames": int(n_frames),
        "ate_rmse_px": ate["ate_rmse"],
        "ate_max_px": ate["ate_max"],
        "frac_tracked": float(np.mean(tracked)),
        "mean_matches": float(np.mean([r["num_matches"] for r in results[1:]])),
        "mean_inliers": float(np.mean([r["num_inliers"] for r in results[1:]])),
        "num_keyframes": int(sum(r["is_keyframe"] for r in results)),
    }
    if posegraph:
        closures = detect_loop_closures(tracker, min_inliers=loop_min_inliers)
        refined = refine_with_pose_graph(results, tracker, closures)
        ate_pg = absolute_trajectory_error(refined[1:, 2:4], gt[1:, 2:4], align=False)
        out.update({
            "num_loop_closures": len(closures),
            "posegraph_ate_rmse_px": ate_pg["ate_rmse"],
            "posegraph_ate_max_px": ate_pg["ate_max"],
        })
    return out


def _base_image(source: str, shape) -> np.ndarray:
    if source == "synthetic":
        from feature_point_cnn_tpu_torch.eval.benchmark import synthetic_images

        return next(iter(synthetic_images(1, shape, seed=3)))
    from pathlib import Path

    from feature_point_cnn_tpu_torch.selflabel.coco import load_and_crop

    p = Path(source)
    if p.is_dir():
        p = sorted(
            q for q in p.iterdir()
            if q.suffix.lower() in {".jpg", ".jpeg", ".png", ".bmp"}
        )[0]
    img = load_and_crop(str(p), shape)
    if img is None:
        raise SystemExit(f"could not read image: {p}")
    return img


def main(argv=None, device=None) -> Dict[str, object]:
    """Parse ``argv``, run the evaluation on ``device`` (``None``: ``cuda``),
    print its JSON and return it."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--weights-path", required=True,
                    help="weights/*.npz snapshot or checkpoint directory (needs "
                         "a trained descriptor head, i.e. a SuperPoint-phase one)")
    ap.add_argument("--source", default="synthetic",
                    help="'synthetic', an image file, or an image directory")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--H", type=int, default=240)
    ap.add_argument("--W", type=int, default=320)
    ap.add_argument("--max-keypoints", type=int, default=512)
    ap.add_argument("--subpixel", action="store_true",
                    help="log-parabola subpixel keypoint refinement")
    ap.add_argument("--loops", type=int, default=1,
                    help="trajectory sweeps (>= 2 revisits old viewpoints)")
    ap.add_argument("--max-shift", type=float, default=24.0)
    ap.add_argument("--posegraph", action="store_true",
                    help="loop-closure detection + Sim(2) pose-graph "
                         "refinement; adds posegraph_ate_* columns")
    opt = ap.parse_args(argv)

    from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
    from feature_point_cnn_tpu_torch.slam.tracking import frontend_extractor

    cfg = SuperPointConfig(max_keypoints=opt.max_keypoints, subpixel_refine=opt.subpixel)
    frontend = SuperPointFrontend(cfg, weights_path=opt.weights_path, device=device)
    base = _base_image(opt.source, (opt.H, opt.W))
    out = evaluate_tracking(
        frontend_extractor(frontend), base, n_frames=opt.frames,
        loops=opt.loops, max_shift=opt.max_shift, posegraph=opt.posegraph,
        device=frontend.device,
    )
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
