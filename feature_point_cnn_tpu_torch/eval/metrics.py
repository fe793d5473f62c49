"""Detector/descriptor quality metrics, the HPatches evaluation protocol
(`feature_point_cnn_tpu/eval/metrics.py:35-197`), on the port's fixed-K
`Keypoints`:

* **repeatability**: fraction of keypoints re-detected within ``eps`` px
  under a known homography (symmetric, over the points that land in the
  shared view region), and the **localization error** of the repeats;
* **matching score**: fraction of shared-region keypoints whose MNN
  descriptor match lies within ``eps`` of its warped location;
* **homography accuracy**: the port's `ransac_homography` (seeded 0) on the
  matches; correct when the mean corner error is within ``eps``.
  ``homography_error_cv2`` is ``cv2.findHomography``'s estimate, a second
  opinion: NaN where ``cv2`` is not installed.

Geometry uses ``(y, x)`` points and flat output->input homographies;
`warp_points` moves view-1 points into view 2.  The keypoints and
descriptors may lie on any device; the point geometry runs on the CPU in
float32, RANSAC and matching on the keypoints' device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from feature_point_cnn_tpu_torch.geometry import homography as G
from feature_point_cnn_tpu_torch.ops.detection import Keypoints
from feature_point_cnn_tpu_torch.ops.matching import mnn_match
from feature_point_cnn_tpu_torch.slam.twoview import ransac_homography


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _warp(points: np.ndarray, h_flat) -> np.ndarray:
    """`warp_points` on ``(N, 2)`` numpy points, float32 on the CPU."""
    h = torch.as_tensor(np.asarray(h_flat, np.float32))
    return G.warp_points(torch.from_numpy(np.asarray(points, np.float32)), h).numpy()


def _in_image(points: np.ndarray, shape) -> np.ndarray:
    return G.points_in_image_mask(torch.from_numpy(points), shape).numpy()


def _valid_points(kp: Keypoints, index: int) -> np.ndarray:
    v = _np(kp.valid[index])
    return np.stack([_np(kp.y[index])[v], _np(kp.x[index])[v]], -1)


def _pairwise_min_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """For each row of ``a``, distance to the nearest row of ``b``."""
    if len(a) == 0 or len(b) == 0:
        return np.full((len(a),), np.inf)
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    return d.min(axis=1)


def repeatability(
    kp1: Keypoints,
    kp2: Keypoints,
    h_flat: np.ndarray,
    shape,
    eps: float = 3.0,
    index: int = 0,
) -> Dict[str, float]:
    """Symmetric repeatability + localization error for one pair."""
    p1 = _valid_points(kp1, index)
    p2 = _valid_points(kp2, index)
    h_inv = G.invert_homography(torch.as_tensor(np.asarray(h_flat, np.float32))).numpy()

    # view-1 points into view 2, kept where they land inside (and back)
    p1_in2 = _warp(p1, h_flat) if len(p1) else p1
    keep1 = _in_image(p1_in2, shape) if len(p1) else np.zeros(0, bool)
    p2_in1 = _warp(p2, h_inv) if len(p2) else p2
    keep2 = _in_image(p2_in1, shape) if len(p2) else np.zeros(0, bool)

    d1 = _pairwise_min_dists(p1_in2[keep1], p2)
    d2 = _pairwise_min_dists(p2_in1[keep2], p1)
    n_shared = keep1.sum() + keep2.sum()
    n_repeat = (d1 <= eps).sum() + (d2 <= eps).sum()
    loc_err = (
        float(np.concatenate([d1[d1 <= eps], d2[d2 <= eps]]).mean())
        if n_repeat
        else float("nan")
    )
    return {
        "repeatability": float(n_repeat / n_shared) if n_shared else 0.0,
        "localization_error": loc_err,
        "num_shared": int(n_shared),
    }


def _cv2_corner_error(src_xy, dst_xy, corners_yx, true_yx) -> float:
    """``cv2.findHomography``'s RANSAC estimate from ``dst`` to ``src``,
    scored by mean corner error; NaN without ``cv2`` or an estimate."""
    try:
        import cv2
    except ImportError:
        return float("nan")
    est_cv, _ = cv2.findHomography(src_xy.astype(np.float64),
                                   dst_xy.astype(np.float64), cv2.RANSAC, 3.0)
    if est_cv is None:
        return float("nan")
    c_xy = corners_yx[:, ::-1].astype(np.float64)
    proj = np.concatenate([c_xy, np.ones((4, 1))], -1) @ est_cv.T
    proj = (proj[:, :2] / proj[:, 2:])[:, ::-1]   # back to (y, x)
    return float(np.linalg.norm(proj - true_yx, axis=-1).mean())


def matching_metrics(
    kp1: Keypoints,
    desc1,
    kp2: Keypoints,
    desc2,
    h_flat: np.ndarray,
    shape,
    eps: float = 3.0,
    index: int = 0,
    nn_thresh: Optional[float] = None,
) -> Dict[str, float]:
    """Matching score + homography estimation accuracy for one pair."""
    m = mnn_match(
        desc1[index], kp1.valid[index], desc2[index], kp2.valid[index],
        max_l2_dist=nn_thresh,
    )
    mi = _np(m.index)
    mv = _np(m.valid)

    p1 = np.stack([_np(kp1.y[index]), _np(kp1.x[index])], -1)
    p2 = np.stack([_np(kp2.y[index]), _np(kp2.x[index])], -1)
    p1_in2 = _warp(p1, h_flat)

    match_src = p1_in2[mv]
    match_dst = p2[mi[mv]]
    errs = np.linalg.norm(match_src - match_dst, axis=-1)
    correct = errs <= eps

    shared1 = _in_image(p1_in2, shape) & _np(kp1.valid[index])
    denom = min(int(shared1.sum()), int(_np(kp2.valid[index]).sum()))
    matching_score = float(correct.sum() / denom) if denom else 0.0

    # homography from the matches: the port's RANSAC, with cv2's beside it
    hh, ww = shape
    corners_yx = np.array(
        [[0, 0], [0, ww - 1], [hh - 1, ww - 1], [hh - 1, 0]], np.float32
    )
    true = _warp(corners_yx, h_flat)

    h_correct = False
    h_err = float("nan")
    h_err_cv2 = float("nan")
    if mv.sum() >= 4:
        # ``h_flat`` is output->input, so h maps view-2 points to view 1 by
        # direct application; `ransac_homography` returns H with pts1 ≈
        # H·pts2, so view-1 points go first and their matches second
        dev = kp1.y.device
        est = ransac_homography(
            torch.Generator().manual_seed(0),
            torch.from_numpy(p1).to(dev),
            torch.from_numpy(p2[mi]).to(dev),
            torch.from_numpy(mv).to(dev),
            inlier_thresh=float(eps),
        )
        proj = _warp(corners_yx, _np(est.h_flat))
        h_err = float(np.linalg.norm(proj - true, axis=-1).mean())
        h_correct = h_err <= eps
        h_err_cv2 = _cv2_corner_error(p1[mv][:, ::-1], match_dst[:, ::-1],
                                      corners_yx, true)
    out = {
        "matching_score": matching_score,
        "num_matches": int(mv.sum()),
        "num_correct_matches": int(correct.sum()),
        "match_precision": float(correct.mean()) if mv.sum() else 0.0,
        "homography_correct": float(h_correct),
        "homography_error": h_err,
        "homography_error_cv2": h_err_cv2,
    }
    # HPatches-protocol accuracy at the standard corner-error thresholds,
    # from the same estimate (0.0 when no estimate was possible)
    for tol in (1.0, 3.0, 5.0):
        out[f"homography_acc_{int(tol)}px"] = float(
            np.isfinite(h_err) and h_err <= tol
        )
    return out
