"""Trajectory evaluation: Umeyama alignment and absolute trajectory error
(`feature_point_cnn_tpu/slam/trajectory.py:15-47`).

numpy only; the port keeps its own copy so that it imports nothing of the
JAX package.  Given estimated and ground-truth positions, align them with
the closed-form similarity (Umeyama) and report the RMSE.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def umeyama_align(src: np.ndarray, dst: np.ndarray) -> Dict[str, np.ndarray]:
    """Least-squares similarity ``dst ≈ s·R·src + t`` for ``(N, D)`` points."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    s_fix = np.eye(cov.shape[0])
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_fix[-1, -1] = -1.0
    rot = u @ s_fix @ vt
    var_s = (xs ** 2).sum() / len(src)
    scale = float(np.trace(np.diag(d) @ s_fix) / max(var_s, 1e-12))
    trans = mu_d - scale * rot @ mu_s
    return {"rotation": rot, "scale": scale, "translation": trans}


def absolute_trajectory_error(
    estimated: np.ndarray, ground_truth: np.ndarray, align: bool = True
) -> Dict[str, float]:
    """ATE over ``(N, D)`` position sequences; RMSE, mean and max in the
    ground truth's units (pixels for planar tracking)."""
    est = np.asarray(estimated, np.float64)
    gt = np.asarray(ground_truth, np.float64)
    if est.shape != gt.shape:
        raise ValueError(f"shapes differ: {est.shape} and {gt.shape}")
    if align and len(est) >= 2:
        a = umeyama_align(est, gt)
        est = est @ a["rotation"].T * a["scale"] + a["translation"]
    err = np.linalg.norm(est - gt, axis=-1)
    return {
        "ate_rmse": float(np.sqrt((err ** 2).mean())),
        "ate_mean": float(err.mean()),
        "ate_max": float(err.max()),
    }
