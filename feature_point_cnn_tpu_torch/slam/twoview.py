"""Two-view geometry: weighted DLT and fixed-shape RANSAC
(`feature_point_cnn_tpu/slam/twoview.py:37-162`).

RANSAC is a fixed-iteration sweep: all ``iters`` 4-point samples are drawn
at once (Gumbel top-4 among the valid matches), all hypotheses are solved
together by one batched ``eigh`` of their 9x9 normal matrices, the best
one is refit on its inliers three times (LO-RANSAC, ties advance).
Homographies use the framework's flat ``(8,)``
output->input convention and ``(y, x)`` points.  The draws come from a
`torch.Generator` (they cannot repeat `jax.random`'s).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from feature_point_cnn_tpu_torch.geometry.homography import mat2flat
from feature_point_cnn_tpu_torch.geometry.warp import apply_flat_homography


class TwoViewEstimate(NamedTuple):
    h_flat: torch.Tensor       # (8,) homography mapping view-2 pts -> view-1 pts
    inliers: torch.Tensor      # (K,) bool over the match slots
    num_inliers: torch.Tensor  # ()


def _normalization(pts_xy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Hartley normalization ``(..., 3, 3)`` of ``(..., N, 2)`` points with
    weights ``(..., N)``: weighted centroid to the origin, weighted mean
    distance to sqrt(2)."""
    wsum = w.sum(-1).clamp_min(1e-6)
    mean = (pts_xy * w[..., None]).sum(-2) / wsum[..., None]
    dist = torch.linalg.vector_norm(pts_xy - mean[..., None, :], dim=-1)
    mean_dist = (dist * w).sum(-1) / wsum
    s = math.sqrt(2.0) / mean_dist.clamp_min(1e-6)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([
        torch.stack([s, zero, -s * mean[..., 0]], -1),
        torch.stack([zero, s, -s * mean[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


def _dlt_homography(src_xy: torch.Tensor, dst_xy: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Weighted, Hartley-normalized DLT: ``h`` with ``src ≈ H·dst`` (the
    framework's inverse-warp convention), from the eigenvector of the
    smallest eigenvalue of the weighted normal matrix.  ``src_xy, dst_xy``:
    ``(..., N, 2)``; ``w``: ``(..., N)``; returns ``(..., 8)``."""
    t_src = _normalization(src_xy, w)
    t_dst = _normalization(dst_xy, w)
    sn = src_xy * t_src[..., None, 0, 0:1] + t_src[..., None, :2, 2]
    dn = dst_xy * t_dst[..., None, 0, 0:1] + t_dst[..., None, :2, 2]

    x, y = dn[..., 0], dn[..., 1]
    u, v = sn[..., 0], sn[..., 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    ax = torch.stack([x, y, ones, zeros, zeros, zeros, -x * u, -y * u, -u], -1)
    ay = torch.stack([zeros, zeros, zeros, x, y, ones, -x * v, -y * v, -v], -1)
    a = torch.cat([ax, ay], -2) * torch.cat([w, w], -1)[..., None]
    ata = a.transpose(-1, -2) @ a
    _, vecs = torch.linalg.eigh(ata)
    h_norm = vecs[..., :, 0].reshape(ata.shape[:-2] + (3, 3))
    # denormalize: src_n = Ĥ·dst_n  =>  src = T_src^-1 Ĥ T_dst · dst
    h_full = torch.linalg.inv(t_src) @ h_norm @ t_dst
    return mat2flat(h_full)


def _sym_transfer_error(h_flat: torch.Tensor, pts1_xy: torch.Tensor,
                        pts2_xy: torch.Tensor) -> torch.Tensor:
    """One-sided transfer error ``|H·p2 - p1|`` (pixels); ``h_flat`` ``(8,)``
    -> ``(K,)``, ``(I, 8)`` -> ``(I, K)``."""
    proj = apply_flat_homography(h_flat, pts2_xy)
    return torch.linalg.vector_norm(proj - pts1_xy, dim=-1)


def _gumbel_scores(gen: torch.Generator, iters: int, k: int,
                   device: torch.device) -> torch.Tensor:
    """``(iters, k)`` Gumbel scores on ``device``, drawn on the generator's
    device."""
    u = torch.rand((iters, k), generator=gen, device=gen.device).to(device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def ransac_homography(
    gen: torch.Generator,
    pts1_yx: torch.Tensor,
    pts2_yx: torch.Tensor,
    valid: torch.Tensor,
    iters: int = 128,
    inlier_thresh: float = 3.0,
) -> TwoViewEstimate:
    """Estimate the homography relating matched point sets.

    Args:
      gen: draws the minimal samples, on its own device (a CPU generator
        gives the same samples whatever device the points are on).
      pts1_yx / pts2_yx: ``(K, 2)`` corresponding points ``(y, x)`` (invalid
        slots arbitrary); ``valid``: ``(K,)`` bool.

    Returns the refit estimate with ``h_flat`` mapping view-2 points into
    view 1 (``p1 ≈ H·p2``).
    """
    k = pts1_yx.shape[0]
    dev = pts1_yx.device
    p1 = pts1_yx.flip(-1).to(torch.float32)      # (K, 2) (x, y)
    p2 = pts2_yx.flip(-1).to(torch.float32)
    valid = valid.to(torch.bool)
    w_valid = valid.to(torch.float32)

    # `iters` minimal samples among the valid matches: Gumbel top-4 without
    # replacement per hypothesis
    g = _gumbel_scores(gen, iters, k, dev)
    idx = torch.where(valid, g, -torch.inf).topk(4, dim=-1).indices   # (iters, 4)

    w = torch.zeros((iters, k), device=dev).scatter(1, idx, 1.0) * w_valid
    hs = _dlt_homography(p1.expand(iters, k, 2), p2.expand(iters, k, 2), w)
    inl = (_sym_transfer_error(hs, p1, p2) <= inlier_thresh) & valid
    h_best = hs[inl.sum(-1).argmax()]

    # LO-RANSAC: refit on the current inliers three times, keeping the
    # iterate with the most inliers (ties advance: same count, lower residual)
    inl_out = (_sym_transfer_error(h_best, p1, p2) <= inlier_thresh) & valid
    h_out, n_out = h_best, inl_out.sum()
    for _ in range(3):
        h_refit = _dlt_homography(p1, p2, inl_out.to(torch.float32))
        inl2 = (_sym_transfer_error(h_refit, p1, p2) <= inlier_thresh) & valid
        n2 = inl2.sum()
        better = n2 >= n_out
        h_out = torch.where(better, h_refit, h_out)
        inl_out = torch.where(better, inl2, inl_out)
        n_out = torch.where(better, n2, n_out)
    return TwoViewEstimate(h_flat=h_out, inliers=inl_out, num_inliers=n_out)


def sim2_from_homography(h_flat: torch.Tensor) -> torch.Tensor:
    """Project a homography onto Sim(2): ``(theta, log_scale, tx, ty)``,
    from the upper-left 2x2 affine part (mostly-planar, low-perspective
    motion)."""
    a00, a01, a10, a11 = h_flat[0], h_flat[1], h_flat[3], h_flat[4]
    det = a00 * a11 - a01 * a10
    scale = torch.sqrt(det.abs().clamp_min(1e-12))
    theta = torch.atan2(a10 - a01, a00 + a11)
    return torch.stack([theta, torch.log(scale), h_flat[2], h_flat[5]])
