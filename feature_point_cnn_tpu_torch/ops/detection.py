"""Keypoint decode: cell softmax -> prob map -> NMS -> fixed-K keypoints.

Port of `feature_point_cnn_tpu/ops/detection.py`.  Ragged point lists are
fixed ``(B, K)`` tensors with a validity mask (`Keypoints`).  Where the JAX
code calls ``lax.top_k``, which puts the lower index first among equal
scores, this code takes the first K of a stable descending sort, so the
keypoint order matches on tied scores too (NMS leaves ties on plateaus).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.ops.kernels import use_kernel
from feature_point_cnn_tpu_torch.ops.kernels.nms import (
    grid_nms_cuda,
    nms_priority_key,
)
# the NMS kernel's plain version is the port's grid_nms (with nms_iters)
from feature_point_cnn_tpu_torch.ops.kernels.nms import grid_nms_plain as grid_nms
from feature_point_cnn_tpu_torch.ops.labels import restore_prob_map

__all__ = [
    "Keypoints", "softmax65", "decode_prob_map", "nms_priority_key",
    "grid_nms", "extract_keypoints", "extract_keypoints_from_scores",
    "refine_keypoints", "keypoints_to_numpy",
]


class Keypoints(NamedTuple):
    """Fixed-size keypoint set: tensors ``(B, K)``; invalid slots zeroed."""

    y: torch.Tensor       # (B, K) float32 row coordinate
    x: torch.Tensor       # (B, K) float32 col coordinate
    score: torch.Tensor   # (B, K) float32 confidence, descending
    valid: torch.Tensor   # (B, K) bool

    @property
    def num(self) -> torch.Tensor:
        return self.valid.sum(-1)


def softmax65(logits: torch.Tensor) -> torch.Tensor:
    """Reference softmax ``exp(l) / (sum(exp(l)) + 1e-5)``, computed stably
    in float32: ``exp(-m)`` carries the epsilon into the shifted frame."""
    logits = logits.to(torch.float32)
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    return e / (e.sum(-1, keepdim=True) + 1e-5 * torch.exp(-m))


def decode_prob_map(logits: torch.Tensor, cell: int) -> torch.Tensor:
    """``(B, Hc, Wc, 65)`` logits -> ``(B, H, W)`` probability map."""
    return restore_prob_map(softmax65(logits), cell)


def extract_keypoints(
    prob_map: torch.Tensor, config: SuperPointConfig
) -> Keypoints:
    """Threshold + NMS + border strip + top-K (`get_points`): border points
    are removed after NMS, so they still suppress their neighbours."""
    scores = torch.where(prob_map >= config.confidence_thresh, prob_map, 0.0)
    return extract_keypoints_from_scores(scores, config)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` order: descending, lower index first among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def extract_keypoints_from_scores(
    scores: torch.Tensor, config: SuperPointConfig
) -> Keypoints:
    """NMS + border strip + top-K on an already-thresholded score map."""
    b, h, w = scores.shape
    if use_kernel(config.use_cuda_nms, scores):
        scores = grid_nms_cuda(scores, config.nms_dist)
        exact_nms = True
    else:
        scores = grid_nms(scores, config.nms_dist, config.nms_iters)
        # truncated suppression may leave closer-than-radius survivors,
        # which voids the block-max reduction below
        exact_nms = config.nms_iters == 0

    br = config.border_remove
    ys = torch.arange(h, device=scores.device)
    xs = torch.arange(w, device=scores.device)
    border_ok = ((ys >= br) & (ys < h - br))[:, None] & (
        (xs >= br) & (xs < w - br)
    )[None, :]
    scores = torch.where(border_ok[None], scores, 0.0)

    k = min(config.max_keypoints, h * w)
    blk = 4
    if exact_nms and config.nms_dist >= blk - 1 and h % blk == 0 and w % blk == 0:
        # exact top-K over a 16x smaller domain: NMS survivors are >=
        # nms_dist+1 apart, so a 4x4 block holds at most one of them
        hb, wb = h // blk, w // blk
        blocks = scores.reshape(b, hb, blk, wb, blk).permute(0, 1, 3, 2, 4)
        blocks = blocks.reshape(b, hb * wb, blk * blk)
        bvals = blocks.amax(-1)
        barg = blocks.argmax(-1)
        top_scores, top_cell = _top_k(bvals, min(k, hb * wb))
        sub = torch.gather(barg, 1, top_cell)
        cy = (top_cell // wb) * blk + sub // blk
        cx = (top_cell % wb) * blk + sub % blk
        pad = k - top_scores.shape[1]
        if pad > 0:  # tiny images: pad to the K contract
            top_scores = F.pad(top_scores, (0, pad))
            cy, cx = F.pad(cy, (0, pad)), F.pad(cx, (0, pad))
    else:
        top_scores, top_idx = _top_k(scores.reshape(b, h * w), k)
        cy, cx = top_idx // w, top_idx % w
    valid = top_scores > 0.0
    zero = torch.zeros((), dtype=cy.dtype, device=cy.device)
    return Keypoints(
        y=torch.where(valid, cy, zero).float(),
        x=torch.where(valid, cx, zero).float(),
        score=torch.where(valid, top_scores, 0.0),
        valid=valid,
    )


def refine_keypoints(prob_map: torch.Tensor, kp: Keypoints) -> Keypoints:
    """Subpixel refinement: a per-axis log-parabola through the keypoint's
    3-pixel probability profile, offset clipped to +-0.5
    (`detection.py:258-293`).  Invalid slots pass through unchanged."""
    b, h, w = prob_map.shape
    offs = torch.arange(-1, 2, device=prob_map.device)
    yy = (kp.y.long()[..., None, None] + offs[None, None, :, None]).clamp(0, h - 1)
    xx = (kp.x.long()[..., None, None] + offs[None, None, None, :]).clamp(0, w - 1)
    bi = torch.arange(b, device=prob_map.device)[:, None, None, None]
    vals = prob_map[bi, yy, xx]                               # (B, K, 3, 3)
    lv = torch.log(torch.clamp(vals, min=1e-20))

    def parabola(lm, l0, lp):
        denom = lm - 2.0 * l0 + lp
        safe = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
        off = 0.5 * (lm - lp) / safe
        # a non-concave profile has no interior peak: keep 0
        return torch.where(denom < 0.0, off.clamp(-0.5, 0.5), 0.0)

    dy = parabola(lv[..., 0, 1], lv[..., 1, 1], lv[..., 2, 1])
    dx = parabola(lv[..., 1, 0], lv[..., 1, 1], lv[..., 1, 2])
    y = torch.where(kp.valid, (kp.y + dy).clamp(0.0, h - 1.0), kp.y)
    x = torch.where(kp.valid, (kp.x + dx).clamp(0.0, w - 1.0), kp.x)
    return kp._replace(y=y, x=x)


def keypoints_to_numpy(kp: Keypoints, batch_index: int = 0) -> np.ndarray:
    """One batch element as the reference's ragged ``3 x N`` ``[x, y,
    conf]`` numpy layout."""
    v = kp.valid[batch_index].cpu().numpy()
    return np.stack([
        kp.x[batch_index].cpu().numpy()[v],
        kp.y[batch_index].cpu().numpy()[v],
        kp.score[batch_index].cpu().numpy()[v],
    ])
