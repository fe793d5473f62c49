"""Descriptor sampling at keypoints (`feature_point_cnn_tpu/ops/
descriptors.py:22-67`).

``grid_sample(align_corners=True)`` with the reference's normalisation
``g = p / (size/2) - 1`` samples the ``(Hc, Wc)`` map at
``(y/H * (Hc-1), x/W * (Wc-1))``; that is computed directly here.

Under a width group (`parallel/spatial.py`) `sample_descriptors` samples
the map W-sharded without gathering it: the rank whose block holds a
keypoint's left bilinear column samples it, with its right neighbour's
first column as a one-column halo, by the same arithmetic; the others
write zeros, and one sum over the group gives every rank every descriptor
exactly.
"""

from __future__ import annotations

from typing import Tuple

import torch

from feature_point_cnn_tpu_torch.ops.detection import Keypoints
from feature_point_cnn_tpu_torch.parallel import spatial

_Corners = Tuple[torch.Tensor, ...]


def _corners(kp: Keypoints, img_h: int, img_w: int, hc: int, wc: int) -> _Corners:
    """``(wy, wx, y0, x0, y1, x1)``: the bilinear weights ``(B, K, 1)`` and
    the four corner indices ``(B, K)`` on the whole ``(hc, wc)`` grid."""
    sy = kp.y / img_h * (hc - 1)
    sx = kp.x / img_w * (wc - 1)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0)[..., None], (sx - x0)[..., None]
    y0i = y0.long().clamp(0, hc - 1)
    x0i = x0.long().clamp(0, wc - 1)
    y1i = (y0i + 1).clamp(0, hc - 1)
    x1i = (x0i + 1).clamp(0, wc - 1)
    return wy, wx, y0i, x0i, y1i, x1i


def _interpolate(desc_map: torch.Tensor, corners: _Corners,
                 keep: torch.Tensor) -> torch.Tensor:
    """The unit-normalised bilinear samples of ``desc_map`` at ``corners``
    (columns of ``desc_map``), zeros where ``keep`` is false."""
    wy, wx, y0i, x0i, y1i, x1i = corners
    b, hc, wc, d = desc_map.shape
    flat = desc_map.reshape(b, hc * wc, d)
    bi = torch.arange(b, device=desc_map.device)[:, None]
    t00 = flat[bi, y0i * wc + x0i]
    t01 = flat[bi, y0i * wc + x1i]
    t10 = flat[bi, y1i * wc + x0i]
    t11 = flat[bi, y1i * wc + x1i]
    top = t00 * (1 - wx) + t01 * wx
    bot = t10 * (1 - wx) + t11 * wx
    desc = top * (1 - wy) + bot * wy                          # (B, K, D)
    desc = desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.where(keep[..., None], desc, 0.0)


def sample_descriptors(
    desc_map: torch.Tensor, kp: Keypoints, img_h: int, img_w: int
) -> torch.Tensor:
    """Bilinearly sample and L2-normalise ``(B, Hc, Wc, D)`` descriptors at
    keypoints -> ``(B, K, D)`` unit vectors, zeros in invalid slots.

    Under a width group of d ranks ``desc_map`` is this rank's ``(B, Hc,
    Wc / d, D)`` block of equal blocks and ``kp`` the whole image's
    keypoints (the same on every rank); every rank gets the whole result,
    equal bit for bit to the sample of the whole map."""
    rank, size = spatial.split()
    _, hc, n, _ = desc_map.shape
    corners = _corners(kp, img_h, img_w, hc, n * size)
    if size == 1:
        return _interpolate(desc_map, corners, kp.valid)
    wy, wx, y0i, x0i, y1i, x1i = corners
    a = rank * n
    mine = (x0i >= a) & (x0i < a + n)
    # the right corner lies at most one column past the block, on the next
    # rank; the last rank never reads its pad (x1 is clamped to Wc - 1)
    block = spatial.halo(desc_map.permute(0, 3, 1, 2), 0, 1).permute(0, 2, 3, 1)
    x0l = torch.where(mine, x0i - a, 0)
    x1l = torch.where(mine, x1i - a, 0)
    desc = _interpolate(block, (wy, wx, y0i, x0l, y1i, x1l), kp.valid & mine)
    return spatial.sum_blocks(desc)
