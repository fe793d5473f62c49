"""Descriptor sampling at keypoints (`feature_point_cnn_tpu/ops/
descriptors.py:22-67`).

``grid_sample(align_corners=True)`` with the reference's normalisation
``g = p / (size/2) - 1`` samples the ``(Hc, Wc)`` map at
``(y/H * (Hc-1), x/W * (Wc-1))``; that is computed directly here.
"""

from __future__ import annotations

import torch

from feature_point_cnn_tpu_torch.ops.detection import Keypoints


def sample_descriptors(
    desc_map: torch.Tensor, kp: Keypoints, img_h: int, img_w: int
) -> torch.Tensor:
    """Bilinearly sample and L2-normalise ``(B, Hc, Wc, D)`` descriptors at
    keypoints -> ``(B, K, D)`` unit vectors, zeros in invalid slots."""
    b, hc, wc, d = desc_map.shape
    sy = kp.y / img_h * (hc - 1)
    sx = kp.x / img_w * (wc - 1)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0)[..., None], (sx - x0)[..., None]
    y0i = y0.long().clamp(0, hc - 1)
    x0i = x0.long().clamp(0, wc - 1)
    y1i = (y0i + 1).clamp(0, hc - 1)
    x1i = (x0i + 1).clamp(0, wc - 1)

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
    return torch.where(kp.valid[..., None], desc, 0.0)
