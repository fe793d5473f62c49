"""65-way cell label codec (`feature_point_cnn_tpu/ops/labels.py`).
Keypoints are encoded as per-cell 65-class labels over ``cell x cell``
blocks and decoded back to a full-resolution map by depth-to-space.  Points
are ``(y, x)`` float pixel coordinates in fixed-size padded sets with a
validity mask.  Within a cell, class index = ``dy * cell + dx`` (row-major);
class 64 is the dustbin."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def space_to_depth(x: torch.Tensor, cell: int) -> torch.Tensor:
    """``(..., H, W) -> (..., H/cell, W/cell, cell*cell)``."""
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // cell, cell, w // cell, cell)
    return x.movedim(-3, -2).reshape(*lead, h // cell, w // cell, cell * cell)


def depth_to_space(x: torch.Tensor, cell: int) -> torch.Tensor:
    """``(..., Hc, Wc, cell*cell) -> (..., Hc*cell, Wc*cell)``; inverse of
    :func:`space_to_depth`."""
    *lead, hc, wc, cc = x.shape
    if cc != cell * cell:
        raise ValueError(f"last axis {cc} != cell*cell = {cell * cell}")
    x = x.reshape(*lead, hc, wc, cell, cell)
    return x.movedim(-2, -3).reshape(*lead, hc * cell, wc * cell)


def restore_prob_map(prob: torch.Tensor, cell: int) -> torch.Tensor:
    """``(B, Hc, Wc, 65) -> (B, H, W)``: drop the dustbin, depth-to-space."""
    return depth_to_space(prob[..., :-1], cell)


def make_points_labels_batch(
    points: torch.Tensor,
    valid: torch.Tensor,
    gen: Optional[torch.Generator],
    img_h: int,
    img_w: int,
    cell: int,
    noise: Optional[torch.Tensor] = None,
    shard: Tuple[int, int] = (0, 1),
) -> torch.Tensor:
    """Encode padded point sets into per-cell 65-class labels
    (`labels.py:46-91`): paint score 2 at point pixels, space-to-depth, add
    a dustbin plane of score 1, and argmax with a small uniform noise that
    breaks ties when a cell holds several points.

    ``points (B, P, 2)`` float ``(y, x)``; ``valid (B, P)`` bool: padded and
    out-of-image entries are dropped.  The tie-break noise in [0, 0.1),
    ``(B, Hc, Wc, 65)``, is drawn from ``gen`` (on its device) unless
    ``noise`` is given; ``shard = (index, count)`` draws it for a global
    batch of ``count * B`` rows and keeps rows ``[index * B, (index + 1) *
    B)``, this rank's (`parallel/collectives.py::shard`).  Returns ``(B, Hc,
    Wc)`` int64 labels in [0, 64].
    """
    b = points.shape[0]
    dev = points.device
    ys = points[..., 0].to(torch.int64)      # truncates toward zero, as astype
    xs = points[..., 1].to(torch.int64)
    keep = valid & (ys >= 0) & (ys < img_h) & (xs >= 0) & (xs < img_w)
    # dropped entries land in one extra slot past the map
    flat = torch.where(keep, ys * img_w + xs, img_h * img_w)
    point_map = torch.zeros((b, img_h * img_w + 1), dtype=torch.float32, device=dev)
    point_map.scatter_(1, flat, 2.0)
    cells = space_to_depth(point_map[:, :-1].reshape(b, img_h, img_w), cell)
    cells = torch.cat([cells, torch.ones_like(cells[..., :1])], dim=-1)
    if noise is None:
        index, count = shard
        noise = 0.1 * torch.rand((count * b,) + cells.shape[1:], generator=gen,
                                 device=gen.device, dtype=torch.float32
                                 )[index * b:(index + 1) * b].to(dev)
    return (cells + noise).argmax(dim=-1)


def make_points_labels(points, valid, gen, img_h, img_w, cell, noise=None):
    """One point set ``(P, 2)`` / ``(P,)`` -> ``(Hc, Wc)`` labels."""
    return make_points_labels_batch(
        points[None], valid[None], gen, img_h, img_w, cell,
        None if noise is None else noise[None],
    )[0]


def make_prob_map_from_labels(labels: torch.Tensor, cell: int) -> torch.Tensor:
    """One-hot decode: labels ``(B, Hc, Wc)`` -> prob map ``(B, H, W)`` with
    1.0 at encoded point pixels."""
    one_hot = torch.nn.functional.one_hot(labels, cell * cell + 1)
    return restore_prob_map(one_hot.to(torch.float32), cell)


def scale_valid_map(mask: torch.Tensor, cell: int) -> torch.Tensor:
    """Full-resolution mask ``(..., H, W)`` -> per-cell binary mask ``(...,
    Hc, Wc)``: a cell is valid if any of its pixels is valid."""
    cells = space_to_depth(mask.to(torch.float32), cell)
    return (cells.sum(dim=-1) > 0.0).to(torch.float32)
