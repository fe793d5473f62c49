"""65-way cell label codec: the decode half (`feature_point_cnn_tpu/ops/
labels.py:27-43,94-100`).  Within a cell, class index = ``dy * cell + dx``
(row-major); class 64 is the dustbin."""

from __future__ import annotations

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
