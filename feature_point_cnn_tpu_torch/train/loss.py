"""Training losses: detector position loss + hinge descriptor loss
(`feature_point_cnn_tpu/train/loss.py`).

The hinge descriptor loss contracts every original cell against every
warped cell.  On CUDA tensors it goes through the hand-written kernels of
`ops/kernels/descriptor_loss.py`, which keep every ``(B, N, N)`` tensor
out of device memory in both directions; their plain version, the
materialised computation, serves CPU tensors.

Under a data group (`parallel/collectives.py`) each rank holds its rows of
the global batch, and every loss returns its rank's SHARE of the global
mean: the numerator over the local rows, the divisor counted over the whole
global batch (one all-reduce of the count where it depends on the data).
The shares of all ranks sum to the one-process loss on the global batch,
and so do their gradients.

Under a width group (`parallel/spatial.py`) each rank holds a block of
cell columns of every item, and the same sums run over the width group
(`collectives.group`).  A detector loss's share is the rank's cells, the
divisor counted over the width group.  A descriptor loss pairs every cell
of an item with every warped cell, and the hinge normalises over whole
rows and columns of those pairs, so a block of cells cannot compute its
share: `global_loss` gathers both views' descriptor maps whole (one exact
sum each, whose backward returns each rank its columns of the gradient)
and gives rank ``r`` of ``d`` the items ``r, r + d, ...``, as a data group
gives each rank its rows.  Every item's N x N work then runs on one rank,
through the kernels on the card; a rank left with no items (a batch
smaller than ``d``) still takes part in every sum, and its zero share
keeps its gathers in the backward.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.device import constant
from feature_point_cnn_tpu_torch.geometry.homography import warp_points
from feature_point_cnn_tpu_torch.ops.kernels.descriptor_loss import hinge_descriptor_loss_cuda
from feature_point_cnn_tpu_torch.parallel import spatial
from feature_point_cnn_tpu_torch.parallel.collectives import all_sum_, group, shard


def _masked_mean(losses: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        if group() is None:
            return losses.mean()
        if spatial.group() is not None:
            # a width group's blocks of cells, counted
            count = constant((float(losses.numel()),), losses.device)
            return losses.sum() / all_sum_(count)[0]
        # the data ranks' shards are equal, so the global count is a product
        return losses.sum() / float(losses.numel() * shard()[1])
    mask = mask.to(losses.dtype)
    return (losses * mask).sum() / all_sum_(mask.sum()).clamp_min(1.0)


def detector_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    valid_mask: Optional[torch.Tensor],
    cell: int,
    kind: str = "ce",
    hard_assignment: bool = False,
) -> torch.Tensor:
    """Detector head loss (`loss.py:43-95`).

    ``logits (B, Hc, Wc, 65)``; ``targets (B, Hc, Wc)`` int labels in [0,
    64]; ``valid_mask`` optional ``(B, Hc, Wc)`` in {0, 1}.  ``kind``:
    ``"ce"`` (cross-entropy) or ``"distance"`` (squared cell-grid distance
    between the soft-argmax position and the target; CE on dustbin targets).
    ``hard_assignment`` takes the non-differentiable argmax position.
    """
    logits = logits.to(torch.float32)
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, targets[..., None])[..., 0]
    if kind == "ce":
        return _masked_mean(ce, valid_mask)

    warnings.warn(
        "detector_loss kind='distance' constrains only the soft-argmax "
        "position; cell confidences collapse below the fixed 0.015 "
        "operating threshold after convergence. Prefer kind='ce'.",
        stacklevel=2,
    )
    probs = logp.exp()
    idx = torch.arange(logits.shape[-1], dtype=torch.float32, device=logits.device)
    h_of = torch.floor(idx / cell)           # dustbin (64) -> (8, 0)
    w_of = idx - h_of * cell
    if hard_assignment:
        pred = probs.argmax(dim=-1).to(torch.float32)
        h_pred = torch.floor(pred / cell)
        w_pred = pred - h_pred * cell
    else:
        h_pred = probs @ h_of
        w_pred = probs @ w_of
    t = targets.to(torch.float32)
    h_t = torch.floor(t / cell)
    w_t = t - h_t * cell
    dist = ((h_t - h_pred) ** 2 + (w_t - w_pred) ** 2) / float(cell * cell)
    return _masked_mean(torch.where(targets >= cell * cell, ce, dist), valid_mask)


def _l2_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x * rsqrt(sum x^2 + 1e-12)``: `F.normalize` in value for healthy
    rows, with bounded gradients at exactly-zero rows (`loss.py:98-109`)."""
    return x * torch.rsqrt((x * x).sum(dim=dim, keepdim=True) + 1e-12)


def _cell_centers(hc: int, wc: int, cell: int, device) -> torch.Tensor:
    """``(N, 2)`` float ``(y, x)`` centers of the cells, row-major."""
    ys, xs = torch.meshgrid(torch.arange(hc, device=device),
                            torch.arange(wc, device=device), indexing="ij")
    return (torch.stack([ys, xs], dim=-1).reshape(-1, 2).to(torch.float32) * cell
            + cell // 2)


def _cell_mask(valid_mask, b: int, n: int, device) -> torch.Tensor:
    if valid_mask is None:
        return torch.ones((b, n), dtype=torch.float32, device=device)
    return valid_mask.reshape(b, n).to(torch.float32)


def descriptor_loss(
    desc: torch.Tensor,
    warped_desc: torch.Tensor,
    homographies: torch.Tensor,
    valid_mask: Optional[torch.Tensor],
    config: SuperPointConfig,
) -> torch.Tensor:
    """Hinge descriptor loss over all cell pairs (`loss.py:112-182`).

    ``desc`` / ``warped_desc``: ``(B, Hc, Wc, D)`` raw descriptors;
    ``homographies (B, 8)`` of the warped view; ``valid_mask`` optional
    ``(B, Hc, Wc)`` per-cell mask of the warped view.
    """
    b, hc, wc, dd = desc.shape
    n = hc * wc
    d = _l2_normalize(desc.reshape(b, n, dd).to(torch.float32), dim=-1)
    wd = _l2_normalize(warped_desc.reshape(b, n, dd).to(torch.float32), dim=-1)

    # cell-center i warped into the warped frame corresponds to cell-center
    # j when it lands within (cell - 0.5) px of it
    centers = _cell_centers(hc, wc, config.cell, desc.device)
    warped_centers = warp_points(centers, homographies)        # (B, N, 2)
    mask = _cell_mask(valid_mask, b, n, desc.device)
    normalization = (all_sum_(mask.sum()) * float(n)).clamp_min(1.0)

    if b == 0:      # a width rank with no items: the kernels refuse B = 0
        return (d.sum() + wd.sum()) * 0.0
    raw = hinge_descriptor_loss_cuda(
        d, wd, warped_centers, centers, mask, config.lambda_d,
        config.positive_margin, config.negative_margin, config.cell)
    return raw / normalization


def descriptor_hinge_hn_loss(
    desc: torch.Tensor,
    warped_desc: torch.Tensor,
    homographies: torch.Tensor,
    valid_mask: Optional[torch.Tensor],
    config: SuperPointConfig,
) -> torch.Tensor:
    """Hard-negative-mined hinge on plain cosine similarities
    (`loss.py:185-269`): per cell, in each direction, only the
    ``desc_hn_topk`` hardest non-corresponding cells contribute; positive
    and mined-negative terms are each averaged over their own pair counts.
    Mining needs the full similarity matrix, so this loss materialises
    ``(B, N, N)`` tensors."""
    b, hc, wc, dd = desc.shape
    n = hc * wc
    cell = config.cell
    k = min(config.desc_hn_topk, n - 1)

    d = _l2_normalize(desc.reshape(b, n, dd).to(torch.float32), dim=-1)
    wd = _l2_normalize(warped_desc.reshape(b, n, dd).to(torch.float32), dim=-1)
    dot = torch.einsum("bid,bjd->bij", d, wd)

    centers = _cell_centers(hc, wc, cell, desc.device)
    warped_centers = warp_points(centers, homographies)
    sq = ((warped_centers ** 2).sum(-1)[:, :, None]
          + (centers ** 2).sum(-1)[None, None, :]
          - 2.0 * torch.einsum("bik,jk->bij", warped_centers, centers))
    s = (sq < (cell - 0.5) ** 2).to(torch.float32)             # (B, N, N)

    mask = _cell_mask(valid_mask, b, n, desc.device)
    pair_ok = s * mask[:, None, :]
    pos = torch.relu(config.positive_margin - dot)
    pos_term = (pos * pair_ok).sum() / all_sum_(pair_ok.sum()).clamp_min(1.0)

    neg = torch.relu(dot - config.negative_margin)
    # correspondences and masked warped cells leave the mining pool
    neg = torch.where((s > 0.0) | (mask[:, None, :] == 0.0), -torch.inf, neg)
    hard = torch.cat([neg.topk(k, dim=2).values,
                      neg.transpose(1, 2).topk(k, dim=2).values], dim=-1)
    finite = torch.isfinite(hard)
    neg_term = (torch.where(finite, hard, 0.0).sum()
                / all_sum_(finite.sum().to(torch.float32)).clamp_min(1.0))
    return config.lambda_hn * (pos_term + neg_term)


def descriptor_mse_loss(
    desc: torch.Tensor,
    warped_desc: torch.Tensor,
    homographies: torch.Tensor,
    config: SuperPointConfig,
) -> torch.Tensor:
    """Correspondence-MSE descriptor loss (`loss.py:272-311`): each cell
    against its warped counterpart cell; out-of-image correspondences are
    left out of the mean."""
    b, hc, wc, dd = desc.shape
    cell = config.cell
    centers = _cell_centers(hc, wc, cell, desc.device)
    warped_centers = warp_points(centers, homographies)        # (B, N, 2)

    limit = constant((hc * cell, wc * cell), desc.device) - 1.0
    inlier = ((warped_centers >= 0.0) & (warped_centers <= limit)).all(dim=-1)
    cell_idx = ((warped_centers - cell // 2) / cell).to(torch.int64)
    cy = cell_idx[..., 0].clamp(0, hc - 1)
    cx = cell_idx[..., 1].clamp(0, wc - 1)
    flat_idx = cy * wc + cx                                    # (B, N)

    d = desc.reshape(b, hc * wc, dd).to(torch.float32)
    wd = warped_desc.reshape(b, hc * wc, dd).to(torch.float32)
    wd_at = wd.gather(1, flat_idx[..., None].expand(-1, -1, dd))
    sq = ((d - wd_at) ** 2).sum(dim=-1) * inlier
    return sq.sum() / (all_sum_(inlier.sum().to(torch.float32)) * dd).clamp_min(1.0)


def _own_items(desc, warped_desc, homographies, valid_mask):
    """Under a width group: both views' descriptor maps and the mask
    gathered whole along Wc, and of them and of the homographies this
    rank's items ``r, r + d, ...``."""
    rank, size = spatial.split()
    mine = slice(rank, None, size)
    if valid_mask is not None:
        valid_mask = spatial.gather_width(valid_mask, 2)[mine]
    return (spatial.gather_width(desc, 2)[mine],
            spatial.gather_width(warped_desc, 2)[mine], homographies[mine], valid_mask)


def global_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    warped_logits: torch.Tensor,
    warped_targets: torch.Tensor,
    desc: torch.Tensor,
    warped_desc: torch.Tensor,
    homographies: torch.Tensor,
    valid_mask: Optional[torch.Tensor],
    config: SuperPointConfig,
) -> Dict[str, torch.Tensor]:
    """Joint SuperPoint loss (`loss.py:314-344`): detector on the normal
    view (unmasked), detector on the warped view (masked), descriptor.
    Under a width group every ``(B, Hc, Wc, ...)`` argument is this rank's
    block of cell columns and ``homographies`` is whole."""
    det = detector_loss(logits, targets, None, config.cell, config.detector_loss)
    warped_det = detector_loss(
        warped_logits, warped_targets, valid_mask, config.cell, config.detector_loss
    )
    if spatial.group() is not None:
        desc, warped_desc, homographies, valid_mask = _own_items(
            desc, warped_desc, homographies, valid_mask)
    if config.descriptor_loss == "mse":
        desc_l = descriptor_mse_loss(desc, warped_desc, homographies, config)
    elif config.descriptor_loss == "hinge_hn":
        desc_l = descriptor_hinge_hn_loss(
            desc, warped_desc, homographies, valid_mask, config
        )
    else:
        desc_l = descriptor_loss(desc, warped_desc, homographies, valid_mask, config)
    return {
        "detector": det,
        "warped_detector": warped_det,
        "descriptor": desc_l,
        "total": det + warped_det + desc_l,
    }
