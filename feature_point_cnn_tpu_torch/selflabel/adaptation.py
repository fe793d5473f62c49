"""Homography adaptation: self-labels from detections aggregated over
random warps (`feature_point_cnn_tpu/selflabel/adaptation.py:39-149`).

Per batch: the base forward, then ``num`` warps of every image in ONE
forward over all ``num * B`` views; each view's map is masked by the eroded
warped-ones mask, warped back with the inverse homography and weighted by
the eroded coverage count; the maps are summed (or maxed) with the base
map and zeroed where fewer than ``num // 3`` views saw the pixel.

Random draws come from `torch.Generator`s, which cannot repeat
`jax.random`'s.  So the deterministic core, `_adapt_with_homographies`,
takes the warps as given; the tests hold it to the JAX function on the same
warps.  The stages it runs are separate functions so a caller can time
them one by one.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

import torch

from feature_point_cnn_tpu_torch.config import HomographyConfig
from feature_point_cnn_tpu_torch.geometry.homography import (
    erode,
    invert_homography,
    sample_homography_batch,
)
from feature_point_cnn_tpu_torch.geometry.warp import warp_image

Generators = Union[torch.Generator, Sequence[torch.Generator]]


def _is_per_item_keys(gen: Generators) -> bool:
    """True for a sequence of per-image generators, False for one
    generator shared by the whole batch."""
    return not isinstance(gen, torch.Generator)


def sample_warps(gen: Generators, batch: int, shape: Tuple[int, int],
                 config: HomographyConfig, device) -> torch.Tensor:
    """The warps of one batch: ``(N, 8)`` from one shared generator, or
    ``(N, B, 8)`` from ``B`` per-image generators (each image's warps a
    function of its own generator alone).  Drawn on each generator's
    device, solved on ``device``."""
    n = config.num
    if not _is_per_item_keys(gen):
        return sample_homography_batch(gen, n, shape, config, device)
    gens = list(gen)
    if len(gens) != batch:
        raise ValueError(f"{len(gens)} generators for a batch of {batch}")
    return torch.stack(
        [sample_homography_batch(g, n, shape, config, device) for g in gens], 1)


def warp_masks(hs: torch.Tensor, shape: Tuple[int, int], margin: int):
    """``(mask, count, hs_inv)`` for the warps ``hs`` (``(N, 8)`` or ``(N,
    B, 8)``): the nearest-warped ones of each view (its valid pixels) and of
    each inverse warp (the coverage of the unwarped map), both eroded by
    ``margin``, shaped ``(N, 1, H, W)`` or ``(N, B, H, W)``."""
    lead = hs.shape[:-1]
    flat = hs.reshape(-1, 8)
    hs_inv = invert_homography(flat)
    ones = torch.ones((flat.shape[0],) + tuple(shape) + (1,), dtype=torch.float32,
                      device=hs.device)
    mask = warp_image(ones, flat, "nearest")[..., 0]
    count = warp_image(ones, hs_inv, "nearest")[..., 0]
    if margin:
        mask = erode(mask, margin)
        count = erode(count, margin)
    per_item = hs.dim() == 3
    out_shape = lead + tuple(shape) if per_item else (lead[0], 1) + tuple(shape)
    return (mask.reshape(out_shape), count.reshape(out_shape),
            hs_inv.reshape(lead + (8,)))


def _per_view(hs: torch.Tensor, b: int) -> torch.Tensor:
    """``(N, 8)`` or ``(N, B, 8)`` warps -> one ``(N * B, 8)`` row a view."""
    if hs.dim() == 2:
        hs = hs[:, None].expand(hs.shape[0], b, 8)
    return hs.reshape(-1, 8)


def warp_views(images: torch.Tensor, hs: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, C)`` images -> the ``(N * B, H, W, C)`` bilinear warped
    views, warp-major."""
    b = images.shape[0]
    n = hs.shape[0]
    tiled = images[None].expand((n,) + images.shape).reshape((n * b,) + images.shape[1:])
    return warp_image(tiled, _per_view(hs, b), "bilinear")


def unwarp_and_aggregate(base_prob: torch.Tensor, probs: torch.Tensor,
                         mask: torch.Tensor, count: torch.Tensor,
                         hs_inv: torch.Tensor, config: HomographyConfig
                         ) -> torch.Tensor:
    """Mask the views' maps ``probs (N * B, H, W)``, warp them back, weight
    by the coverage and aggregate with ``base_prob (B, H, W)``."""
    b, h, w = base_prob.shape
    n = config.num
    probs = probs.reshape(n, b, h, w) * mask
    proj = warp_image(probs.reshape(n * b, h, w, 1), _per_view(hs_inv, b),
                      "bilinear").reshape(n, b, h, w)
    proj = proj * count
    all_probs = torch.cat([base_prob[None], proj], 0)           # (N+1, B, H, W)
    all_counts = torch.cat([torch.ones_like(base_prob)[None],
                            count.expand(n, b, h, w)], 0)
    counts_sum = all_counts.sum(0)
    if config.aggregation == "max":
        prob = all_probs.amax(0)
    elif config.aggregation == "sum":
        prob = all_probs.sum(0) / counts_sum.clamp_min(1e-6)
    else:
        raise ValueError(f"unknown aggregation {config.aggregation!r}")
    return torch.where(counts_sum >= config.num // 3, prob, 0.0)


def _adapt_with_homographies(
    images: torch.Tensor,
    hs: torch.Tensor,
    prob_fn: Callable[[torch.Tensor], torch.Tensor],
    config: HomographyConfig,
) -> torch.Tensor:
    """The deterministic core: ``images (B, H, W, C)`` and given warps
    ``hs`` — ``(N, 8)`` shared by the batch or ``(N, B, 8)`` per image —
    -> ``(B, H, W)`` aggregated probabilities."""
    h, w = images.shape[1:3]
    base_prob = prob_fn(images)
    mask, count, hs_inv = warp_masks(hs, (h, w), config.valid_border_margin)
    probs = prob_fn(warp_views(images, hs))
    return unwarp_and_aggregate(base_prob, probs, mask, count, hs_inv, config)


def homography_adaptation(
    gen: Generators,
    images: torch.Tensor,
    prob_fn: Callable[[torch.Tensor], torch.Tensor],
    config: HomographyConfig = HomographyConfig(),
) -> torch.Tensor:
    """Aggregate detection probabilities over ``config.num`` random warps.

    Args:
      gen: ONE generator (every image of the batch sees the same ``num``
        warps, the reference's semantics) or a sequence of ``B`` per-image
        generators: each image gets its own warp set, and its result does
        not depend on which other images share its batch.
      images: ``(B, H, W, C)`` float in [0, 1].
      prob_fn: ``(M, H, W, C) -> (M, H, W)`` detection probability map.

    Returns ``(B, H, W)`` aggregated probabilities.
    """
    b, h, w = images.shape[:3]
    hs = sample_warps(gen, b, (h, w), config, images.device)
    return _adapt_with_homographies(images, hs, prob_fn, config)
