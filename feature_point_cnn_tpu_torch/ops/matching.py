"""Mutual-nearest-neighbour matching (`feature_point_cnn_tpu/ops/
matching.py:36-78`).

Descriptors are unit-norm, so ``L2^2 = 2 - 2 dot``: the best dot product is
the nearest neighbour, and a distance gate ``t`` is the similarity gate
``sim >= 1 - t^2/2``.  The K x K similarity product is a plain
``torch.matmul`` (float32), as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Matches(NamedTuple):
    """Matches from set A to set B; tensors ``(..., Ka)`` over A's slots."""

    index: torch.Tensor       # (..., Ka) int32: matched index in B (0 if invalid)
    similarity: torch.Tensor  # (..., Ka) float32 dot product
    valid: torch.Tensor       # (..., Ka) bool

    @property
    def num(self) -> torch.Tensor:
        return self.valid.sum(-1)

    def l2_distance(self) -> torch.Tensor:
        """The L2 distance of unit descriptors, ``sqrt(2 - 2 similarity)``."""
        return torch.sqrt(torch.clamp(2.0 - 2.0 * self.similarity, min=0.0))


def mnn_match(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    max_l2_dist: Optional[float] = None,
    cross_check: bool = True,
) -> Matches:
    """``desc_a (..., Ka, D)`` against ``desc_b (..., Kb, D)`` (leading axes
    broadcast, so a batch of frames can match one keyframe).  Ties go to
    the lower index, as ``jnp.argmax``."""
    sim = torch.matmul(desc_a.float(), desc_b.float().transpose(-1, -2))
    both = valid_a[..., :, None] & valid_b[..., None, :]
    sim = sim.masked_fill(~both, float("-inf"))

    best_b = sim.argmax(-1)                                   # (..., Ka)
    best_sim = sim.amax(-1)
    ok = valid_a & torch.isfinite(best_sim)
    if cross_check:
        best_a_of_b = sim.argmax(-2)                          # (..., Kb)
        ka = desc_a.shape[-2]
        mutual = torch.gather(best_a_of_b, -1, best_b) == torch.arange(
            ka, device=sim.device
        )
        ok = ok & mutual
    if max_l2_dist is not None:
        ok = ok & (best_sim >= 1.0 - 0.5 * max_l2_dist * max_l2_dist)
    return Matches(
        index=torch.where(ok, best_b, 0).to(torch.int32),
        similarity=torch.where(ok, best_sim, 0.0),
        valid=ok,
    )
