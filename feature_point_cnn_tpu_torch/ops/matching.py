"""Mutual-nearest-neighbour matching (`feature_point_cnn_tpu/ops/
matching.py:36-78`).

Descriptors are unit-norm, so ``L2^2 = 2 - 2 dot``: the best dot product is
the nearest neighbour, and a distance gate ``t`` is the similarity gate
``sim >= 1 - t^2/2``.  The K x K similarity product is a plain
``torch.matmul`` (float32), as the JAX package leaves it to XLA.
`MnnMatcher` is the serving frame's match by it (`FrameRows` against a
keyframe).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn


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


class FrameRows(NamedTuple):
    """A serving frame's top n score-sorted rows, which its matcher takes."""

    valid: torch.Tensor      # (B, N) bool
    packed: torch.Tensor     # (B, N, 3) float32 [y, x, score]
    desc: torch.Tensor       # (B, N, D) float32, zero on invalid rows
    desc16: torch.Tensor     # (B, N, D) float16 of ``desc``
    num_valid: torch.Tensor  # (B,) int32


class MnnMatcher(nn.Module):
    """The serving frame's `mnn_match` (within ``max_l2_dist``) of each
    frame's float32 rows against the keyframe's float16 descriptors, of
    which the first ``key_num`` are valid; no outputs beyond the frame's."""

    extra_outputs: Tuple[str, ...] = ()

    def __init__(self, max_keypoints: int, max_l2_dist: float):
        super().__init__()
        self.max_l2_dist = max_l2_dist
        # the keyframe's row slots, for key_valid = slots[:N] < key_num
        self.register_buffer("slots", torch.arange(max_keypoints), persistent=False)

    @staticmethod
    def keyframe(n: int, d: int) -> tuple:
        """The keyframe's tensors, ``(name, shape, dtype)`` each."""
        return (("key_desc", (n, d), torch.float16), ("key_num", (), torch.int32))

    def match_frame(self, rows: FrameRows, key: tuple, image_size) -> tuple:
        """``(match_index (B, N) int32, -1 = none,)``."""
        key_desc, key_num = key
        m = mnn_match(rows.desc, rows.valid, key_desc.float(),
                      self.slots[:key_desc.shape[0]] < key_num, max_l2_dist=self.max_l2_dist)
        return (torch.where(m.valid, m.index, -1).to(torch.int32),)
