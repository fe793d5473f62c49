"""VGG SuperPoint + SuperGlue (``family: vgg_superglue``): the detector's
convolutions (`counts/vgg_superpoint.py`) and the matcher's products.

Multiply-adds of one pair of ``n`` frame rows against ``m`` keyframe rows
(the padded widths the program computes at, 1024 each in the cell), with
D = 256, 4 heads and 18 layers (hand counts at n = m = 1024, which the
benchmark's tests hold):

* keypoint encoder, each side: ``3*32 + 32*64 + 64*128 + 128*256 +
  256*256`` a row;
* each GNN layer, each side: the q, k, v and merge projections ``4 D^2``
  and the MLP ``2D*2D + 2D*D`` a row (``10 D^2``), and attention's two
  products ``2 n m D``;
* ``final_proj`` on both sides and the score matrix ``n m D``.

BatchNorm, softmax, the Sinkhorn's 100 iterations (memory-bound passes)
and the matches are not counted.  Per pair: 44.1 G multiply-adds, 88.2
GFLOP, of which attention's products 38.65 GFLOP.
"""

from __future__ import annotations

from typing import List

from port_bench.counts import vgg_superpoint
from port_bench.counts.convs import Conv


def convs(cfg: dict, h: int, w: int) -> List[Conv]:
    return vgg_superpoint.convs(cfg, h, w)


def attention_flops(cfg: dict, n: int, m: int) -> float:
    """FLOPs of attention's two products (``q^T k`` and the weighted
    values) in every layer on both sides of one pair."""
    s = cfg["superglue"]
    d = s["descriptor_dim"]
    return 2.0 * len(s["GNN_layers"]) * (2 * n * m * d + 2 * m * n * d)


def matcher_flops(cfg: dict, n: int, m: int) -> float:
    """FLOPs of SuperGlue's products for one pair: 2 per multiply-add."""
    s = cfg["superglue"]
    d = s["descriptor_dim"]
    widths = [3, *s["keypoint_encoder"], d]
    enc = sum(a * b for a, b in zip(widths, widths[1:])) * (n + m)
    gnn = len(s["GNN_layers"]) * 10 * d * d * (n + m)
    final = d * d * (n + m) + n * m * d
    return 2.0 * (enc + gnn + final) + attention_flops(cfg, n, m)
