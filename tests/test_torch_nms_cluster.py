"""PyTorch port: the cluster design of the NMS kernel, emulated on the CPU.

`csrc/grid_nms.cu` runs exact-greedy NMS in one launch: a cluster of C CTAs
holds a frame, CTA k a band of rows ``[k*H//C, (k+1)*H//C)``; each round
reads the r halo rows above and below from the neighbouring bands, marks
winners (flags ``kKept | round % 128``), zeroes their windows, and reduces
"any candidate left" over the cluster, capped at H*W rounds.  Rows that
cannot matter are skipped by activity bits per (row, 128-column strip):
any pixel, any in the strip's first / last 8 columns.  `banded_nms` below
repeats that schedule with torch ops (bands, halos, the activity skips, the
round tags, the window max by log-step doubling) and is held exactly
against `grid_nms_plain` and the JAX package's `grid_nms_pallas` (interpret
mode).  The kernel itself is held against `grid_nms_plain` on the card
(`tests/test_torch_cuda_kernels.py`, `chip_smoke.py` phase 3).

The layout function `nms_layout` is checked over every shape the smoke and
the CUDA tests use.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.ops.pallas.nms import grid_nms_pallas
from tests.test_detection import _plateau_maps, _random_scores

from feature_point_cnn_tpu_torch.ops.kernels.nms import (
    grid_nms_plain,
    nms_layout,
    nms_priority_key,
    plain_rounds,
)

KEPT = 0x80
ANY, FIRST, LAST = 1, 2, 4
EDGE = 8          # columns an edge bit covers; the window radius is <= 7


def _running_max(x: torch.Tensor, radius: int, dim: int) -> torch.Tensor:
    """Centered window max of width 2r+1 along ``dim`` of a map padded with
    r zeros (values are >= 0), in ceil(log2(2r+1)) shift-and-max steps."""
    m = 2 * radius + 1
    covered = 1
    while covered < m:
        step = min(covered, m - covered)
        shifted = torch.cat([x.narrow(dim, step, x.shape[dim] - step),
                             torch.zeros_like(x.narrow(dim, 0, step))], dim)
        x = torch.maximum(x, shifted)
        covered += step
    return x.narrow(dim, 0, x.shape[dim] - 2 * radius)


def _activity(rows: torch.Tensor, strip: int) -> torch.Tensor:
    """(rows, strips) activity bits of a boolean (rows, W) map."""
    h, w = rows.shape
    n = -(-w // strip)
    pad = torch.zeros((h, n * strip), dtype=torch.bool)
    pad[:, :w] = rows
    s = pad.view(h, n, strip)
    return (s.any(-1) * ANY + s[..., :EDGE].any(-1) * FIRST
            + s[..., -EDGE:].any(-1) * LAST).to(torch.uint8)


def banded_nms(scores: torch.Tensor, radius: int, clusters: int,
               strip: int = 128, tag_mod: int = 128):
    """One frame ``(H, W)`` through the kernel's schedule: returns the kept
    scores and the rounds."""
    h, w = scores.shape
    r = radius
    bounds = [(k * h // clusters, (k + 1) * h // clusters) for k in range(clusters)]
    assert clusters == 1 or min(b - a for a, b in bounds) >= max(r, 1)
    key = nms_priority_key(scores[None], r)[0].clone()
    flags = torch.zeros((h, w), dtype=torch.uint8)
    cand = _activity(key > 0, strip)              # per row, per strip
    won_act = torch.zeros_like(cand)
    nstrips = cand.shape[1]

    def halo(k):
        """Rows [ys - r, ye + r) of band k: its own, r from each neighbour
        band (never further), zeros outside the map."""
        ys, ye = bounds[k]
        lo, hi = max(ys - r, 0), min(ye + r, h)
        if lo < ys:
            assert lo >= bounds[k - 1][0]
        if hi > ye:
            assert hi <= bounds[k + 1][1]
        return lo, hi, ys - r, ye + r

    def relevant(act, lo, hi, top, bottom):
        """(rows, strips) input relevance: activity in the strip or in a
        neighbour strip's edge, 0 for rows outside the map."""
        rel = torch.zeros((bottom - top, nstrips), dtype=torch.bool)
        a = act[lo:hi]
        own = (a & ANY) > 0
        left = torch.zeros_like(own)
        left[:, 1:] = (a[:, :-1] & LAST) > 0
        right = torch.zeros_like(own)
        right[:, :-1] = (a[:, 1:] & FIRST) > 0
        rel[lo - top:hi - top] = own | left | right
        return rel

    def window_max(vals, lo, hi, top, bottom, rel, ys, ye):
        """(ye-ys, W) window max from the rows [top, bottom) of ``vals``:
        a strip's horizontal max of a row it finds irrelevant is zeros, as
        the kernel pushes them without a load."""
        block = torch.zeros((bottom - top, w + 2 * r))
        block[lo - top:hi - top, r:r + w] = vals[lo:hi]
        horiz = _running_max(block, r, 1)
        horiz = horiz * rel.repeat_interleave(strip, 1)[:, :w]
        return _running_max(horiz, r, 0)

    rounds = 0
    while bool((cand & ANY).any()) and rounds < h * w:
        tag = KEPT | (rounds % tag_mod)
        new_won = torch.zeros_like(won_act)
        for k, (ys, ye) in enumerate(bounds):        # pass A
            lo, hi, top, bottom = halo(k)
            m = window_max(key, lo, hi, top, bottom,
                           relevant(cand, lo, hi, top, bottom), ys, ye)
            has = ((cand[ys:ye] & ANY) > 0).repeat_interleave(strip, 1)[:, :w]
            band = key[ys:ye]
            won = has & (band > 0) & (band == m)
            flags[ys:ye][won] = tag
            new_won[ys:ye] = _activity(won, strip)
        won_act = new_won
        left = []
        new_cand = cand.clone()
        for k, (ys, ye) in enumerate(bounds):        # pass B
            lo, hi, top, bottom = halo(k)
            winners = (flags == tag).float()
            rel = relevant(won_act, lo, hi, top, bottom)
            dead = window_max(winners, lo, hi, top, bottom, rel, ys, ye) > 0
            key[ys:ye][dead] = 0.0
            left.append(bool((key[ys:ye] > 0).any()))
            new_cand[ys:ye] = _activity(key[ys:ye] > 0, strip)
        cand = new_cand
        rounds += 1
        if not any(left):                            # the cluster-wide flag
            break
    kept = (flags & KEPT) > 0
    return torch.where(kept, scores, 0.0), rounds


def _inputs(kind: str, h: int, w: int, rng) -> np.ndarray:
    if kind.startswith("random"):
        dens = float(kind.split("_")[1])
        vals = rng.random((h, w)).astype(np.float32) * 0.9 + 0.05
        vals[rng.random((h, w)) >= dens] = 0.0
        return vals
    if kind == "ramp":
        return (np.arange(h * w, dtype=np.float32).reshape(h, w) / (h * w) * 0.9
                + 0.05)
    plate = np.zeros((h, w), np.float32)
    if kind == "plateau_block":
        plate[4:h - 6, 6:w - 10] = 0.25
    elif kind == "plateau_checker":
        plate[::2, ::2] = 0.9
    elif kind == "plateau_flat":
        plate[:] = 0.015
    return plate


KINDS = ["random_0.02", "random_0.3", "random_1.0", "ramp", "plateau_block",
         "plateau_checker", "plateau_flat"]


@pytest.mark.parametrize("clusters", [1, 2, 8])
@pytest.mark.parametrize("radius", [0, 1, 4, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_banded_schedule_matches_plain_exactly(kind, radius, clusters):
    """Bands exactly max(r, 1) rows tall at C = 8 (the shortest the layout
    allows), taller at C = 1 and 2; W = 40 is two strips of 16 columns plus
    a ragged one, so the strip edges and the neighbour edges matter."""
    rng = np.random.default_rng(7 * radius + clusters)
    h = clusters * max(radius, 1) if clusters == 8 else 24
    scores = torch.from_numpy(_inputs(kind, h, 40, rng))
    got, rounds = banded_nms(scores, radius, clusters, strip=16)
    want = grid_nms_plain(scores[None], radius)[0]
    assert torch.equal(got, want)
    assert rounds == plain_rounds(scores[None], radius)[0]


@pytest.mark.parametrize("radius", [1, 4, 7])
@pytest.mark.parametrize("side", ["right", "left"])
def test_banded_neighbour_strip_edge_decides(side, radius):
    """A candidate next to a strip boundary is suppressed by a larger one
    across it, r rows up in the band above, in a row where its own strip
    holds nothing: only the neighbour strip's edge bit makes that row count
    (strips of 16 columns, bands of 8 rows)."""
    scores = torch.zeros((16, 48))
    a, b = (15, 16) if side == "right" else (16, 15)
    scores[8, a] = 0.5
    scores[8 - radius, b] = 0.9
    got, rounds = banded_nms(scores, radius, 2, strip=16)
    want = grid_nms_plain(scores[None], radius)[0]
    assert torch.equal(got, want)
    assert got[8, a] == 0 and got[8 - radius, b] == 0.9
    assert rounds == plain_rounds(scores[None], radius)[0]


@pytest.mark.parametrize("strip", [16, 128])
def test_banded_round_tags_may_wrap(strip):
    """The ramp needs more rounds than a tag of 2 bits tells apart: a
    winner's tag seen again marks a window zeroed long before, so the
    result stands."""
    scores = torch.from_numpy(_inputs("ramp", 32, 48, None))
    got, rounds = banded_nms(scores, 4, 8, strip=strip, tag_mod=4)
    assert rounds > 8
    assert torch.equal(got, grid_nms_plain(scores[None], 4)[0])
    assert rounds == plain_rounds(scores[None], 4)[0]


@pytest.mark.parametrize("which", range(6))
def test_banded_matches_pallas_interpret(rng, which):
    """Against the JAX package's TPU kernel in interpret mode, at 48x64:
    random maps of two densities, and the four plateau maps of its tests."""
    maps = [_random_scores(rng, 0.05), _random_scores(rng, 0.3)] + _plateau_maps()
    scores = maps[which]
    pallas = np.asarray(grid_nms_pallas(jnp.asarray(scores[None]), 4, interpret=True))[0]
    got, _ = banded_nms(torch.from_numpy(scores), 4, nms_layout(*scores.shape, 4).cluster)
    np.testing.assert_array_equal(got.numpy(), pallas)


# every (H, W, r) of chip_smoke.py and tests/test_torch_cuda_kernels.py
SHAPES_IN_USE = [(480, 640, 4), (1080, 1920, 4), (120, 168, 4), (37, 50, 4),
                 (9, 11, 4), (480, 642, 0), (480, 642, 1), (480, 642, 7),
                 (1081, 1922, 4)] + [(64, 96, r) for r in range(8)]


@pytest.mark.parametrize("h,w,radius", SHAPES_IN_USE,
                         ids=lambda v: str(v))
def test_layout_of_shapes_in_use(h, w, radius):
    lay = nms_layout(h, w, radius)
    assert lay.cluster in (1, 2, 4, 8)
    assert lay.rows_per_band == -(-h // lay.cluster)
    bands = [(k + 1) * h // lay.cluster - k * h // lay.cluster for k in range(lay.cluster)]
    assert max(bands) == lay.rows_per_band
    assert lay.cluster == 1 or min(bands) >= max(radius, 1)
    assert lay.smem_bytes <= 232448
    strips = -(-w // 128)
    act = -(-4 * lay.rows_per_band * strips // 16) * 16
    state = 5 * lay.rows_per_band * w
    assert lay.smem_bytes == 64 + act + (state if lay.band_in_shared else 0)
    assert lay.band_in_shared == (64 + act + state <= 232448)
    if (h, w) == (480, 640):
        assert lay == (8, 60, 193264, True)
    if h > 1000:
        assert lay.cluster == 8 and not lay.band_in_shared
    if (h, w) == (480, 642):
        assert lay.band_in_shared


def test_layout_halves_the_cluster_for_short_maps():
    assert nms_layout(56, 64, 7).cluster == 8       # bands of 7 rows
    assert nms_layout(55, 64, 7).cluster == 4
    assert nms_layout(13, 64, 7).cluster == 1
    assert nms_layout(8, 8, 0).cluster == 8          # r = 0 still wants a row a band
