"""Seeded polygon scenes: the benchmark's frames and training split.

Copied from the port's chip smoke script (``polygon_scene``,
``shifted_pair``) so that a later change to the program cannot change the
inputs the benchmark measures with.  Everything is drawn with numpy from
the run's seed; the same seed gives the same frames.
"""

from __future__ import annotations

import numpy as np


def polygon_scene(rng: np.random.Generator, h: int, w: int,
                  n_polygons: int = 40, return_points: bool = False):
    """A ``(h, w)`` float32 image in [0, 1]: a shaded background with
    random filled polygons (3-7 vertices) of random grey levels.  With
    ``return_points`` also the ``(N, 2)`` ``(y, x)`` corner points: the
    polygons' vertices that lie in the image and that no later polygon
    covers."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.3 + 0.2 * (xx / w) * rng.random() + 0.2 * (yy / h) * rng.random()
    corners = np.zeros((0, 2), np.float32)
    for _ in range(n_polygons):
        n = int(rng.integers(3, 8))
        cy, cx = rng.random() * h, rng.random() * w
        rad = (0.04 + 0.12 * rng.random()) * min(h, w)
        ang = np.sort(rng.random(n) * 2 * np.pi)
        r = rad * (0.5 + 0.5 * rng.random(n))
        vy, vx = cy + r * np.sin(ang), cx + r * np.cos(ang)
        y0, y1 = max(int(vy.min()), 0), min(int(vy.max()) + 1, h)
        x0, x1 = max(int(vx.min()), 0), min(int(vx.max()) + 1, w)
        if y0 >= y1 or x0 >= x1:
            continue
        py, px = yy[y0:y1, x0:x1] + 0.5, xx[y0:y1, x0:x1] + 0.5
        inside = np.zeros(py.shape, bool)
        for i in range(n):  # even-odd crossing rule
            ay, ax, by, bx = vy[i], vx[i], vy[i - 1], vx[i - 1]
            crosses = (ay > py) != (by > py)
            xcross = ax + (py - ay) * (bx - ax) / (by - ay + 1e-12)
            inside ^= crosses & (px < xcross)
        img[y0:y1, x0:x1][inside] = rng.random()
        if return_points:
            cy_, cx_ = corners[:, 0].astype(int), corners[:, 1].astype(int)
            inbox = (cy_ >= y0) & (cy_ < y1) & (cx_ >= x0) & (cx_ < x1)
            covered = np.zeros(len(corners), bool)
            covered[inbox] = inside[cy_[inbox] - y0, cx_[inbox] - x0]
            new = np.stack([vy, vx], -1).astype(np.float32)
            new = new[(vy >= 0) & (vy <= h - 1) & (vx >= 0) & (vx <= w - 1)]
            corners = np.concatenate([corners[~covered], new])
    img = np.clip(img, 0.0, 1.0).astype(np.float32)
    return (img, corners) if return_points else img


def shifted_frames(seed: int, scenes: int, shifts, h: int, w: int) -> np.ndarray:
    """``(scenes * len(shifts), h, w, 1)`` uint8 gray frames: each scene
    seen through ``len(shifts)`` windows, content at x in the first lying
    at x - shift in the others, scene-major."""
    rng = np.random.default_rng(seed)
    wide = w + max(shifts)
    out = np.empty((scenes, len(shifts), h, w, 1), np.uint8)
    for s in range(scenes):
        u8 = np.round(polygon_scene(rng, h, wide) * 255).astype(np.uint8)
        for j, dx in enumerate(shifts):
            out[s, j, :, :, 0] = u8[:, dx:dx + w]
    return out.reshape(-1, h, w, 1)


def scene_split(seed: int, size: int, h: int, w: int, max_points: int,
                n_polygons: int = 20):
    """A training split of ``size`` gray scenes with their corners:
    ``images (size, h, w, 1)`` uint8, ``points (size, max_points, 2)``
    float32 ``(y, x)`` (zero-padded) and ``counts (size,)`` int32."""
    rng = np.random.default_rng(seed)
    images = np.empty((size, h, w, 1), np.uint8)
    points = np.zeros((size, max_points, 2), np.float32)
    counts = np.zeros(size, np.int32)
    for i in range(size):
        img, pts = polygon_scene(rng, h, w, n_polygons, return_points=True)
        images[i, :, :, 0] = np.round(img * 255).astype(np.uint8)
        k = min(len(pts), max_points)
        points[i, :k] = pts[:k]
        counts[i] = k
    return images, points, counts


def batches(seed: int, pool: int, batch: int, count: int) -> np.ndarray:
    """``(count, batch)`` pool indices: consecutive permutations of the
    pool cut into batches, so no frame repeats inside a batch."""
    rng = np.random.default_rng([seed, 1])
    need = count * batch
    order = np.concatenate([rng.permutation(pool) for _ in range(-(-need // pool))])
    return order[:need].reshape(count, batch)
