"""Synthetic geometric shapes with ground-truth corner points, on the host
(a copy of `feature_point_cnn_tpu/data/synthetic_shapes.py`).

Nine primitive families with known interest points, drawn over blob/blur
backgrounds from one injected `numpy.random.Generator`.  The copy draws
from the generator in the same order as the JAX package's, so the same
seed gives the same images and points bit for bit.  ``cv2`` does the
drawing; it is imported inside the functions that draw, so importing this
module needs no ``cv2``.

Coordinates returned by primitives are ``(x, y)`` pixel columns/rows of the
large canvas; :class:`SyntheticShapeGenerator.sample` downscales and returns
the on-disk training contract.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

PRIMITIVES: Tuple[str, ...] = (
    "lines",
    "polygon",
    "multiple_polygons",
    "ellipses",
    "star",
    "checkerboard",
    "stripes",
    "cube",
    "gaussian_noise",
)

_NO_POINTS = np.zeros((0, 2), np.float64)



def _thickness(rng: np.random.Generator, lo: float, hi: float) -> int:
    """Random draw thickness in pixels, safe for small canvases (>= 1)."""
    lo_i, hi_i = int(lo), max(int(hi), int(lo) + 1)
    return max(1, int(rng.integers(lo_i, hi_i)))

def _contrasting_gray(rng: np.random.Generator, background: int) -> int:
    """Random gray level with at least a small contrast to ``background``."""
    color = int(rng.integers(256))
    if abs(color - background) < 30:
        color = (color + 128) % 256
    return color


def _distinct_gray(rng: np.random.Generator, previous: List[int], min_dist=50) -> int:
    for _ in range(20):
        color = int(rng.integers(256))
        if all(abs(color - p) >= min_dist for p in previous):
            return color
    return color


def _segments_cross(segs: np.ndarray, p1: np.ndarray, p2: np.ndarray) -> bool:
    """Any existing segment (N,4) strictly crossing segment p1-p2?"""
    if len(segs) == 0:
        return False
    a, b = segs[:, 0:2], segs[:, 2:4]

    def ccw(u, v, w):
        return (w[:, 1] - u[:, 1]) * (v[:, 0] - u[:, 0]) > (
            (v[:, 1] - u[:, 1]) * (w[:, 0] - u[:, 0])
        )

    c = np.broadcast_to(p1, a.shape)
    d = np.broadcast_to(p2, a.shape)
    return bool(
        np.any((ccw(a, c, d) != ccw(b, c, d)) & (ccw(a, b, c) != ccw(a, b, d)))
    )


def _random_convex_corners(
    rng: np.random.Generator, shape: Tuple[int, int], min_rad_frac: float = 0.1
) -> Optional[np.ndarray]:
    """Corners of a random polygon inscribed in a random circle; returns None
    if fewer than 3 corners survive the sharpness filters."""
    hh, ww = shape
    min_dim = min(hh, ww)
    rad = max(rng.random() * min_dim / 2, min_dim * min_rad_frac)
    cx = rng.integers(int(rad), ww - int(rad))
    cy = rng.integers(int(rad), hh - int(rad))
    num = int(rng.integers(3, 8))
    slices = np.linspace(0, 2 * math.pi, num + 1)
    angles = slices[:-1] + rng.random(num) * np.diff(slices)
    radii = np.maximum(rng.random(num), 0.4) * rad
    pts = np.stack(
        [cx + radii * np.cos(angles), cy + radii * np.sin(angles)], -1
    ).astype(int)

    # drop near-coincident corners, then near-flat corners
    d = np.linalg.norm(pts - np.roll(pts, 1, axis=0), axis=1)
    pts = pts[d > 0.01]
    n = len(pts)
    if n < 3:
        return None
    v1 = np.roll(pts, 1, axis=0) - pts
    v2 = np.roll(pts, -1, axis=0) - pts
    cosang = np.sum(v1 * v2, -1) / np.maximum(
        np.linalg.norm(v1, axis=1) * np.linalg.norm(v2, axis=1), 1e-9
    )
    ang = np.arccos(np.clip(cosang, -1, 1))
    pts = pts[ang < 2 * math.pi / 3]
    return pts if len(pts) >= 3 else None


def _random_plane_warp(
    rng: np.random.Generator,
    shape: Tuple[int, int],
    points: np.ndarray,
    transform_params=(0.05, 0.15),
) -> np.ndarray:
    """Random affine + perspective displacement of grid points — shared by the
    checkerboard and stripes families."""
    import cv2

    alpha = max(shape) * (transform_params[0] + rng.random() * transform_params[1])
    center = np.float32(shape) // 2
    side = min(shape) // 3
    src = np.float32(
        [
            center + side,
            [center[0] + side, center[1] - side],
            center - side,
            [center[0] - side, center[1] + side],
        ]
    )
    affine = cv2.getAffineTransform(
        src[:3], (src + rng.uniform(-alpha, alpha, src.shape)).astype(np.float32)[:3]
    )
    persp = cv2.getPerspectiveTransform(
        src, (src + rng.uniform(-alpha / 2, alpha / 2, src.shape)).astype(np.float32)
    )
    homog = np.concatenate([points, np.ones((len(points), 1))], -1)
    warped = homog @ affine.T
    warped3 = np.concatenate([warped, np.ones((len(warped), 1))], -1) @ persp.T
    return (warped3[:, :2] / warped3[:, 2:]).astype(int)


def _inside(points: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    m = (
        (points[:, 0] >= 0)
        & (points[:, 0] < shape[1])
        & (points[:, 1] >= 0)
        & (points[:, 1] < shape[0])
    )
    return points[m]


class SyntheticShapeGenerator:
    """Draws one primitive family per call over a random background.

    All randomness flows from the injected ``numpy.random.Generator`` —
    deterministic per seed, safe to shard across processes by seed.
    """

    def __init__(
        self,
        rng: np.random.Generator,
        image_size: Tuple[int, int] = (960, 1280),
        out_size: Tuple[int, int] = (240, 320),
        blur_size: int = 11,
        background: Optional[Dict] = None,
        primitive_params: Optional[Dict[str, Dict]] = None,
    ):
        self.rng = rng
        self.image_size = image_size
        self.out_size = out_size
        self.blur_size = blur_size
        # defaults of the reference generation config (gen_synthetic_dataset.py:13-27)
        self.background = background or dict(
            nb_blobs=100,
            min_rad_ratio=0.02,
            max_rad_ratio=0.031,
            min_kernel_size=150,
            max_kernel_size=500,
        )
        self.primitive_params = primitive_params or {
            "stripes": {"transform_params": (0.1, 0.1)},
            "multiple_polygons": {"kernel_boundaries": (50, 100)},
        }

    # ---------------- backgrounds ----------------

    def draw_background(self) -> np.ndarray:
        import cv2

        rng = self.rng
        cfg = self.background
        img = rng.integers(0, 256, self.image_size, dtype=np.uint8, endpoint=False)
        _, img = cv2.threshold(img, int(rng.integers(256)), 255, cv2.THRESH_BINARY)
        bg = int(img.mean())
        dim = max(self.image_size)
        for _ in range(cfg["nb_blobs"]):
            x = int(rng.integers(self.image_size[1]))
            y = int(rng.integers(self.image_size[0]))
            radius = int(
                rng.integers(int(dim * cfg["min_rad_ratio"]), int(dim * cfg["max_rad_ratio"]))
            )
            cv2.circle(img, (x, y), radius, _contrasting_gray(rng, bg), -1)
        k = int(rng.integers(cfg["min_kernel_size"], cfg["max_kernel_size"]))
        img = cv2.blur(img, (k, k))
        return img

    def _fill_background(self, shape, base_color, nb_blobs=3000, kernel_boundaries=(50, 100)):
        """Textured fill used inside polygons."""
        import cv2

        rng = self.rng
        img = np.full(shape, _contrasting_gray(rng, base_color), np.uint8)
        for _ in range(nb_blobs):
            x = int(rng.integers(shape[1]))
            y = int(rng.integers(shape[0]))
            cv2.circle(img, (x, y), int(rng.integers(20)), _contrasting_gray(rng, base_color), -1)
        k = int(rng.integers(*kernel_boundaries))
        return cv2.blur(img, (k, k))

    # ---------------- primitives ----------------

    def lines(self, img: np.ndarray) -> np.ndarray:
        import cv2

        rng = self.rng
        n = int(rng.integers(1, 10))
        bg = int(img.mean())
        min_dim = min(img.shape)
        segs = np.empty((0, 4))
        pts: List[List[float]] = []
        for _ in range(n):
            p1 = np.array([rng.integers(img.shape[1]), rng.integers(img.shape[0])])
            p2 = np.array([rng.integers(img.shape[1]), rng.integers(img.shape[0])])
            if _segments_cross(segs, p1, p2):
                continue
            segs = np.vstack([segs, np.concatenate([p1, p2])[None]])
            thickness = _thickness(rng, min_dim * 0.01, min_dim * 0.02)
            cv2.line(img, tuple(p1), tuple(p2), _contrasting_gray(rng, bg), thickness)
            pts += [p1.tolist(), p2.tolist()]
        return np.asarray(pts, np.float64) if pts else _NO_POINTS

    def polygon(self, img: np.ndarray) -> np.ndarray:
        import cv2

        for _ in range(100):
            pts = _random_convex_corners(self.rng, img.shape[:2])
            if pts is not None:
                break
        else:
            return _NO_POINTS
        cv2.fillPoly(img, [pts.reshape(-1, 1, 2)], _contrasting_gray(self.rng, int(img.mean())))
        return pts.astype(np.float64)

    def multiple_polygons(self, img: np.ndarray) -> np.ndarray:
        import cv2

        rng = self.rng
        params = self.primitive_params.get("multiple_polygons", {})
        bg = int(img.mean())
        placed_segs = np.empty((0, 4))
        centers: List[np.ndarray] = []
        rads: List[float] = []
        all_pts: List[np.ndarray] = []
        for _ in range(30):
            pts = _random_convex_corners(rng, img.shape[:2])
            if pts is None:
                continue
            center = pts.mean(0)
            rad = np.max(np.linalg.norm(pts - center, axis=1))
            # reject overlaps with already placed polygons
            if any(
                np.linalg.norm(center - c) < rad + r for c, r in zip(centers, rads)
            ):
                continue
            new_segs = np.concatenate([pts, np.roll(pts, -1, axis=0)], -1)
            if any(
                _segments_cross(placed_segs, s[:2], s[2:]) for s in new_segs
            ):
                continue
            centers.append(center)
            rads.append(rad)
            placed_segs = np.vstack([placed_segs, new_segs])
            mask = np.zeros(img.shape, np.uint8)
            cv2.fillPoly(mask, [pts.reshape(-1, 1, 2)], 255)
            fill = self._fill_background(img.shape, bg, **params)
            img[mask != 0] = fill[mask != 0]
            all_pts.append(pts)
        return (
            np.concatenate(all_pts).astype(np.float64) if all_pts else _NO_POINTS
        )

    def ellipses(self, img: np.ndarray) -> np.ndarray:
        import cv2

        rng = self.rng
        bg = int(img.mean())
        min_dim = min(img.shape) / 4
        centers = np.empty((0, 2))
        rads: List[float] = []
        for _ in range(20):
            ax = int(max(rng.random() * min_dim, min_dim / 5))
            ay = int(max(rng.random() * min_dim, min_dim / 5))
            max_rad = max(ax, ay)
            x = int(rng.integers(max_rad, img.shape[1] - max_rad))
            y = int(rng.integers(max_rad, img.shape[0] - max_rad))
            new = np.array([x, y], np.float64)
            if len(centers) and np.any(
                max_rad > np.linalg.norm(centers - new, axis=1) - np.asarray(rads)
            ):
                continue
            centers = np.vstack([centers, new[None]])
            rads.append(max_rad)
            cv2.ellipse(
                img, (x, y), (ax, ay), rng.random() * 90, 0, 360,
                _contrasting_gray(rng, bg), -1,
            )
        return _NO_POINTS  # ellipses contribute no interest points

    def star(self, img: np.ndarray) -> np.ndarray:
        import cv2

        rng = self.rng
        num = int(rng.integers(3, 6))
        min_dim = min(img.shape)
        thickness = _thickness(rng, min_dim * 0.01, min_dim * 0.02)
        rad = max(rng.random() * min_dim / 2, min_dim / 5)
        cx = int(rng.integers(int(rad), img.shape[1] - int(rad)))
        cy = int(rng.integers(int(rad), img.shape[0] - int(rad)))
        slices = np.linspace(0, 2 * math.pi, num + 1)
        angles = slices[:-1] + rng.random(num) * np.diff(slices)
        radii = np.maximum(rng.random(num), 0.3) * rad
        tips = np.stack(
            [cx + radii * np.cos(angles), cy + radii * np.sin(angles)], -1
        ).astype(int)
        bg = int(img.mean())
        for tip in tips:
            cv2.line(img, (cx, cy), tuple(tip), _contrasting_gray(rng, bg), thickness)
        return np.vstack([[cx, cy], tips]).astype(np.float64)

    def checkerboard(self, img: np.ndarray) -> np.ndarray:
        import cv2

        rng = self.rng
        bg = int(img.mean())
        rows = int(rng.integers(3, 7))
        cols = int(rng.integers(3, 7))
        s = min((img.shape[1] - 1) // cols, (img.shape[0] - 1) // rows)
        xs, ys = np.meshgrid(np.arange(cols + 1), np.arange(rows + 1))
        grid = s * np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float64)
        warped = _random_plane_warp(rng, img.shape[:2], grid)

        colors = np.zeros((rows, cols), np.int32)
        for i in range(rows):
            for j in range(cols):
                neighbors = []
                if i:
                    neighbors.append(int(colors[i - 1, j]))
                if j:
                    neighbors.append(int(colors[i, j - 1]))
                col = (
                    _distinct_gray(rng, neighbors)
                    if neighbors
                    else _contrasting_gray(rng, bg)
                )
                colors[i, j] = col
                quad = warped[
                    [
                        i * (cols + 1) + j,
                        i * (cols + 1) + j + 1,
                        (i + 1) * (cols + 1) + j + 1,
                        (i + 1) * (cols + 1) + j,
                    ]
                ]
                cv2.fillConvexPoly(img, quad.astype(np.int32), col)

        # random emphasized boundary lines
        min_dim = min(img.shape)
        thickness = _thickness(rng, min_dim * 0.01, min_dim * 0.015)
        for _ in range(int(rng.integers(2, rows + 2))):
            r = int(rng.integers(rows + 1))
            c1, c2 = rng.integers(cols + 1, size=2)
            cv2.line(
                img,
                tuple(warped[r * (cols + 1) + int(c1)]),
                tuple(warped[r * (cols + 1) + int(c2)]),
                _contrasting_gray(rng, bg),
                thickness,
            )
        for _ in range(int(rng.integers(2, cols + 2))):
            c = int(rng.integers(cols + 1))
            r1, r2 = rng.integers(rows + 1, size=2)
            cv2.line(
                img,
                tuple(warped[int(r1) * (cols + 1) + c]),
                tuple(warped[int(r2) * (cols + 1) + c]),
                _contrasting_gray(rng, bg),
                thickness,
            )
        return _inside(warped, img.shape[:2]).astype(np.float64)

    def stripes(self, img: np.ndarray) -> np.ndarray:
        import cv2

        rng = self.rng
        params = self.primitive_params.get("stripes", {})
        transform_params = params.get("transform_params", (0.05, 0.15))
        bg = int(img.mean())
        board = (
            int(img.shape[0] * (1 + rng.random())),
            int(img.shape[1] * (1 + rng.random())),
        )
        ncols = int(rng.integers(5, 13))
        xs = np.unique(
            np.concatenate(
                [board[1] * rng.random(ncols - 1), [0, board[1] - 1]]
            ).astype(int)
        )
        min_width = min(img.shape) * 0.04
        keep = (np.diff(np.concatenate([xs, [board[1] + min_width]])) >= min_width)
        xs = xs[keep]
        ncols = len(xs) - 1
        top = np.stack([xs, np.zeros_like(xs)], -1)
        bottom = np.stack([xs, np.full_like(xs, board[0] - 1)], -1)
        grid = np.concatenate([top, bottom]).astype(np.float64)
        warped = _random_plane_warp(rng, img.shape[:2], grid, transform_params)

        color = _contrasting_gray(rng, bg)
        for i in range(ncols):
            color = (color + 128 + int(rng.integers(-30, 30))) % 256
            quad = warped[[i, i + 1, i + ncols + 2, i + ncols + 1]]
            cv2.fillConvexPoly(img, quad.astype(np.int32), color)

        min_dim = min(img.shape)
        thickness = _thickness(rng, min_dim * 0.01, min_dim * 0.015)
        for _ in range(int(rng.integers(2, 5))):
            row = int(rng.choice([0, ncols + 1]))
            c1, c2 = rng.integers(ncols + 1, size=2)
            cv2.line(
                img,
                tuple(warped[row + int(c1)]),
                tuple(warped[row + int(c2)]),
                _contrasting_gray(rng, bg),
                thickness,
            )
        for _ in range(int(rng.integers(2, ncols + 2))):
            c = int(rng.integers(ncols + 1))
            cv2.line(
                img,
                tuple(warped[c]),
                tuple(warped[c + ncols + 1]),
                _contrasting_gray(rng, bg),
                thickness,
            )
        return _inside(warped, img.shape[:2]).astype(np.float64)

    def cube(self, img: np.ndarray) -> np.ndarray:
        import cv2

        rng = self.rng
        bg = int(img.mean())
        min_dim = min(img.shape[:2])
        min_side = min_dim * 0.2
        sides = min_side + rng.random(3) * 2 * min_dim / 3
        lx, ly, lz = sides
        # vertices in Gray-code adjacency order; vertex 0 hidden, 7 front
        cube = np.array(
            [
                [0, 0, 0], [lx, 0, 0], [0, ly, 0], [lx, ly, 0],
                [0, 0, lz], [lx, 0, lz], [0, ly, lz], [lx, ly, lz],
            ]
        )
        angles = rng.random(3) * 3 * math.pi / 10.0 + math.pi / 10.0

        def rot_z(a):
            return np.array(
                [[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]]
            )

        def rot_x(a):
            return np.array(
                [[1, 0, 0], [0, math.cos(a), -math.sin(a)], [0, math.sin(a), math.cos(a)]]
            )

        def rot_y(a):
            return np.array(
                [[math.cos(a), 0, -math.sin(a)], [0, 1, 0], [math.sin(a), 0, math.cos(a)]]
            )

        scale = np.diag(0.4 + rng.random(3) * 0.6)
        trans = np.array(
            [
                img.shape[1] * 0.5
                + rng.integers(-int(img.shape[1] * 0.2), int(img.shape[1] * 0.2)),
                img.shape[0] * 0.5
                + rng.integers(-int(img.shape[0] * 0.2), int(img.shape[0] * 0.2)),
                0,
            ]
        )
        cube = trans + (scale @ rot_z(angles[0]) @ rot_x(angles[1]) @ rot_y(angles[2]) @ cube.T).T
        cube = cube[:, :2].astype(int)
        faces = np.array([[7, 3, 1, 5], [7, 5, 4, 6], [7, 6, 2, 3]])
        face_color = _contrasting_gray(rng, bg)
        for f in faces:
            cv2.fillPoly(img, [cube[f].reshape(-1, 1, 2)], face_color)
        thickness = _thickness(rng, min_dim * 0.003, min_dim * 0.015)
        for f in faces:
            for j in range(4):
                edge_color = (face_color + 128 + int(rng.integers(-64, 64))) % 256
                cv2.line(
                    img, tuple(cube[f[j]]), tuple(cube[f[(j + 1) % 4]]), edge_color, thickness
                )
        return _inside(cube[1:], img.shape[:2]).astype(np.float64)

    def gaussian_noise(self, img: np.ndarray) -> np.ndarray:
        img[:] = self.rng.integers(0, 256, img.shape, dtype=np.uint8, endpoint=False)
        return _NO_POINTS

    # ---------------- top-level sampling ----------------

    def draw(self, primitive: str) -> Tuple[np.ndarray, np.ndarray]:
        """Large canvas + (N, 2) (x, y) corner points for one primitive."""
        assert primitive in PRIMITIVES, primitive
        img = self.draw_background()
        points = getattr(self, primitive)(img)
        return img, points

    def sample(self, primitive: str) -> Tuple[np.ndarray, np.ndarray]:
        """One training item in the on-disk contract
        (`gen_synthetic_dataset.py:84-101`):

        Returns ``(image (1, oh, ow) float32 in [0,1],
        points (3, N) float [x, y, conf=1])``.
        """
        import cv2

        img, points = self.draw(primitive)
        img = cv2.GaussianBlur(img, (self.blur_size, self.blur_size), 0)
        scale = np.asarray(self.out_size, np.float64) / np.asarray(
            self.image_size, np.float64
        )  # (sy, sx)
        points = points * scale[::-1]                      # (x, y) scaling
        img = cv2.resize(
            img, self.out_size[::-1], interpolation=cv2.INTER_LINEAR
        )
        image = (img.astype(np.float32) / 255.0)[None]
        pts3 = np.vstack([points.T, np.ones((1, len(points)))]).astype(np.float32)
        return image, pts3
