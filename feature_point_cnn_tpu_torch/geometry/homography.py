"""Random homography engine: sampling, algebra, point warping, valid masks
(`feature_point_cnn_tpu/geometry/homography.py`).

Conventions, as on the JAX side:

* a flat homography ``(8,)`` with ``h22 = 1`` maps output ``(x, y)`` pixel
  coords to input coords;
* `warp_points` takes and returns ``(y, x)`` points and warps with the
  **inverse** homography: it moves input-frame points into the warped frame.

Random draws come from an explicit `torch.Generator` (they cannot equal
`jax.random`'s for the same seed).  The sampler and the augmentation are
written over a batch; what the JAX side does with `vmap` is a leading axis
here.  The deterministic part of the augmentation can be called with a given
``h_flat``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from feature_point_cnn_tpu_torch.config import HomographyConfig
from feature_point_cnn_tpu_torch.device import constant
from feature_point_cnn_tpu_torch.geometry.warp import warp_image


# ---------------------------------------------------------------------------
# Flat homography algebra (homography.py:48-66)
# ---------------------------------------------------------------------------

def flat2mat(h: torch.Tensor) -> torch.Tensor:
    """``(..., 8) -> (..., 3, 3)`` with ``h22 = 1``."""
    one = torch.ones(h.shape[:-1] + (1,), dtype=h.dtype, device=h.device)
    return torch.cat([h, one], dim=-1).reshape(h.shape[:-1] + (3, 3))


def mat2flat(m: torch.Tensor) -> torch.Tensor:
    """``(..., 3, 3) -> (..., 8)``, normalised by ``m[2, 2]``."""
    flat = m.reshape(m.shape[:-2] + (9,))
    return (flat / flat[..., 8:9])[..., :8]


def invert_homography(h: torch.Tensor) -> torch.Tensor:
    # no error check, as `jnp.linalg.inv` has none: on a card the check would
    # read the solver's status back to the host, which no step captured in a
    # CUDA graph may do
    return mat2flat(torch.linalg.inv_ex(flat2mat(h), check_errors=False).inverse)


def compose_homographies(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Flat homography of applying ``h2`` then ``h1`` (matrix product)."""
    return mat2flat(flat2mat(h1) @ flat2mat(h2))


# ---------------------------------------------------------------------------
# Point warping (homography.py:73-97)
# ---------------------------------------------------------------------------

def warp_points(points: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Warp ``(y, x)`` points with the INVERSE of ``h``.

    ``points (N, 2)`` with ``h (8,)`` -> ``(N, 2)``; with ``h (B, 8)`` ->
    ``(B, N, 2)``; ``points (B, N, 2)`` with ``h (B, 8)`` warps each item's
    own points.
    """
    batched = h.dim() == 2
    hb = h if batched else h[None]
    xy = points.flip(-1).to(torch.float32)
    homog = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    h_inv = flat2mat(invert_homography(hb.to(torch.float32)))     # (B, 3, 3)
    if homog.dim() == 2:
        warped = torch.einsum("bij,nj->bni", h_inv, homog)
    else:
        warped = torch.einsum("bij,bnj->bni", h_inv, homog)
    warped = (warped[..., :2] / warped[..., 2:]).flip(-1)          # (y, x)
    return warped if batched else warped[0]


def points_in_image_mask(points: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Bool mask of ``(..., 2)`` ``(y, x)`` points inside ``[0, shape-1]``."""
    limit = constant(tuple(shape), points.device) - 1.0
    return ((points >= 0.0) & (points <= limit)).all(dim=-1)


# ---------------------------------------------------------------------------
# Homography sampling (homography.py:104-224)
# ---------------------------------------------------------------------------

def _uniform(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)


_PHI2 = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))   # normal CDF at +2


def _truncated_normal(gen, shape, mean=0.0, std=1.0) -> torch.Tensor:
    """A normal truncated to +-2 sigma, by the inverse CDF of a uniform on
    ``[Phi(-2), Phi(2)]``."""
    u = (1.0 - _PHI2) + _uniform(gen, shape) * (2.0 * _PHI2 - 1.0)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return z.clamp(-2.0, 2.0) * std + mean


def _uniform_swapped(gen, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Uniform on [low, high], swapping bounds if inverted and widening
    degenerate intervals (`homography.py:108-115`)."""
    lo, hi = torch.minimum(low, high), torch.maximum(low, high)
    hi = torch.where(hi - lo < 1e-12, lo + 1e-5, hi)
    return _uniform(gen, lo.shape) * (hi - lo) + lo


def _choose_uniform_valid(gen, valid: torch.Tensor) -> torch.Tensor:
    """Per row of ``valid (B, M)``, uniformly pick one index among the True
    entries (Gumbel-argmax)."""
    u = _uniform(gen, valid.shape).clamp_min(torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.where(valid, gumbel, -torch.inf).argmax(dim=-1)


@functools.lru_cache(maxsize=32)
def _angles(max_angle: float, n: int, device) -> torch.Tensor:
    """The rotation candidates ``(n + 1,)``: 0 first, then ``n`` evenly
    spaced in ``[-max_angle, max_angle]``; made once a device."""
    return torch.cat([torch.zeros(1), torch.linspace(-max_angle, max_angle, n)]
                     ).to(device)


def sample_homography_batch(
    gen: torch.Generator,
    batch: int,
    shape: Tuple[int, int],
    config: HomographyConfig = HomographyConfig(),
    device=None,
) -> torch.Tensor:
    """``batch`` random valid homographies as flat ``(batch, 8)`` vectors on
    ``device`` (default: the generator's).

    A ``patch_ratio`` centered patch is perturbed in perspective, scaled,
    translated and rotated; the flat homography maps output (warped) points
    to input-patch points.  ``shape`` is ``(H, W)``.  The draws are made on
    the generator's device, the 8x8 DLT systems solved on ``device``.
    """
    b = batch
    margin = (1.0 - config.patch_ratio) / 2.0
    unit = constant(((0.0, 0.0), (0.0, 1.0), (1.0, 1.0), (1.0, 0.0)), gen.device)
    pts1 = (margin + config.patch_ratio * unit).expand(b, 4, 2)  # (x, y)
    pts2 = pts1

    if config.perspective:
        ax, ay = config.perspective_amplitude_x, config.perspective_amplitude_y
        if not config.allow_artifacts:
            ax, ay = min(ax, margin), min(ay, margin)
        persp = _truncated_normal(gen, (b,), std=ay / 2.0)
        left = _truncated_normal(gen, (b,), std=ax / 2.0)
        right = _truncated_normal(gen, (b,), std=ax / 2.0)
        pts2 = pts2 + torch.stack([
            torch.stack([left, persp], -1),
            torch.stack([left, -persp], -1),
            torch.stack([right, persp], -1),
            torch.stack([right, -persp], -1),
        ], dim=1)

    def pick(cands: torch.Tensor) -> torch.Tensor:
        """One of the ``(B, M, 4, 2)`` candidates per item, uniformly among
        those that keep the patch inside the unit square."""
        m = cands.shape[1]
        if config.allow_artifacts:
            valid = (torch.arange(m, device=gen.device) < m - 1).expand(b, m)
        else:
            valid = ((cands >= 0.0) & (cands < 1.0)).all(dim=(2, 3))
        idx = _choose_uniform_valid(gen, valid)
        return cands[torch.arange(b, device=gen.device), idx]

    if config.scaling:
        n = config.n_scales
        scales = torch.cat([
            torch.ones((b, 1), device=gen.device),
            _truncated_normal(gen, (b, n), 1.0, config.scaling_amplitude / 2.0),
        ], dim=1)                                              # (B, n+1)
        center = pts2.mean(dim=1, keepdim=True)
        pts2 = pick((pts2 - center)[:, None] * scales[:, :, None, None]
                    + center[:, None])

    if config.translation:
        t_min = pts2.min(dim=1).values
        t_max = (1.0 - pts2).min(dim=1).values
        if config.allow_artifacts:
            t_min = t_min + config.translation_overflow
            t_max = t_max + config.translation_overflow
        tx = _uniform_swapped(gen, -t_min[:, 0], t_max[:, 0])
        ty = _uniform_swapped(gen, -t_min[:, 1], t_max[:, 1])
        pts2 = pts2 + torch.stack([tx, ty], -1)[:, None]

    if config.rotation:
        n = config.n_angles
        angles = _angles(config.max_angle, n, gen.device)      # (n+1,), 0 first
        center = pts2.mean(dim=1, keepdim=True)
        cos, sin = torch.cos(angles), torch.sin(angles)
        # row-vector convention: p' = p @ [[cos, -sin], [sin, cos]]
        rot = torch.stack([torch.stack([cos, -sin], -1),
                           torch.stack([sin, cos], -1)], dim=-2)  # (n+1, 2, 2)
        pts2 = pick(torch.einsum("bpj,ajk->bapk", pts2 - center, rot)
                    + center[:, None])

    dev = torch.device(device) if device is not None else gen.device
    wh = constant((shape[1], shape[0]), dev)
    pts1 = pts1.to(dev) * wh
    pts2 = pts2.to(dev) * wh

    # DLT: solve the 8x8 system mapping pts1 -> pts2 (homography.py:210-219)
    px, py = pts1[..., 0], pts1[..., 1]
    qx, qy = pts2[..., 0], pts2[..., 1]
    zeros, ones = torch.zeros_like(px), torch.ones_like(px)
    ax_rows = torch.stack([px, py, ones, zeros, zeros, zeros, -px * qx, -py * qx], -1)
    ay_rows = torch.stack([zeros, zeros, zeros, px, py, ones, -px * qy, -py * qy], -1)
    a_mat = torch.stack([ax_rows, ay_rows], dim=2).reshape(b, 8, 8)
    b_vec = torch.stack([qx, qy], dim=-1).reshape(b, 8)
    # no error check, as in `invert_homography`
    return torch.linalg.solve_ex(a_mat, b_vec, check_errors=False).result


def sample_homography(
    gen: torch.Generator,
    shape: Tuple[int, int],
    config: HomographyConfig = HomographyConfig(),
    device=None,
) -> torch.Tensor:
    """One random valid homography as a flat ``(8,)`` vector."""
    return sample_homography_batch(gen, 1, shape, config, device)[0]


# ---------------------------------------------------------------------------
# Valid masks + erosion (homography.py:231-289)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def ellipse_kernel(radius: int) -> np.ndarray:
    """OpenCV-identical ``getStructuringElement(MORPH_ELLIPSE, (2r, 2r))``:
    per row ``i``, fill columns ``[c-dx, c+dx]`` where ``dx = round(c
    sqrt(r^2 - dy^2) / r)`` (ties to even)."""
    ksize = 2 * radius
    r = c = ksize // 2
    kernel = np.zeros((ksize, ksize), np.float32)
    inv_r2 = 1.0 / (r * r) if r else 0.0
    for i in range(ksize):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.round(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
            kernel[i, max(c - dx, 0):min(c + dx + 1, ksize)] = 1.0
    return kernel


@functools.lru_cache(maxsize=32)
def _ellipse_kernel_on(radius: int, device) -> torch.Tensor:
    """`ellipse_kernel` as a ``(1, 1, 2r, 2r)`` tensor, made once a device."""
    return torch.from_numpy(ellipse_kernel(radius)).to(device)[None, None]


def erode(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary erosion with the OpenCV ellipse element, zero border: anchor
    at ``(r, r)`` of a ``2r x 2r`` kernel, hence the asymmetric padding
    ``(r, r - 1)``.  Exact for {0, 1} masks.  ``mask``: ``(H, W)`` or ``(B,
    H, W)``."""
    if radius <= 0:
        return mask
    ksum = float(ellipse_kernel(radius).sum())
    kernel = _ellipse_kernel_on(radius, mask.device)
    squeeze = mask.dim() == 2
    x = (mask[None] if squeeze else mask)[:, None].to(torch.float32)
    x = F.pad(x, (radius, radius - 1, radius, radius - 1))
    hits = F.conv2d(x, kernel)[:, 0]
    out = (hits > ksum - 0.5).to(mask.dtype)
    return out[0] if squeeze else out


def compute_valid_mask(
    shape: Tuple[int, int], h_flat: torch.Tensor, erosion_radius: int = 0
) -> torch.Tensor:
    """Mask of valid (non-border-artifact) pixels after warping by
    ``h_flat``: ``(H, W)`` float32 in {0, 1} for ``h_flat (8,)``, ``(B, H,
    W)`` for ``(B, 8)``."""
    lead = h_flat.shape[:-1]
    ones = torch.ones(lead + tuple(shape) + (1,), dtype=torch.float32,
                      device=h_flat.device)
    mask = warp_image(ones, h_flat, mode="nearest")[..., 0]
    return erode(mask, erosion_radius)


# ---------------------------------------------------------------------------
# Homographic augmentation (homography.py:296-325)
# ---------------------------------------------------------------------------

def homographic_augmentation_batch(
    gen: Optional[torch.Generator],
    images: torch.Tensor,
    points: torch.Tensor,
    points_valid: torch.Tensor,
    config: HomographyConfig = HomographyConfig(),
    h_flat: Optional[torch.Tensor] = None,
):
    """Warp each image ``(B, H, W, C)`` and its padded ``(y, x)`` point set
    ``(B, P, 2)`` / ``(B, P)`` by a homography of its own: drawn from
    ``gen``, or the given ``h_flat (B, 8)`` (then ``gen`` is not used).

    Returns ``(warped_images, warped_points, warped_valid, valid_mask (B, H,
    W), h_flat)``; ``valid_mask`` is the eroded border-artifact mask.
    """
    b, h, w = images.shape[:3]
    if h_flat is None:
        h_flat = sample_homography_batch(gen, b, (h, w), config, images.device)
    warped_images = warp_image(images, h_flat, mode="bilinear")
    valid_mask = compute_valid_mask((h, w), h_flat, config.valid_border_margin)
    warped_points = warp_points(points, h_flat)
    warped_valid = points_valid & points_in_image_mask(warped_points, (h, w))
    return warped_images, warped_points, warped_valid, valid_mask, h_flat


def homographic_augmentation(
    gen: Optional[torch.Generator],
    image: torch.Tensor,
    points: torch.Tensor,
    points_valid: torch.Tensor,
    config: HomographyConfig = HomographyConfig(),
    h_flat: Optional[torch.Tensor] = None,
):
    """One image ``(H, W, C)`` with its ``(P, 2)`` / ``(P,)`` point set."""
    out = homographic_augmentation_batch(
        gen, image[None], points[None], points_valid[None], config,
        None if h_flat is None else h_flat[None],
    )
    return tuple(o[0] for o in out)
