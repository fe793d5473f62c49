"""Perspective image warping (`feature_point_cnn_tpu/geometry/warp.py:26-97`).

Conventions, as on the JAX side:

* a flat homography ``h = (h00..h21)`` with ``h22 = 1`` maps **output**
  (warped) pixel coords ``(x, y)`` to **input** coords;
* pixel centers sit at half-integer offsets: the source position of output
  index ``(xi, yi)`` is ``H (xi + 0.5, yi + 0.5) - 0.5``;
* out-of-image samples are zero; nearest sampling rounds half to even.

Where the JAX functions take one image and are `vmap`-ed, these take a
leading batch axis written out: an image ``(H, W, C)`` with ``h (8,)``, or a
batch ``(B, H, W, C)`` with ``h (B, 8)``.
"""

from __future__ import annotations

import torch


def apply_flat_homography(h: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Apply a flat homography ``(8,)`` to ``(..., 2)`` ``(x, y)`` points;
    with ``h (B, 8)`` every homography maps the same points and the result
    is ``(B, ..., 2)``."""
    x, y = xy[..., 0], xy[..., 1]
    hh = h.reshape(h.shape[:-1] + (1,) * x.dim() + (8,))
    den = hh[..., 6] * x + hh[..., 7] * y + 1.0
    xs = (hh[..., 0] * x + hh[..., 1] * y + hh[..., 2]) / den
    ys = (hh[..., 3] * x + hh[..., 4] * y + hh[..., 5]) / den
    return torch.stack([xs, ys], dim=-1)


def _gather(image: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """``image (B, H, W, C)`` at integer ``(B, ...)`` positions, zero
    outside -> ``(B, ..., C)``."""
    b, h, w, c = image.shape
    inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    flat = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1)
    v = torch.gather(image.reshape(b, h * w, c), 1,
                     flat[..., None].expand(-1, -1, c))
    return torch.where(inb[..., None], v.reshape(*yi.shape, c), 0.0)


def bilinear_sample(image: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Sample ``image (B, H, W, C)`` at float ``(B, ..., 2)`` ``(y, x)``
    positions, bilinear with zero padding -> ``(B, ..., C)``."""
    y, x = yx[..., 0], yx[..., 1]
    y0, x0 = torch.floor(y), torch.floor(x)
    wy, wx = (y - y0)[..., None], (x - x0)[..., None]
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    top = _gather(image, y0i, x0i) * (1 - wx) + _gather(image, y0i, x0i + 1) * wx
    bot = (_gather(image, y0i + 1, x0i) * (1 - wx)
           + _gather(image, y0i + 1, x0i + 1) * wx)
    return top * (1 - wy) + bot * wy


def nearest_sample(image: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sampling with zero padding; ``torch.round`` rounds
    half to even, as `jnp.round` does."""
    yi = torch.round(yx[..., 0]).to(torch.int64)
    xi = torch.round(yx[..., 1]).to(torch.int64)
    return _gather(image, yi, xi)


def warp_image(
    image: torch.Tensor, h_flat: torch.Tensor, mode: str = "bilinear"
) -> torch.Tensor:
    """Warp ``image (H, W, C)`` by ``h_flat (8,)``, or a batch ``(B, H, W,
    C)`` by ``(B, 8)`` (output -> input map)."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unknown mode {mode!r}")
    single = image.dim() == 3
    if single:
        image, h_flat = image[None], h_flat[None]
    h, w = image.shape[1:3]
    dev = image.device
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    out_xy = torch.stack([xx + 0.5, yy + 0.5], dim=-1)       # pixel centers
    src_xy = apply_flat_homography(h_flat.to(torch.float32), out_xy) - 0.5
    src_yx = src_xy.flip(-1)
    sample = bilinear_sample if mode == "bilinear" else nearest_sample
    out = sample(image, src_yx)
    return out[0] if single else out
