"""On-device photometric augmentation
(`feature_point_cnn_tpu/data/photometric.py:23-80`): random brightness and
contrast, a 3x3 box or 3-tap motion blur, multiplicative or additive
gaussian noise, each fired with probability ``p``.  Off by default, as on
the JAX side (``SuperPointConfig.photometric_augment``).

Each stage is a function of the image batch ``(B, H, W, C)`` and of its
random values, so the stages can be compared with given values;
`photometric_augment_batch` draws them from a `torch.Generator`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def brightness_contrast(
    images: torch.Tensor, brightness: torch.Tensor, contrast: torch.Tensor
) -> torch.Tensor:
    """``(img - mean) * contrast + mean + brightness`` with each item's own
    mean; ``brightness``, ``contrast``: ``(B,)`` (the draw is +-0.2 and
    1 +- 0.2)."""
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    return ((images - mean) * contrast[:, None, None, None] + mean
            + brightness[:, None, None, None])


def blur(images: torch.Tensor, choice: torch.Tensor) -> torch.Tensor:
    """Per item one of: 3x3 box blur (0), horizontal (1) or vertical (2)
    3-tap motion blur; zero padding.  ``choice``: ``(B,)`` int."""
    b, h, w, c = images.shape
    kernels = torch.zeros((3, 3, 3), dtype=images.dtype, device=images.device)
    kernels[0] = 1.0 / 9.0
    kernels[1, 1, :] = 1.0 / 3.0
    kernels[2, :, 1] = 1.0 / 3.0
    weight = kernels[choice].repeat_interleave(c, dim=0)[:, None]  # (B*C, 1, 3, 3)
    x = images.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    y = F.conv2d(x, weight, padding=1, groups=b * c)
    return y.reshape(b, c, h, w).permute(0, 2, 3, 1)


def noise(
    images: torch.Tensor, mult: torch.Tensor, gauss: torch.Tensor,
    pick_mult: torch.Tensor,
) -> torch.Tensor:
    """Per item one of: multiplicative noise ``mult (B, H, W, 1)`` (drawn in
    [0.9, 1.1)) or additive ``0.05 * gauss (B, H, W, C)`` (standard normal);
    ``pick_mult``: ``(B,)`` bool."""
    return torch.where(pick_mult[:, None, None, None], images * mult,
                       images + 0.05 * gauss)


def photometric_augment_batch(
    gen: torch.Generator, images: torch.Tensor, p: float = 1.0 / 3.0,
    shard: Tuple[int, int] = (0, 1),
) -> torch.Tensor:
    """Augment ``(B, H, W, C)`` images in [0, 1]; each stage fires per item
    with probability ``p``.  ``shard = (index, count)``: the draws are made
    for a global batch of ``count * B`` images, of which these are rows
    ``[index * B, (index + 1) * B)``."""
    b, h, w, c = images.shape
    dev = images.device
    index, count = shard
    rows = slice(index * b, (index + 1) * b)

    def rand(*shape):
        return torch.rand((count * shape[0],) + shape[1:], generator=gen,
                          device=gen.device)[rows].to(dev)

    def fires():
        return (rand(b) < p)[:, None, None, None]

    images = torch.where(fires(), brightness_contrast(
        images, rand(b) * 0.4 - 0.2, 1.0 + rand(b) * 0.4 - 0.2), images)
    choice = torch.randint(0, 3, (count * b,), generator=gen,
                           device=gen.device)[rows].to(dev)
    images = torch.where(fires(), blur(images, choice), images)
    gauss = torch.randn((count * b, h, w, c), generator=gen,
                        device=gen.device)[rows].to(dev)
    images = torch.where(fires(), noise(
        images, 0.9 + 0.2 * rand(b, h, w, 1), gauss, rand(b) < 0.5), images)
    return images.clamp(0.0, 1.0)


def photometric_augment(gen, image: torch.Tensor, p: float = 1.0 / 3.0):
    """One ``(H, W, C)`` image."""
    return photometric_augment_batch(gen, image[None], p)[0]
