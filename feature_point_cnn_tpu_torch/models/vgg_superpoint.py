"""The original (magicleap-style) VGG SuperPoint, the second model family
(`feature_point_cnn_tpu/models/vgg_superpoint.py:25-87`).

1-channel input, four conv pairs 1->64->64->128->128 with a 2x2 max-pool
between pairs (total stride 8), a detector head 128->256->65 and a
descriptor head 128->256->256 with L2 normalisation in the model; no
BatchNorm.  Parameter names are the magicleap ones (``encoder_conv{i}_{a,b}``,
``detector_conv_{a,b}``, ``descriptor_conv_{a,b}``), which are also the
JAX module's; `utils/weights.py` carries JAX variables across.  The public
forward keeps the ResNet model's layouts: image ``(B, H, W, 1)`` in [0, 1]
in, ``prob (B, H, W)``, ``desc (B, Hc, Wc, 256)``, ``logits (B, Hc, Wc,
65)``, all float32, out.

Under ``parallel.spatial.width_group(g)`` the forward takes each rank's
block of columns (`parallel/mesh.py::shard_images_spatial`) and returns
that block of all three outputs, as the ResNet model does: the 3x3
convolutions exchange a column with the neighbouring ranks, and the 2x2
pools, the 1x1 heads, the normalisation and the decode are local to a
column.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.device import resolve_device
from feature_point_cnn_tpu_torch.models.blocks import Conv2d
from feature_point_cnn_tpu_torch.models.superpoint import _DTYPES
from feature_point_cnn_tpu_torch.ops.detection import decode_prob_map
from feature_point_cnn_tpu_torch.parallel import spatial

# (in, out) channel pairs of the encoder
ENCODER_DIMS: Tuple[Tuple[int, int], ...] = ((1, 64), (64, 64), (64, 128), (128, 128))
VGG_CONFIG = SuperPointConfig(image_channels=1, descriptor_dim=256)


class VGGSuperPoint(nn.Module):
    """``forward(image (B, H, W, 1)) -> (prob_map, desc_map, logits)``.
    Convolutions run in ``config.compute_dtype`` with float32 parameters;
    the heads' outputs, the normalisation and the decode are float32."""

    def __init__(self, config: SuperPointConfig = VGG_CONFIG,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.compute_dtype = _DTYPES[config.compute_dtype]
        cin = config.image_channels
        for i, (_, cout) in enumerate(ENCODER_DIMS):
            setattr(self, f"encoder_conv{i}_a", Conv2d(cin, cout, 3, 1, 1))
            setattr(self, f"encoder_conv{i}_b", Conv2d(cout, cout, 3, 1, 1))
            cin = cout
        self.detector_conv_a = Conv2d(cin, 256, 3, 1, 1)
        self.detector_conv_b = Conv2d(256, 65, 1, 1, 0)
        self.descriptor_conv_a = Conv2d(cin, 256, 3, 1, 1)
        self.descriptor_conv_b = Conv2d(256, config.descriptor_dim, 1, 1, 0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """LeCun-normal kernels (Flax's default) drawn from ``generator``;
        zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
                m.bias.zero_()

    def forward(self, image: torch.Tensor):
        x = image.permute(0, 3, 1, 2).to(self.compute_dtype)
        last = len(ENCODER_DIMS) - 1
        for i in range(len(ENCODER_DIMS)):
            x = torch.relu(getattr(self, f"encoder_conv{i}_a")(x))
            x = torch.relu(getattr(self, f"encoder_conv{i}_b")(x))
            if i != last:
                if spatial.group() is not None:
                    x = spatial.max_pool2d(x, 2, 2)
                else:
                    x = nn.functional.max_pool2d(x, 2, 2)
        point = torch.relu(self.detector_conv_a(x))
        logits = self.detector_conv_b(point).float().permute(0, 2, 3, 1)
        desc = torch.relu(self.descriptor_conv_a(x))
        desc = self.descriptor_conv_b(desc).float().permute(0, 2, 3, 1)
        norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
        desc = desc / norm.clamp_min(1e-12)
        return decode_prob_map(logits, self.config.cell), desc, logits


def init_vgg_superpoint(
    generator: Optional[torch.Generator] = None,
    config: Optional[SuperPointConfig] = None,
    device=None,
) -> VGGSuperPoint:
    """A VGG SuperPoint with fresh weights drawn from ``generator`` (default:
    seed 0), on ``device`` (``None``: ``cuda``)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    return VGGSuperPoint(config or VGG_CONFIG, generator=gen).to(resolve_device(device))
