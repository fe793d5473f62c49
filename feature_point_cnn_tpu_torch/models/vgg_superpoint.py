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

On the card each convolution's bias, ReLU and pool are one pass of a
hand-written kernel (`ops/kernels/conv_epilogue.py`) over the convolution's
channels-last bf16 output, computed without bias, bit for bit the three
PyTorch passes it replaces.  `_fused` says where: a bf16 CUDA input with no
gradient recorded, outside a width group and an export.  Elsewhere each
convolution adds its own bias and the passes follow it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.device import resolve_device
from feature_point_cnn_tpu_torch.models.blocks import Conv2d
from feature_point_cnn_tpu_torch.models.superpoint import _DTYPES
from feature_point_cnn_tpu_torch.ops.detection import decode_prob_map
from feature_point_cnn_tpu_torch.ops.kernels.conv_epilogue import conv_epilogue
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

    def features(self, image: torch.Tensor, enable_descriptor: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(B, H, W, 1)`` image -> ``(logits (B, Hc, Wc, 65), desc (B, Hc,
        Wc, D))``, float32, the descriptor L2-normalised: the ResNet model's
        contract, which `inference/wrapper.py::extract_fn` calls.  Without
        the descriptor head the descriptors are zeros."""
        x = image.permute(0, 3, 1, 2).to(self.compute_dtype)
        last = len(ENCODER_DIMS) - 1
        for i in range(len(ENCODER_DIMS)):
            x = self._conv(f"encoder_conv{i}_a", x)
            x = self._conv(f"encoder_conv{i}_b", x, pool=i != last)
        point = self._conv("detector_conv_a", x)
        logits = self._conv("detector_conv_b", point, relu=False,
                            out_float32=True).permute(0, 2, 3, 1)
        if not enable_descriptor:
            b, hc, wc, _ = logits.shape
            return logits, logits.new_zeros((b, hc, wc, self.config.descriptor_dim))
        desc = self._conv("descriptor_conv_a", x)
        desc = self._conv("descriptor_conv_b", desc, relu=False,
                          out_float32=True).permute(0, 2, 3, 1)
        norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
        return logits, desc / norm.clamp_min(1e-12)

    @staticmethod
    def _fused(x: torch.Tensor, conv: nn.Conv2d) -> bool:
        """Whether ``conv`` on ``x`` ends in the epilogue kernel: a CUDA bf16
        input with no gradient recorded, outside a width group and outside
        ``torch.export``.  Training, the W-sharded forward (its pool
        exchanges halos), exports and the CPU take the plain passes."""
        return (x.is_cuda and x.dtype == torch.bfloat16 and spatial.group() is None
                and not torch.compiler.is_exporting()
                and not (torch.is_grad_enabled() and (
                    x.requires_grad or conv.weight.requires_grad or conv.bias.requires_grad)))

    def _conv(self, name: str, x: torch.Tensor, relu: bool = True, pool: bool = False,
              out_float32: bool = False) -> torch.Tensor:
        """The convolution ``name`` on ``x``, then its bias, ReLU (``relu``),
        2x2 max-pool (``pool``) and a float32 result (``out_float32``).
        Fused (`_fused`), the convolution runs without bias on channels-last
        bf16 weights, so that cuDNN writes its output channels-last
        whatever the module's layout, and the kernel adds the rest; else
        the module's convolution adds its bias and the passes follow."""
        conv = getattr(self, name)
        if self._fused(x, conv):
            weight = conv.weight.to(x.dtype, memory_format=torch.channels_last)
            return conv_epilogue(conv._conv_forward(x, weight, None), conv.bias,
                                 relu, pool, out_float32)
        x = conv(x)
        if relu:
            x = torch.relu(x)
        if pool:
            x = (spatial.max_pool2d(x, 2, 2) if spatial.group() is not None
                 else F.max_pool2d(x, 2, 2))
        return x.float() if out_float32 else x

    def forward(self, image: torch.Tensor):
        logits, desc = self.features(image)
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
