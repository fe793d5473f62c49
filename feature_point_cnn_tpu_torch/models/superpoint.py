"""ResNet-backbone SuperPoint as PyTorch modules (NCHW inside).

Port of `feature_point_cnn_tpu/models/superpoint.py:37-167`.  Total stride
8 == cell size: conv7x7/2 + maxpool3/2 + layer2/2.  The public forward keeps
the JAX package's layouts: image ``(B, H, W, 3)`` in [0, 1] in, and
``prob (B, H, W)``, ``desc (B, Hc, Wc, D)``, ``logits (B, Hc, Wc, 65)``, all
float32, out.

``compute_dtype="bfloat16"`` stores the convolution weights in bf16 and
feeds them bf16 activations; BatchNorm keeps float32 parameters and
statistics (PyTorch's mixed-type BatchNorm computes in float32 and returns
bf16), as Flax promotes its BatchNorm to float32 on the JAX side.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.models.blocks import resnet_layer
from feature_point_cnn_tpu_torch.ops.detection import decode_prob_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Encoder(nn.Module):
    """conv7x7/2(3->64)+BN+ReLU+maxpool3/2, then residual layers 64/1 and
    128/2."""

    def __init__(self, cin: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        self.layer1 = resnet_layer(2, 64, 64, 1)
        self.layer2 = resnet_layer(2, 64, 128, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = nn.functional.max_pool2d(x, 3, 2, 1)
        return self.layer2(self.layer1(x))


class Detector(nn.Module):
    """Residual layer 128 -> 65 logits; its input is the embedding the
    descriptor head consumes."""

    def __init__(self):
        super().__init__()
        self.layer = resnet_layer(2, 128, 65, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class Descriptor(nn.Module):
    """128 -> 256/2 residual layer, transposed conv back to 1/8 resolution,
    concat with the detector embedding, residual layer -> D."""

    def __init__(self, descriptor_dim: int):
        super().__init__()
        self.layer_in = resnet_layer(2, 128, 256, 2)
        self.up_sample = nn.ConvTranspose2d(
            256, 128, 3, stride=2, padding=1, output_padding=1
        )
        self.bn = nn.BatchNorm2d(128, eps=1e-5)
        self.layer_out = resnet_layer(2, 256, descriptor_dim, 1)

    def forward(self, x: torch.Tensor, embeddings: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn(self.up_sample(self.layer_in(x))))
        # for odd Hc/Wc the doubling transposed conv overshoots by one
        # row/col: crop to the embedding grid (superpoint.py:108-112)
        hc, wc = embeddings.shape[2:]
        y = y[:, :, :hc, :wc]
        return self.layer_out(torch.cat([y, embeddings], dim=1))


class SuperPoint(nn.Module):
    def __init__(self, config: SuperPointConfig = SuperPointConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config.image_channels)
        self.detector = Detector()
        self.descriptor = Descriptor(config.descriptor_dim)
        self.reset_parameters(generator)
        self.compute_dtype = _DTYPES[config.compute_dtype]
        if self.compute_dtype != torch.float32:
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    m.to(self.compute_dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """LeCun-normal conv kernels (Flax's default) drawn from
        ``generator``; zero biases; identity BatchNorms."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                fan_in = w[0].numel() if isinstance(m, nn.Conv2d) else (
                    w.shape[0] * w.shape[2] * w.shape[3]
                )
                w.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()

    def features(
        self, image: torch.Tensor, enable_descriptor: bool = True
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(B, H, W, C)`` image -> ``(logits (B, Hc, Wc, 65), desc
        (B, Hc, Wc, D))``, float32."""
        b, h, w, _ = image.shape
        hc, wc = self.config.grid_size(h, w)
        # an NHWC tensor permuted to NCHW is already channels-last in memory
        x = image.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = self.encoder(x)
        logits = self.detector(x)
        if enable_descriptor:
            desc = self.descriptor(x, x).permute(0, 2, 3, 1).float()
        else:
            desc = torch.zeros(
                (b, hc, wc, self.config.descriptor_dim), device=image.device
            )
        return logits.permute(0, 2, 3, 1).float(), desc

    def forward(self, image: torch.Tensor, enable_descriptor: bool = True):
        """-> ``(prob (B, H, W), desc (B, Hc, Wc, D), logits (B, Hc, Wc,
        65))``, the JAX model's contract."""
        logits, desc = self.features(image, enable_descriptor)
        return decode_prob_map(logits, self.config.cell), desc, logits
