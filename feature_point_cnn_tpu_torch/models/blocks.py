"""ResNet building blocks of the SuperPoint backbone, NCHW.

Same topology and parameter names as the reference's PyTorch blocks, which
is also what the JAX package's `models/blocks.py:163-228` mirrors:
conv3x3-BN-ReLU + conv1x1-BN, and on the first block of a layer a projected
identity (1x1 conv + BN, the ``identity_downsample`` Sequential) that also
carries the stride.  BatchNorm uses eps 1e-5 (`blocks.py:46-56`).
"""

from __future__ import annotations

import torch
from torch import nn


class ResNetBlock(nn.Module):
    def __init__(self, cin: int, channels: int, stride: int = 1,
                 project_identity: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, channels, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(channels, eps=1e-5)
        self.conv2 = nn.Conv2d(channels, channels, 1, 1, 0, bias=False)
        self.bn2 = nn.BatchNorm2d(channels, eps=1e-5)
        self.identity_downsample = (
            nn.Sequential(
                nn.Conv2d(cin, channels, 1, stride, 0, bias=False),
                nn.BatchNorm2d(channels, eps=1e-5),
            )
            if project_identity else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.identity_downsample is not None:
            identity = self.identity_downsample(x)
        return torch.relu(y + identity)


def resnet_layer(num_blocks: int, cin: int, channels: int,
                 stride: int = 1) -> nn.Sequential:
    """`make_resnet_layers`: the first block projects the identity and
    carries the stride; the rest are plain."""
    blocks = [ResNetBlock(cin, channels, stride, project_identity=True)]
    blocks += [ResNetBlock(channels, channels) for _ in range(1, num_blocks)]
    return nn.Sequential(*blocks)
