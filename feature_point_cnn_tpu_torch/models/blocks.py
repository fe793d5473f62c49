"""ResNet building blocks of the SuperPoint backbone, NCHW.

Same topology and parameter names as the reference's PyTorch blocks, which
is also what the JAX package's `models/blocks.py:163-228` mirrors:
conv3x3-BN-ReLU + conv1x1-BN, and on the first block of a layer a projected
identity (1x1 conv + BN, the ``identity_downsample`` Sequential) that also
carries the stride.  BatchNorm uses eps 1e-5 (`blocks.py:46-56`).

The convolutions cast their weights to the activations' type at each call,
so a training model keeps float32 parameters and still computes in bf16 (a
serving model stores them in bf16 already and the cast is a no-op).  In
train mode `BatchNorm2d` keeps Flax's running statistics, not PyTorch's: the
**biased** batch variance with momentum 0.1 (`nn.BatchNorm2d` would store
the unbiased one, n/(n-1) larger).  The batch statistics are computed once,
by `F.batch_norm` itself, and the variance is rescaled on its way into
`running_var`.

``fold_bn=True`` is the serving topology (`blocks.py:163-228` of the JAX
package): every convolution carries a bias and every BatchNorm is an
``nn.Identity``, so `models/fold.py::fold_batchnorm`'s ``state_dict`` loads
under the same names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride,
            self.padding, self.output_padding, self.groups, self.dilation,
        )


class BatchNorm2d(nn.BatchNorm2d):
    """eps 1e-5, momentum 0.1; float32 parameters and statistics whatever
    the activations' type."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # one statistics pass: with momentum 1 `F.batch_norm` leaves the batch
        # mean and the unbiased batch variance in the two scratch buffers
        n = x.numel() // x.shape[1]
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var * ((n - 1) / n), self.momentum)
            self.num_batches_tracked += 1
        return y


def batch_norm(channels: int, fold_bn: bool) -> nn.Module:
    """A live BatchNorm, or the identity where it is folded away."""
    return nn.Identity() if fold_bn else BatchNorm2d(channels)


class ResNetBlock(nn.Module):
    def __init__(self, cin: int, channels: int, stride: int = 1,
                 project_identity: bool = False, fold_bn: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, channels, 3, stride, 1, bias=fold_bn)
        self.bn1 = batch_norm(channels, fold_bn)
        self.conv2 = Conv2d(channels, channels, 1, 1, 0, bias=fold_bn)
        self.bn2 = batch_norm(channels, fold_bn)
        self.identity_downsample = (
            nn.Sequential(
                Conv2d(cin, channels, 1, stride, 0, bias=fold_bn),
                batch_norm(channels, fold_bn),
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
                 stride: int = 1, fold_bn: bool = False) -> nn.Sequential:
    """`make_resnet_layers`: the first block projects the identity and
    carries the stride; the rest are plain."""
    blocks = [ResNetBlock(cin, channels, stride, project_identity=True,
                          fold_bn=fold_bn)]
    blocks += [ResNetBlock(channels, channels, fold_bn=fold_bn)
               for _ in range(1, num_blocks)]
    return nn.Sequential(*blocks)
