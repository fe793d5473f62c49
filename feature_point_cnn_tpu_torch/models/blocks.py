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
`running_var`.  Under a data group (`parallel/collectives.py`) the train-mode
statistics are the global batch's, as Flax's mean over a sharded batch
axis is (`_GroupBatchNorm`): one all-reduce of the per-channel count, sum
and sum of squares, then the global mean and the biased global variance,
which is also what `running_var` takes (the unbiased variance rescaled by
``(n - 1) / n`` over the global ``n``).  `nn.SyncBatchNorm` would store the
unbiased variance.

Under a width group (`parallel/spatial.py`) the convolutions run
W-sharded, exchanging their halos with the ranks that hold them; BatchNorm
in eval mode is per channel and needs nothing (an empty block stays
empty), and in train mode takes the whole image's statistics by the same
`_GroupBatchNorm` over the width group (`collectives.group` returns it
there): a rank's block, empty ones included, adds its count and sums to
the forward's all-reduce and its sums of ``dy`` and ``dy xhat`` to the
backward's.  A data group set inside a width group raises.

``fold_bn=True`` is the serving topology (`blocks.py:163-228` of the JAX
package): every convolution carries a bias and every BatchNorm is an
``nn.Identity``, so `models/fold.py::fold_batchnorm`'s ``state_dict`` loads
under the same names.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from feature_point_cnn_tpu_torch.device import constant
from feature_point_cnn_tpu_torch.parallel import collectives, spatial


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if spatial.group() is not None:
            return spatial.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                                  self.padding, self.dilation, self.groups)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor,
                block_width: Optional[int] = None) -> torch.Tensor:
        """``block_width``: under a width group, the block width of the
        equally sharded grid the output joins (`parallel/spatial.py`);
        unused without one."""
        if spatial.group() is not None:
            return spatial.conv_transpose2d(
                x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride,
                self.padding, self.output_padding, self.groups, self.dilation,
                block_width)
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
            if x.is_cuda and torch.compiler.is_exporting():
                return self._exported_eval(x)
            return super().forward(x)
        g = collectives.group()
        if g is not None:
            return self._group_forward(x, g)
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

    def _exported_eval(self, x: torch.Tensor) -> torch.Tensor:
        """Eval BatchNorm as a program exported on CUDA carries it: the
        arithmetic of PyTorch's CUDA kernel for channels-last activations,
        ``fma(w * (x - mean), rsqrt(var + eps), b)`` in float32, rounded
        once to x's type (Inductor lowers `torch.addcmul` to a fused
        multiply-add; `probe_torch_batchnorm.py` shows both on the card).
        Inductor's own BatchNorm, ``(x - mean) * invstd * w + b`` unfused,
        rounds otherwise, and a bf16 package would then move keypoints that
        the eager frame keeps.  A CPU export keeps BatchNorm itself, which
        runs the eager CPU kernel.  (Under ``torch.compile`` torch 2.11
        reports `is_exporting` too, and compiles this form.)"""
        c = (1, -1, 1, 1)
        centred = self.weight.view(c) * (x.float() - self.running_mean.view(c))
        y = torch.addcmul(self.bias.view(c), centred,
                          torch.rsqrt(self.running_var + self.eps).view(c))
        return y.to(x.dtype)

    def _group_forward(self, x: torch.Tensor, g) -> torch.Tensor:
        y, mean, var = _GroupBatchNorm.apply(x, self.weight, self.bias, self.eps, g)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return y


class _GroupBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the group's global batch, ``(N, C, H, W)``
    (a data group's rows, or a width group's blocks of columns).

    Forward: ONE all-reduce of the per-channel count, sum and sum of
    squares (accumulated in float64, so ``E[x^2] - E[x]^2`` does not lose
    the variance of a channel whose mean is large); the global mean and
    biased variance then normalise in float32 (float64 for float64
    input).  Backward: the gradient through that all-reduce, written in
    the form that does not cancel (``dx = w / sigma (dy - mean(dy) - xhat
    mean(dy xhat))``, as in every BatchNorm backward): one all-reduce of
    the per-channel sums of ``dy`` and ``dy xhat``.  The weight's and
    bias's gradients stay this rank's sums, which the step's gradient
    all-reduce adds up.  Returns ``(y, mean, var)``; the statistics carry
    no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, g):
        c = x.shape[1]
        dims = (0, 2, 3)
        xf = x if x.dtype == torch.float64 else x.to(torch.float32)
        stats = torch.cat([
            xf.sum(dim=dims, dtype=torch.float64),
            (xf * xf).sum(dim=dims, dtype=torch.float64),
            constant((float(x.numel() // c),), x.device, torch.float64)])
        stats = collectives.all_sum_(stats, g)
        n = stats[2 * c]
        mean64 = stats[:c] / n
        mean = mean64.to(xf.dtype)
        var = (stats[c:2 * c] / n - mean64 * mean64).clamp_min(0.0).to(xf.dtype)
        invstd = torch.rsqrt(var + eps)
        y = (xf - mean[None, :, None, None]) * (invstd * weight)[None, :, None, None] \
            + bias[None, :, None, None]
        # n stays on the device: a step captured in a CUDA graph reads nothing back
        ctx.save_for_backward(x, weight, mean, invstd, n.to(xf.dtype))
        ctx.group = g
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        dims = (0, 2, 3)
        dyf = dy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean[None, :, None, None]) * invstd[None, :, None, None]
        local = torch.cat([dyf.sum(dim=dims), (dyf * xhat).sum(dim=dims)])
        total = collectives.all_sum_(local, ctx.group)
        mean_dy = (total[:c] / n)[None, :, None, None]
        mean_dy_xhat = (total[c:] / n)[None, :, None, None]
        dx = (dyf - mean_dy - xhat * mean_dy_xhat) * (weight * invstd)[None, :, None, None]
        return dx.to(x.dtype), local[c:], local[:c], None, None


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
