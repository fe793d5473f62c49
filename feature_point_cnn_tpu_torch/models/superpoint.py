"""ResNet-backbone SuperPoint as PyTorch modules (NCHW inside).

Port of `feature_point_cnn_tpu/models/superpoint.py:37-167`.  Total stride
8 == cell size: conv7x7/2 + maxpool3/2 + layer2/2.  The public forward keeps
the JAX package's layouts: image ``(B, H, W, 3)`` in [0, 1] in, and
``prob (B, H, W)``, ``desc (B, Hc, Wc, D)``, ``logits (B, Hc, Wc, 65)``, all
float32, out.

``compute_dtype="bfloat16"`` feeds the convolutions bf16 activations and
bf16 weights; BatchNorm keeps float32 parameters and statistics (PyTorch's
mixed-type BatchNorm computes in float32 and returns bf16), as Flax
promotes its BatchNorm to float32 on the JAX side.  A serving model stores
the convolution weights in bf16; a training model (``float32_params=True``)
keeps float32 master parameters and casts them at each forward, as the JAX
step does (`train/steps.py:15`).

``config.fold_bn`` builds the serving topology (`superpoint.py:43-63` of
the JAX package): convolutions with a bias, no BatchNorm; load it with
`models/fold.py::fold_batchnorm` of a live-BN ``state_dict``.  It cannot
train.

Under ``parallel.spatial.width_group(g)`` the forward (eval, or train
mode, whose BatchNorm takes the whole image's statistics) takes each
rank's block of columns (`parallel/mesh.py::shard_images_spatial`) and
returns that block of all three outputs: ``prob (B, H, W/d)``, ``desc (B,
Hc, Wc/d, D)`` and ``logits (B, Hc, Wc/d, 65)``.  The convolutions and the
max pool exchange their halos with the ranks that hold them; gradients
flow back through the exchanges.  At 8 px a shard the descriptor head's
1/16 blocks of some ranks are empty, and those ranks' ops there return
empty blocks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.models.blocks import (
    Conv2d,
    ConvTranspose2d,
    batch_norm,
    resnet_layer,
)
from feature_point_cnn_tpu_torch.ops.detection import decode_prob_map
from feature_point_cnn_tpu_torch.parallel import spatial

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Encoder(nn.Module):
    """conv7x7/2(3->64)+BN+ReLU+maxpool3/2, then residual layers 64/1 and
    128/2."""

    def __init__(self, cin: int, fold_bn: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, 64, 7, 2, 3, bias=fold_bn)
        self.bn1 = batch_norm(64, fold_bn)
        self.layer1 = resnet_layer(2, 64, 64, 1, fold_bn)
        self.layer2 = resnet_layer(2, 64, 128, 2, fold_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        if spatial.group() is not None:
            x = spatial.max_pool2d(x, 3, 2, 1)
        else:
            x = nn.functional.max_pool2d(x, 3, 2, 1)
        return self.layer2(self.layer1(x))


class Detector(nn.Module):
    """Residual layer 128 -> 65 logits; its input is the embedding the
    descriptor head consumes."""

    def __init__(self, fold_bn: bool = False):
        super().__init__()
        self.layer = resnet_layer(2, 128, 65, 1, fold_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class Descriptor(nn.Module):
    """128 -> 256/2 residual layer, transposed conv back to 1/8 resolution,
    concat with the detector embedding, residual layer -> D."""

    def __init__(self, descriptor_dim: int, fold_bn: bool = False):
        super().__init__()
        self.layer_in = resnet_layer(2, 128, 256, 2, fold_bn)
        self.up_sample = ConvTranspose2d(
            256, 128, 3, stride=2, padding=1, output_padding=1
        )
        self.bn = batch_norm(128, fold_bn)
        self.layer_out = resnet_layer(2, 256, descriptor_dim, 1, fold_bn)

    def forward(self, x: torch.Tensor, embeddings: torch.Tensor) -> torch.Tensor:
        hc, wc = embeddings.shape[2:]
        y = torch.relu(self.bn(self.up_sample(self.layer_in(x), wc)))
        # for odd Hc/Wc the doubling transposed conv overshoots by one
        # row/col: crop to the embedding grid (superpoint.py:108-112).  W-sharded,
        # the overshoot lies on the last rank alone, and only it crops
        y = y[:, :, :hc, :wc]
        return self.layer_out(torch.cat([y, embeddings], dim=1))


class SuperPoint(nn.Module):
    def __init__(self, config: SuperPointConfig = SuperPointConfig(),
                 generator: Optional[torch.Generator] = None,
                 float32_params: bool = False):
        super().__init__()
        self.config = config
        fold = config.fold_bn
        self.encoder = Encoder(config.image_channels, fold)
        self.detector = Detector(fold)
        self.descriptor = Descriptor(config.descriptor_dim, fold)
        self.reset_parameters(generator)
        self.compute_dtype = _DTYPES[config.compute_dtype]
        if self.compute_dtype != torch.float32 and not float32_params:
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    m.to(self.compute_dtype)

    def train(self, mode: bool = True) -> "SuperPoint":
        if mode and self.config.fold_bn:
            raise ValueError("a fold_bn model has no BatchNorm to train; "
                             "train the live-BN model and fold it at load")
        return super().train(mode)

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
