"""The ResNet SuperPoint's convolutions (``family: resnet_superpoint``)."""

from __future__ import annotations

from typing import List

from port_bench.counts.convs import Conv


def _resnet_layer(name, blocks, cin, c, stride, h, w) -> List[Conv]:
    """`resnet_layer`: conv3x3 (the stride) + conv1x1 a block, and a 1x1
    projected identity on the first block."""
    out = [Conv(f"{name}.0.conv1", 3, cin, c, h, w, stride),
           Conv(f"{name}.0.identity", 1, cin, c, h, w, stride)]
    h, w = -(-h // stride), -(-w // stride)
    out.append(Conv(f"{name}.0.conv2", 1, c, c, h, w))
    for i in range(1, blocks):
        out += [Conv(f"{name}.{i}.conv1", 3, c, c, h, w),
                Conv(f"{name}.{i}.conv2", 1, c, c, h, w)]
    return out


def convs(cfg: dict, h: int, w: int) -> List[Conv]:
    """The ResNet SuperPoint's convolutions on an ``h x w`` image."""
    blocks = cfg["blocks_per_layer"]
    cin, stem = cfg["image_channels"], cfg["stem_channels"]
    out = [Conv("encoder.conv1", cfg["stem_kernel"], cin, stem, h, w, 2)]
    h, w = h // 4, w // 4                         # stem stride 2, max pool 2
    c1, c2 = cfg["encoder_channels"]
    out += _resnet_layer("encoder.layer1", blocks, stem, c1, 1, h, w)
    out += _resnet_layer("encoder.layer2", blocks, c1, c2, 2, h, w)
    h, w = h // 2, w // 2                         # the 1/8 grid
    out += _resnet_layer("detector.layer", blocks, c2, 65, 1, h, w)
    mid = cfg["descriptor_mid_channels"]
    out += _resnet_layer("descriptor.layer_in", blocks, c2, mid, 2, h, w)
    up = cfg["upsample_channels"]
    out.append(Conv("descriptor.up_sample", 3, mid, up, -(-h // 2), -(-w // 2),
                   transposed=True))
    out += _resnet_layer("descriptor.layer_out", blocks, up + c2,
                          cfg["descriptor_dim"], 1, h, w)
    return out
