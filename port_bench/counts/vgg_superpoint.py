"""The VGG SuperPoint's convolutions (``family: vgg_superpoint``)."""

from __future__ import annotations

from typing import List

from port_bench.counts.convs import Conv


def convs(cfg: dict, h: int, w: int) -> List[Conv]:
    """The VGG SuperPoint's convolutions on an ``h x w`` image: conv pairs
    with a 2x2 pool between pairs, then two heads of a 3x3 and a 1x1."""
    out, cin = [], cfg["image_channels"]
    pairs = cfg["encoder_channels"]
    for i, c in enumerate(pairs):
        out += [Conv(f"encoder_conv{i}_a", 3, cin, c, h, w),
                  Conv(f"encoder_conv{i}_b", 3, c, c, h, w)]
        cin = c
        if i != len(pairs) - 1:
            h, w = h // 2, w // 2
    head = cfg["head_channels"]
    out += [Conv("detector_conv_a", 3, cin, head, h, w),
              Conv("detector_conv_b", 1, head, 65, h, w),
              Conv("descriptor_conv_a", 3, cin, head, h, w),
              Conv("descriptor_conv_b", 1, head, cfg["descriptor_dim"], h, w)]
    return out
