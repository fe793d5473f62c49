"""Multiply-adds of the models' convolutions, from a configuration file's
widths and the input size.  A FLOP is 2 multiply-adds; BatchNorm, ReLU,
pooling, the decode and everything after it are not counted (a few per
cent of the work), so a share of the peak computed from these is a lower
bound of the device's use.

A configuration's ``family`` names the module ``counts/<family>.py`` whose
``convs(cfg, h, w)`` lists its convolutions, so a new family is a new file.
Hand counts at 480x640 (the benchmark's tests hold these): the ResNet
SuperPoint 8.305 G multiply-adds (16.6 GFLOP) a frame, the VGG SuperPoint
26.05 G (52.1 GFLOP).
"""

from __future__ import annotations

import importlib
from typing import List, NamedTuple


class Conv(NamedTuple):
    name: str
    k: int          # square kernel
    cin: int
    cout: int
    h_in: int       # the input grid the kernel slides over (the
    w_in: int       # transposed conv: its input, each pixel scattering k*k)
    stride: int = 1
    transposed: bool = False

    @property
    def macs(self) -> int:
        if self.transposed:
            return self.k * self.k * self.cin * self.cout * self.h_in * self.w_in
        h_out = -(-self.h_in // self.stride)
        w_out = -(-self.w_in // self.stride)
        return self.k * self.k * self.cin * self.cout * h_out * w_out


def family_convs(cfg: dict, h: int, w: int) -> List[Conv]:
    """The convolutions of ``cfg``'s family on an ``h x w`` image, from
    ``counts/<family>.py``."""
    return importlib.import_module(f"port_bench.counts.{cfg['family']}").convs(cfg, h, w)


def forward_flops(cfg: dict, h: int, w: int) -> float:
    """FLOPs of one image's forward: 2 per multiply-add."""
    return 2.0 * sum(c.macs for c in family_convs(cfg, h, w))


def train_step_flops(cfg: dict, h: int, w: int, batch: int) -> float:
    """FLOPs of one joint training step: both views of ``batch`` images,
    forward and backward, the backward counted as twice the forward."""
    return 3.0 * 2 * batch * forward_flops(cfg, h, w)
