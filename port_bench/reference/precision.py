"""Arithmetic of the plain references: float32 with TF32 off, and the
control's lower precision.

The configurations compute in bf16, so the control is the reference with
every convolution's operands rounded to fp8 (e4m3, scaled by the tensor's
largest magnitude, as fp8 inference scales them) and multiplied in
float32: an fp8 tensor-core product accumulates in float32 as well.  In a
training step it is fp8 training as it is usually done: the operands
e4m3 in the forward (the gradient passes the rounding straight through),
and each convolution's output gradient rounded to e5m2 under its own
per-tensor scale before the backward's products.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale, back in float32;
    the gradient passes straight through."""
    xd = x.detach()
    rounded = _round(xd, torch.float8_e4m3fn, E4M3_MAX)
    return x + (rounded - xd) if x.requires_grad else rounded


class _GradE5M2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8_grad(y: torch.Tensor) -> torch.Tensor:
    """``y`` unchanged; its gradient rounded to e5m2 on the way back."""
    return _GradE5M2.apply(y) if y.requires_grad else y


class Rounding:
    """A convolution's rounding: ``self(x)`` of its operands, ``out(y)``
    of its output (in the backward)."""

    def __init__(self, operand, output):
        self.operand, self.out = operand, output

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.operand(x)


QUANT = {"float32": Rounding(exact, exact), "fp8": Rounding(fp8, fp8_grad)}


def float32_mode() -> None:
    """No TF32 in float32 products or convolutions (the references')."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
