"""The VGG SuperPoint's convolution epilogue: the CUDA kernel's wrapper and
its plain version.

Kernel: `feature_point_cnn_tpu_torch/csrc/conv_epilogue.cu`.  It replaces no
TPU kernel (XLA fuses a convolution's bias and ReLU into the convolution on
the TPU); it was added because PyTorch runs the bias add, ReLU and the 2x2
max-pool after cuDNN's convolution as three passes over its channels-last
bf16 output, 65% of the VGG forward's device time at B = 32, 480x640.  It
is bound by bytes: one read of the convolution's output and one write of
the result (118.6 MB in and 81.1 MB out a 480x640 frame: 59.6 us at 3.35
TB/s).

Plain version: `conv_epilogue_plain`, the three passes: the bias rounded
to the output's type and added, `torch.relu`, `F.max_pool2d(x, 2, 2)`,
then ``.float()`` for the 1x1 heads.  The kernel
equals it bit for bit.  The entry point `conv_epilogue` takes it for CPU
tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from feature_point_cnn_tpu_torch.ops.kernels import (
    check_launch,
    load_library,
    stream_of,
)
from feature_point_cnn_tpu_torch.utils import profiling

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "conv_epilogue_launch": (_I, (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
}
# the kernel's constants (`csrc/conv_epilogue.cu`)
_VEC = 8              # bf16 channels a 16-byte load carries
MAX_CHANNELS = 4096   # the bias the kernel holds in shared memory
_MAX_VECTORS = 0x7fffffff


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor, relu: bool = True,
                        pool: bool = False, out_float32: bool = False) -> torch.Tensor:
    """``act(y + bias)`` of a convolution's output ``y (B, C, H, W)``,
    computed without bias, and its ``(C,)`` bias: the bias rounded to y's
    type and added, then `torch.relu` with ``relu``, the 2x2 stride-2 max
    (floor) with ``pool``, and float32 with ``out_float32``."""
    x = y + bias.to(y.dtype).view(1, -1, 1, 1)
    if relu:
        x = torch.relu(x)
    if pool:
        x = F.max_pool2d(x, 2, 2)
    return x.float() if out_float32 else x


def _launch(y, bias, relu: bool, pool: bool, out_float32: bool) -> torch.Tensor:
    if y.dim() != 4 or y.dtype != torch.bfloat16 \
            or not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"y: want (B, C, H, W) bf16, dense channels-last, got {y.dtype} "
                         f"{tuple(y.shape)} strides {y.stride()}")
    b, c, h, w = y.shape
    if tuple(bias.shape) != (c,) or bias.device != y.device:
        raise ValueError(f"bias: want ({c},) on {y.device}, got {tuple(bias.shape)} "
                         f"on {bias.device}")
    if c > MAX_CHANNELS or (pool and c % _VEC) or y.data_ptr() % 16:
        raise ValueError(f"the epilogue kernel takes C <= {MAX_CHANNELS}, C % {_VEC} == 0 "
                         f"with the pool, and a 16-byte aligned y; got C = {c}, pool "
                         f"{pool}, y at {y.data_ptr():#x}")
    out_shape = (b, c, h // 2, w // 2) if pool else (b, c, h, w)
    vectors = (out_shape[0] * out_shape[2] * out_shape[3] * c + _VEC - 1) // _VEC
    if vectors > _MAX_VECTORS:
        raise ValueError(f"the epilogue kernel takes at most {_MAX_VECTORS} 8-channel "
                         f"vectors, got {vectors} for {tuple(y.shape)}")
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad):
        raise ValueError("the epilogue kernel carries no gradient: call it under "
                         "torch.no_grad() or torch.inference_mode()")
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty(out_shape, dtype=torch.float32 if out_float32 else torch.bfloat16,
                      device=y.device, memory_format=torch.channels_last)
    lib = load_library("conv_epilogue", _SIGNATURES)
    with torch.cuda.device(y.device):
        err = lib.conv_epilogue_launch(
            y.data_ptr(), bias.data_ptr(), out.data_ptr(), b, c, h, w,
            int(relu), int(pool), int(out_float32), stream_of(y),
        )
    check_launch(err, "conv_epilogue_launch")
    profiling.count("kernel.conv_epilogue")
    return out


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, relu: bool = True,
                  pool: bool = False, out_float32: bool = False) -> torch.Tensor:
    """`conv_epilogue_plain`'s result, channels-last: the kernel on CUDA
    tensors (bf16 ``y``, dense channels-last; no gradient), the plain
    passes on CPU ones.  The tracer's counter ``kernel.conv_epilogue``
    counts kernel calls."""
    if not y.is_cuda:
        return conv_epilogue_plain(y, bias, relu, pool, out_float32)
    return _launch(y, bias, relu, pool, out_float32)
