"""Fused decode + threshold: the CUDA kernel's wrapper and its plain version.

Kernel: `feature_point_cnn_tpu_torch/csrc/decode_threshold.cu`, which
replaces the TPU kernel `feature_point_cnn_tpu/ops/pallas/decode.py:
decode_threshold_pallas`.  It is bound by bytes (1.25 MB of logits read and
1.23 MB of map written per 480x640 frame, about 0.74 us at 3.35 TB/s): one
warp per cell reads the logits once and writes the thresholded map once,
so the softmax never reaches device memory.

Plain version: `softmax65` + `restore_prob_map` + threshold.  The wrapper
takes it only for a CPU tensor; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from feature_point_cnn_tpu_torch.ops.detection import softmax65
from feature_point_cnn_tpu_torch.ops.kernels import (
    check_launch,
    load_library,
    stream_of,
)
from feature_point_cnn_tpu_torch.ops.labels import restore_prob_map

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "decode_threshold_launch": (_I, (_P, _P, _I, _I, _I, ctypes.c_float, _P)),
}


def decode_threshold_plain(
    logits: torch.Tensor, cell: int, threshold: float
) -> torch.Tensor:
    """``(B, Hc, Wc, 65)`` logits -> ``(B, H, W)`` map, ``where(p >= t, p,
    0)`` of the decoded probabilities."""
    prob = restore_prob_map(softmax65(logits), cell)
    return torch.where(prob >= threshold, prob, 0.0)


def decode_threshold_cuda(
    logits: torch.Tensor, cell: int, threshold: float
) -> torch.Tensor:
    """The decode kernel on a CUDA tensor, its plain version on a CPU one.
    ``decode_threshold_cuda.launches`` counts kernel runs."""
    if not logits.is_cuda:
        return decode_threshold_plain(logits, cell, threshold)
    if cell != 8 or logits.dim() != 4 or logits.shape[-1] != 65:
        raise ValueError(f"the decode kernel takes cell 8 and (B, Hc, Wc, 65) "
                         f"logits, got cell {cell}, {tuple(logits.shape)}")
    if logits.dtype != torch.float32:
        raise ValueError(f"want float32 logits, got {logits.dtype}")
    logits = logits.contiguous()
    b, hc, wc, _ = logits.shape
    lib = load_library("decode_threshold", _SIGNATURES)
    out = torch.empty((b, hc * cell, wc * cell), dtype=torch.float32,
                      device=logits.device)
    with torch.cuda.device(logits.device):
        err = lib.decode_threshold_launch(
            logits.data_ptr(), out.data_ptr(), b, hc, wc, float(threshold),
            stream_of(logits),
        )
    check_launch(err, "decode_threshold_launch")
    decode_threshold_cuda.launches += 1
    return out


decode_threshold_cuda.launches = 0
