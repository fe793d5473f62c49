"""Exact-greedy grid NMS: the CUDA kernel's wrapper and its plain version.

Kernel: `feature_point_cnn_tpu_torch/csrc/grid_nms.cu`, which replaces the
TPU kernel `feature_point_cnn_tpu/ops/pallas/nms.py:grid_nms_pallas`.  It is
bound by bytes (each frame's map read once and written once: 2.46 MB, about
0.73 us per 480x640 frame at 3.35 TB/s); the map stays in device memory and
each suppression round is two tiled launches, with the host reading a
convergence flag between rounds (the source note has the design).

Plain version: the separable max-pool loop of `nms.py:41-109` on the same
priority key; it is also the port's `ops/detection.py:grid_nms`.  The
wrapper takes it only for a CPU tensor; for a CUDA tensor it launches the
kernel or raises.
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

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "grid_nms_launch": (
        _I, (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.POINTER(_I), _P)
    ),
}


def nms_priority_key(scores: torch.Tensor, dist_thresh: int) -> torch.Tensor:
    """Pack a strict total order for NMS into the score mantissa
    (`feature_point_cnn_tpu/ops/detection.py:72-101`, bit for bit).

    Scores >= 0 order like their float32 bit patterns, so the low mantissa
    byte is replaced, in the integer domain, by a position priority unique
    within any ``(2d+1)^2`` window.  Bit-identical plateaus then resolve to
    one survivor per window, as sequential greedy NMS would.
    """
    if not 0 <= dist_thresh <= 7:
        raise ValueError("position priority needs (2d+1)^2 <= 256")
    h, w = scores.shape[-2:]
    win = 2 * dist_thresh + 1
    yy = torch.arange(h, device=scores.device)[:, None] % win
    xx = torch.arange(w, device=scores.device)[None, :] % win
    prio = (255 - (yy * win + xx)).to(torch.int32)
    bits = scores.to(torch.float32).contiguous().view(torch.int32)
    key = ((bits & ~0xFF) | prio).view(torch.float32)
    return torch.where(scores > 0.0, key, 0.0)


def _maxpool_separable(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 window max of a ``(B, H, W)`` map, rows then columns,
    -inf padded."""
    k = 2 * radius + 1
    y = F.max_pool2d(x[:, None], (k, 1), stride=1, padding=(radius, 0))
    return F.max_pool2d(y, (1, k), stride=1, padding=(0, radius))[:, 0]


def grid_nms_plain(
    scores: torch.Tensor, dist_thresh: int, num_iters: int = 0
) -> torch.Tensor:
    """``(B, H, W)`` thresholded scores -> the kept scores, 0 elsewhere.

    Greedy NMS as iterated window-max suppression on the priority key
    (`feature_point_cnn_tpu/ops/detection.py:104-167`): each round keeps
    every remaining candidate that is the maximum of its window, then
    zeroes the windows of the kept points.  ``num_iters=0`` runs rounds
    until no candidate is left (exact greedy at any chain depth, capped at
    H*W rounds); a positive value runs that many rounds.
    """
    remaining = nms_priority_key(scores, dist_thresh)
    keep = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    cap = num_iters if num_iters > 0 else scores.shape[-2] * scores.shape[-1]
    for _ in range(cap):
        if num_iters == 0 and not bool((remaining > 0.0).any()):
            break
        winners = (remaining > 0.0) & (
            remaining == _maxpool_separable(remaining, dist_thresh)
        )
        keep |= winners
        dead = _maxpool_separable(winners.float(), dist_thresh) > 0.0
        remaining = torch.where(dead, 0.0, remaining)
    return torch.where(keep, scores, 0.0)


def grid_nms_cuda(scores: torch.Tensor, dist_thresh: int) -> torch.Tensor:
    """The NMS kernel on a CUDA tensor, its plain version on a CPU one.

    ``grid_nms_cuda.launches`` counts kernel runs; ``last_rounds`` holds the
    suppression rounds of the latest run.
    """
    if not scores.is_cuda:
        return grid_nms_plain(scores, dist_thresh)
    if scores.dim() != 3 or scores.dtype != torch.float32:
        raise ValueError(f"want (B, H, W) float32, got {tuple(scores.shape)} "
                         f"{scores.dtype}")
    if not 0 <= dist_thresh <= 7:
        raise ValueError("the NMS kernel supports 0 <= dist_thresh <= 7")
    scores = scores.contiguous()
    b, h, w = scores.shape
    lib = load_library("grid_nms", _SIGNATURES)
    out = torch.empty_like(scores)
    rem = torch.empty_like(scores)
    win = torch.empty(scores.shape, dtype=torch.uint8, device=scores.device)
    keep = torch.empty_like(win)
    flag = torch.empty(1, dtype=torch.int32, device=scores.device)
    rounds = ctypes.c_int(0)
    with torch.cuda.device(scores.device):
        err = lib.grid_nms_launch(
            scores.data_ptr(), out.data_ptr(), rem.data_ptr(), win.data_ptr(),
            keep.data_ptr(), flag.data_ptr(), b, h, w, int(dist_thresh),
            ctypes.byref(rounds), stream_of(scores),
        )
    check_launch(err, "grid_nms_launch")
    grid_nms_cuda.launches += 1
    grid_nms_cuda.last_rounds = rounds.value
    return out


grid_nms_cuda.launches = 0
grid_nms_cuda.last_rounds = 0
