"""Exact-greedy grid NMS: the CUDA kernel's wrapper and its plain version.

Kernel: `feature_point_cnn_tpu_torch/csrc/grid_nms.cu`, which replaces the
TPU kernel `feature_point_cnn_tpu/ops/pallas/nms.py:grid_nms_pallas`.  It is
bound by bytes (each frame's map read once and written once: 2.46 MB, about
0.73 us per 480x640 frame at 3.35 TB/s).  One launch a call runs the whole
convergence loop on the device: a thread-block cluster holds a frame, each
CTA a band of rows in its shared memory, reading its neighbours' halo rows
through distributed shared memory (the source note has the design).  Maps
too large for the cluster's shared memory keep the bands in a device-memory
scratch instead (`nms_layout`).

Plain version: the separable max-pool loop of `nms.py:41-109` on the same
priority key; it is also the port's `ops/detection.py:grid_nms`.  The
wrapper takes it for a CPU tensor; for a CUDA one it calls the custom op
``fpc::grid_nms``, which launches the kernel or raises; `torch.export`
keeps the op in the graph.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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
    "grid_nms_launch": (
        _I, (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
    ),
    "grid_nms_max_active_clusters": (_I, (_I, _I, _I, _I, _I, ctypes.POINTER(_I))),
}
# the kernel's constants (`csrc/grid_nms.cu`)
_MAX_CLUSTER = 8         # CTAs a cluster, the portable limit
_SMEM_LIMIT = 232448     # dynamic shared memory a CTA may use
_SMEM_RESERVE = 64       # the convergence slot and the mbarrier
_STATE_BYTES = 5         # a pixel's remaining key (4 B) and flags (1 B)
_STRIP = 128             # columns a warp task covers


class NmsLayout(NamedTuple):
    cluster: int           # CTAs holding one frame
    rows_per_band: int     # rows of the tallest band
    smem_bytes: int        # dynamic shared memory a CTA
    band_in_shared: bool   # False: the state lies in a device-memory scratch


def nms_layout(h: int, w: int, dist_thresh: int) -> NmsLayout:
    """The kernel's launch for ``(H, W)`` maps at radius ``dist_thresh``
    (the batch only sets the number of clusters).  CTA k of a cluster owns
    rows ``[k*H//C, (k+1)*H//C)``; C halves from 8 until every band is at
    least ``max(r, 1)`` rows tall, so a halo reaches one neighbour only.
    A CTA's shared memory holds 64 B, two activity bytes and a 2-byte list
    entry a (row, 128-column strip) of its band, and the band's state when the tallest fits the
    232,448 B a CTA may have (up to ~370 K pixels a frame at C = 8); else the
    state lies in a device-memory scratch of 5 B a pixel."""
    cluster = _MAX_CLUSTER
    while cluster > 1 and h // cluster < max(dist_thresh, 1):
        cluster //= 2
    rows = -(-h // cluster)
    base = _SMEM_RESERVE + -(-4 * rows * -(-w // _STRIP) // 16) * 16
    in_shared = base + _STATE_BYTES * rows * w <= _SMEM_LIMIT
    return NmsLayout(cluster, rows, base + (_STATE_BYTES * rows * w if in_shared else 0),
                     in_shared)


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


def _round(remaining: torch.Tensor, keep: torch.Tensor, rounds: torch.Tensor,
           dist_thresh: int):
    """One suppression round on the plain version's state: the remaining
    priority keys, the kept mask, and each frame's rounds (counted while
    the frame holds a candidate as the round begins)."""
    left = (remaining > 0.0).flatten(1).any(1)
    winners = (remaining > 0.0) & (
        remaining == _maxpool_separable(remaining, dist_thresh)
    )
    dead = _maxpool_separable(winners.float(), dist_thresh) > 0.0
    return (torch.where(dead, 0.0, remaining), keep | winners,
            rounds + left.to(torch.int32))


def _plain_nms(scores: torch.Tensor, dist_thresh: int, num_iters: int = 0):
    """`grid_nms_plain` and each frame's rounds ``(B,)`` int32."""
    state = (nms_priority_key(scores, dist_thresh),
             torch.zeros(scores.shape, dtype=torch.bool, device=scores.device),
             torch.zeros(scores.shape[:1], dtype=torch.int32, device=scores.device))

    def body(*s):
        return _round(*s, dist_thresh)

    if num_iters > 0:
        for _ in range(num_iters):
            state = body(*state)
    elif torch.compiler.is_exporting():
        # an exported program carries the data-dependent loop as a while_loop
        from torch._higher_order_ops.while_loop import while_loop

        state = while_loop(lambda remaining, *_: (remaining > 0.0).any(), body, state)
    else:
        for _ in range(scores.shape[-2] * scores.shape[-1]):
            if not bool((state[0] > 0.0).any()):
                break
            state = body(*state)
    return torch.where(state[1], scores, 0.0), state[2]


def grid_nms_plain(
    scores: torch.Tensor, dist_thresh: int, num_iters: int = 0
) -> torch.Tensor:
    """``(B, H, W)`` thresholded scores -> the kept scores, 0 elsewhere.

    Greedy NMS as iterated window-max suppression on the priority key
    (`feature_point_cnn_tpu/ops/detection.py:104-167`): each round keeps
    every remaining candidate that is the maximum of its window, then
    zeroes the windows of the kept points.  ``num_iters=0`` runs rounds
    until no candidate is left (exact greedy at any chain depth, capped at
    H*W rounds; under `torch.export` a ``while_loop``); a positive value
    runs that many rounds.
    """
    return _plain_nms(scores, dist_thresh, num_iters)[0]


def plain_rounds(scores: torch.Tensor, dist_thresh: int) -> list:
    """Each frame's rounds in `grid_nms_plain`'s loop to convergence: what
    the kernel reports in ``grid_nms_cuda.last_rounds``."""
    return _plain_nms(scores, dist_thresh)[1].tolist()


# the op's schema; `csrc/serve/fpc_ops.cc` defines the same string for the
# native host, which registers the op without Python
SCHEMA = "(Tensor scores, int dist_thresh) -> (Tensor, Tensor)"


@torch.library.custom_op("fpc::grid_nms", mutates_args=(), device_types="cuda",
                         schema=SCHEMA)
def grid_nms_op(scores: torch.Tensor, dist_thresh: int):
    """``fpc::grid_nms``: ``(kept scores, rounds (B,) int32)`` of the
    kernel, for CUDA tensors alone."""
    if scores.dim() != 3 or scores.dtype != torch.float32:
        raise ValueError(f"want (B, H, W) float32, got {tuple(scores.shape)} "
                         f"{scores.dtype}")
    if not 0 <= dist_thresh <= 7:
        raise ValueError("the NMS kernel supports 0 <= dist_thresh <= 7")
    scores = scores.contiguous()
    b, h, w = scores.shape
    layout = nms_layout(h, w, dist_thresh)
    lib = load_library("grid_nms", _SIGNATURES)
    out = torch.empty_like(scores)
    rounds = torch.empty(b, dtype=torch.int32, device=scores.device)
    if h * w == 0:
        rounds.zero_()
    key = flag = None
    if not layout.band_in_shared:
        scratch = torch.empty(_STATE_BYTES * scores.numel(), dtype=torch.uint8,
                              device=scores.device)
        key = scratch.data_ptr()
        flag = key + 4 * scores.numel()
    with torch.cuda.device(scores.device):
        err = lib.grid_nms_launch(
            scores.data_ptr(), out.data_ptr(), key, flag, rounds.data_ptr(),
            b, h, w, int(dist_thresh), layout.cluster, int(layout.band_in_shared),
            stream_of(scores),
        )
    check_launch(err, "grid_nms_launch")
    profiling.count("kernel.grid_nms")
    grid_nms_cuda.last_rounds = rounds
    return out, rounds


@grid_nms_op.register_fake
def _(scores: torch.Tensor, dist_thresh: int):
    return (torch.empty_like(scores),
            scores.new_empty(scores.shape[:1], dtype=torch.int32))


def grid_nms_cuda(scores: torch.Tensor, dist_thresh: int,
                  num_iters: int = 0) -> torch.Tensor:
    """The NMS kernel on a CUDA tensor (through ``fpc::grid_nms``), always
    to convergence, whatever ``num_iters`` says; `grid_nms_plain` with
    ``num_iters`` on a CPU one.

    The tracer's counter ``kernel.grid_nms`` counts kernel runs.
    ``last_rounds`` is the latest kernel run's ``(B,)`` int32 device tensor
    of suppression rounds a frame; it is written on the stream, so read it
    after a synchronise.
    Nothing is read back on the host.
    """
    if not scores.is_cuda:
        return grid_nms_plain(scores, dist_thresh, num_iters)
    return grid_nms_op(scores, dist_thresh)[0]


grid_nms_cuda.last_rounds = None


def max_active_clusters(h: int, w: int, dist_thresh: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` for the kernel's launch on
    ``(H, W)`` maps (current device): how many frames run at once."""
    layout = nms_layout(h, w, dist_thresh)
    lib = load_library("grid_nms", _SIGNATURES)
    count = ctypes.c_int(0)
    check_launch(lib.grid_nms_max_active_clusters(
        h, w, int(dist_thresh), layout.cluster, int(layout.band_in_shared),
        ctypes.byref(count)), "grid_nms_max_active_clusters")
    return count.value
