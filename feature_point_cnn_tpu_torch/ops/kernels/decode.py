"""Fused decode + threshold: the CUDA kernel's wrapper and its plain version.

Kernel: `feature_point_cnn_tpu_torch/csrc/decode_threshold.cu`, which
replaces the TPU kernel `feature_point_cnn_tpu/ops/pallas/decode.py:
decode_threshold_pallas`.  It is bound by bytes (1.25 MB of logits read and
1.23 MB of map written per 480x640 frame, about 0.74 us at 3.35 TB/s).  A
block takes a segment of up to 80 cells of one cell row (a whole 640-px
row): one bulk copy brings its logits into shared memory, a warp a cell
takes the softmax there, and the thresholded (8, cells*8) tile leaves as 8
contiguous output rows.  The softmax never reaches device memory.

Plain version: `softmax65` + `restore_prob_map` + threshold.  The wrapper
takes it for a CPU tensor; for a CUDA one it calls the custom op
``fpc::decode_threshold``, which launches the kernel or raises.
`torch.export` keeps the op in the graph, so an exported program reaches
the kernel as eager code does.
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
from feature_point_cnn_tpu_torch.utils import profiling

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "decode_threshold_launch": (_I, (_P, _P, _I, _I, _I, ctypes.c_float, _P)),
}
# the kernel's constants (`csrc/decode_threshold.cu`)
_CHANNELS = 65      # 64 cell pixels and the dustbin
_SEG_CELLS = 80     # cells a block decodes at most
_TILE_PAD = 8       # floats of padding per row of the output tile
_BAR_BYTES = 16     # the mbarrier's room


def cell_row_layout(wc: int) -> dict:
    """How the kernel cuts a cell row of ``wc`` cells: cells a block
    (``seg``), blocks a cell row (``nseg``), a block's dynamic shared memory
    (the source's ``segment_smem_bytes``), and whether its logits arrive by
    one bulk copy (``wc % 4 == 0``: every segment's run starts and ends on
    16 bytes)."""
    seg = min(wc, _SEG_CELLS)
    logits_floats = -(-seg * _CHANNELS // 4) * 4
    return dict(seg=seg, nseg=-(-wc // seg),
                smem_bytes=_BAR_BYTES + 4 * logits_floats + 4 * 8 * (seg * 8 + _TILE_PAD),
                bulk=wc % 4 == 0)


def decode_threshold_plain(
    logits: torch.Tensor, cell: int, threshold: float
) -> torch.Tensor:
    """``(B, Hc, Wc, 65)`` logits -> ``(B, H, W)`` map, ``where(p >= t, p,
    0)`` of the decoded probabilities."""
    prob = restore_prob_map(softmax65(logits), cell)
    return torch.where(prob >= threshold, prob, 0.0)


# the op's schema; `csrc/serve/fpc_ops.cc` defines the same string for the
# native host, which registers the op without Python
SCHEMA = "(Tensor logits, int cell, float threshold) -> Tensor"


@torch.library.custom_op("fpc::decode_threshold", mutates_args=(),
                         device_types="cuda", schema=SCHEMA)
def decode_threshold_op(logits: torch.Tensor, cell: int,
                        threshold: float) -> torch.Tensor:
    """``fpc::decode_threshold``: the kernel, for CUDA tensors alone.
    Exported programs hold this op, so eager code and an exported program
    reach the kernel through one route."""
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
    profiling.count("kernel.decode_threshold")
    return out


@decode_threshold_op.register_fake
def _(logits: torch.Tensor, cell: int, threshold: float) -> torch.Tensor:
    b, hc, wc, _ = logits.shape
    return logits.new_empty((b, hc * cell, wc * cell), dtype=torch.float32)


def decode_threshold_cuda(
    logits: torch.Tensor, cell: int, threshold: float
) -> torch.Tensor:
    """The decode kernel on a CUDA tensor (through ``fpc::decode_threshold``),
    `decode_threshold_plain` on a CPU one.  The tracer's counter
    ``kernel.decode_threshold`` counts kernel runs."""
    if not logits.is_cuda:
        return decode_threshold_plain(logits, cell, threshold)
    return decode_threshold_op(logits, cell, threshold)
