"""SuperGlue's log-space Sinkhorn: the CUDA kernel's wrapper and its plain
version.

Kernel: `feature_point_cnn_tpu_torch/csrc/sinkhorn.cu`.  It replaces no TPU
kernel (the JAX package has no SuperGlue); it was added because the plain
loop passes the couplings through device memory about five times a
half-iteration.  It is bound by bytes: the couplings, (B, N+1, M+1)
float32, do not fit on chip, so each iteration reads them once (134.5 MB
at (32, 1024, 1024): 4.0 ms for 100 iterations at 3.35 TB/s); its two
exponentials an entry an iteration take 1.6 ms.  A block holds a band of
rows of one pair in registers, takes u for its rows and its band's
partial column logsumexps; a second launch folds the partials into v; a
last one writes ``Z``: ``2 * iters + 1`` launches a call.

Plain version: `log_optimal_transport_plain`, the loop as the published
code writes it, over each pair's valid rows and columns.  The wrapper
takes it for CPU tensors; for CUDA tensors it launches the kernel or
raises.  Both take the marginals from `marginals`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from feature_point_cnn_tpu_torch.ops.kernels import (
    check_launch,
    load_library,
    stream_of,
)
from feature_point_cnn_tpu_torch.utils import profiling

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "sinkhorn_launch": (_I, (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
}
# the kernel's constants (`csrc/sinkhorn.cu`)
_THREADS = 256     # threads of a band's block
_SLOTS = 32        # couplings a thread holds in registers: rows x columns
_MAX_COLS = 16     # score columns a thread holds at most
MAX_COLUMNS = _THREADS * _MAX_COLS


def band_layout(m: int) -> Tuple[int, int]:
    """``(cols, rows)``: the score columns a thread of the kernel holds for
    ``m`` of them (the least power of two with 256 * cols >= m) and the
    rows of a band (32 / cols).  A pair of N rows takes
    ``ceil((N + 1) / rows)`` bands."""
    cols = 1
    while _THREADS * cols < m:
        cols *= 2
    return cols, _SLOTS // cols


def marginals(valid0: torch.Tensor, valid1: torch.Tensor):
    """``(norm (B,), log_mu (B, N+1), log_nu (B, M+1), v (B, M+1))``: the
    scale, the row and column marginals (-inf on padded rows and columns,
    the dustbins last) and the initial column potentials.  A side with no
    valid rows counts as one row, so nothing is -inf - -inf."""
    rows, cols = valid0.sum(1).float(), valid1.sum(1).float()
    norm = -torch.log((rows + cols).clamp_min(1.0))
    neg = float("-inf")
    log_mu = torch.cat([torch.where(valid0, norm[:, None], neg),
                        (torch.log(cols.clamp_min(1.0)) + norm)[:, None]], 1)
    log_nu = torch.cat([torch.where(valid1, norm[:, None], neg),
                        (torch.log(rows.clamp_min(1.0)) + norm)[:, None]], 1)
    v = torch.cat([torch.where(valid1, 0.0, neg), torch.zeros_like(norm)[:, None]], 1)
    return norm, log_mu, log_nu, v


def log_optimal_transport_plain(scores: torch.Tensor, alpha: torch.Tensor,
                                valid0: torch.Tensor, valid1: torch.Tensor,
                                iters: int) -> torch.Tensor:
    """The published ``log_optimal_transport`` of ``(B, N, M)`` float32
    ``scores`` with the dustbin score ``alpha``, each pair over its own
    valid rows ``valid0 (B, N)`` and columns ``valid1 (B, M)``: padded rows
    and columns get the marginal -inf, their potentials start at -inf, and
    they read -inf in the result."""
    b, n, m = scores.shape
    couplings = torch.cat([
        torch.cat([scores, alpha.expand(b, n, 1)], 2),
        alpha.expand(b, 1, m + 1)], 1)
    norm, log_mu, log_nu, v = marginals(valid0, valid1)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :] - norm[:, None, None]


def _launch(scores, alpha, valid0, valid1, iters: int) -> torch.Tensor:
    if scores.dim() != 3 or scores.dtype != torch.float32:
        raise ValueError(f"scores: want (B, N, M) float32, got {scores.dtype} "
                         f"{tuple(scores.shape)}")
    b, n, m = scores.shape
    dev = scores.device
    if tuple(valid0.shape) != (b, n) or tuple(valid1.shape) != (b, m) \
            or valid0.device != dev or valid1.device != dev or alpha.device != dev \
            or alpha.numel() != 1:
        raise ValueError(f"want valid0 ({b}, {n}), valid1 ({b}, {m}) and one alpha "
                         f"on {dev}, got {tuple(valid0.shape)}, {tuple(valid1.shape)}, "
                         f"{tuple(alpha.shape)}")
    if iters < 1 or m > MAX_COLUMNS:
        raise ValueError(f"the Sinkhorn kernel takes iters >= 1 and M <= {MAX_COLUMNS}, "
                         f"got {iters}, {m}")
    if torch.is_grad_enabled() and (scores.requires_grad or alpha.requires_grad):
        raise ValueError("the Sinkhorn kernel carries no gradient: call it under "
                         "torch.no_grad() or torch.inference_mode()")
    scores = scores.contiguous()
    alpha = alpha.detach().reshape(()).to(torch.float32).contiguous()
    norm, log_mu, log_nu, v = (t.contiguous() for t in marginals(valid0, valid1))
    bands = -(-(n + 1) // band_layout(m)[1])
    u = torch.empty((b, n + 1), dtype=torch.float32, device=dev)
    partial = torch.empty(b * bands * (m + 1), dtype=torch.float32, device=dev)
    z = torch.empty((b, n + 1, m + 1), dtype=torch.float32, device=dev)
    lib = load_library("sinkhorn", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.sinkhorn_launch(
            scores.data_ptr(), alpha.data_ptr(), log_mu.data_ptr(), log_nu.data_ptr(),
            norm.data_ptr(), u.data_ptr(), v.data_ptr(), partial.data_ptr(),
            z.data_ptr(), b, n, m, int(iters), stream_of(scores),
        )
    check_launch(err, "sinkhorn_launch")
    profiling.count("kernel.sinkhorn")
    return z


def log_optimal_transport(scores: torch.Tensor, alpha: torch.Tensor,
                          valid0: torch.Tensor, valid1: torch.Tensor,
                          iters: int) -> torch.Tensor:
    """``Z`` ``(B, N+1, M+1)`` float32 of `log_optimal_transport_plain`:
    the kernel on CUDA tensors (no gradient; M up to `MAX_COLUMNS`, iters
    >= 1), the plain loop on CPU ones.  The tracer's counter
    ``kernel.sinkhorn`` counts kernel calls."""
    if not scores.is_cuda:
        return log_optimal_transport_plain(scores, alpha, valid0, valid1, iters)
    return _launch(scores, alpha, valid0, valid1, iters)
