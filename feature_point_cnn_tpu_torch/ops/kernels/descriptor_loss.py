"""Hinge descriptor loss over all cell pairs: the CUDA kernels' wrapper (a
`torch.autograd.Function`, forward and backward) and its plain version.

Kernels: `feature_point_cnn_tpu_torch/csrc/descriptor_loss.cu`, which
replaces the TPU kernel `feature_point_cnn_tpu/ops/pallas/
descriptor_loss.py:hinge_descriptor_loss_pallas` (forward `_fwd_kernel`,
backward `_bwd_kernel`).  They are bound by operations: the function needs
the N x N x D product (2 N^2 D flop) twice forward and four times backward,
against four ``(B, N, D)`` arrays of traffic.  So the products run on the
tensor cores (``wgmma``), each as three TF32 products of operands split into
``hi + lo`` (float32-grade; one TF32 product breaks the gradients, as
`tests/test_torch_desc_loss_split.py` shows): a block owns 128 rows and
sweeps the other side in 64-row chunks, which a small kernel has split and laid out as the tensor
cores read them and which arrive by bulk asynchronous copies while the chunk
before is multiplied.  Forward: the split, three sweeps (3 products) and the
sum of the per-block losses, 5 CUDA launches; backward: two splits (the
second transposed, for the gradient products) and four sweeps (6 products),
6 launches; one and two products more than the function needs.  No
``(B, N, N)`` array reaches device memory; only the ``(B, N)`` vectors ``rr``
and ``c`` are saved for the backward, and the split copies are scratch of
each call; every sum has a fixed order, so results repeat bit for bit (the
source note has the design).  The kernels take any ``N >= 1`` and ``D`` a
multiple of 8 (a k-step) up to 128; the wrapper zero-pads any other ``D`` up
to the next multiple, which changes no dot product, and drops the padding's
gradient columns.  ``D`` above 128 raises.

Plain version: the materialised ``(B, N, N)`` PyTorch computation under
ordinary autograd (`feature_point_cnn_tpu/train/loss.py:165-182` without the
final division).  The wrapper takes it only for CPU tensors; for CUDA
tensors it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch

from feature_point_cnn_tpu_torch.ops.kernels import (
    check_launch,
    load_library,
    stream_of,
)
from feature_point_cnn_tpu_torch.utils import profiling

_EPS = 1e-12      # matches train/loss.py:_l2_normalize
_OWN = 128        # kOwn of the source: rows a block owns, one partial loss each
_CHUNK = 64       # kChunk: rows of a stage's tile
_COLS = 128       # kCols: columns of a transposed tile, the widest D
_KSTEP = 8        # columns of a k-step: the wrapper pads D to a multiple
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "descriptor_loss_max_dim": (_I, ()),
    "descriptor_loss_fwd_launch": (
        _I, (_P,) * 10 + (_I,) * 3 + (_F,) * 4 + (_P,)
    ),
    "descriptor_loss_bwd_launch": (
        _I, (_P,) * 13 + (_I,) * 3 + (_F,) * 4 + (_P,)
    ),
}


def partial_size(b: int, n: int) -> int:
    """Floats of the forward's per-block partial losses: one per batch item
    and owned tile."""
    return b * (-(-n // _OWN))


def padded_dim(dim: int) -> int:
    """``dim`` rounded up to whole k-steps: the width the kernels are given."""
    return -(-dim // _KSTEP) * _KSTEP


def scratch_size(b: int, n: int, dim: int, backward: bool) -> int:
    """Floats of a launcher's scratch at the kernels' width ``dim``: the hi
    and lo parts of ``d`` and ``wd`` with the rows padded to whole chunks,
    ``(4, B, chunks * 64, dim)``; the backward adds the same transposed by
    chunks with the columns padded to 128, ``(4, B, chunks, 128, 64)``."""
    chunks = -(-n // _CHUNK)
    return 4 * b * chunks * _CHUNK * (dim + (_COLS if backward else 0))


def _hinge_from_dots(
    a: torch.Tensor,
    warped_centers: torch.Tensor,
    centers: torch.Tensor,
    mask_j: torch.Tensor,
    lambda_d: float,
    mp: float,
    mn: float,
    cell: int,
) -> torch.Tensor:
    """The hinge sum from ``a = relu(d_i . wd_j)``, ``(B, N, N)``.  The
    caller applies the relu so that the raw product is freed before the
    other ``(B, N, N)`` tensors are made."""
    u = a * torch.rsqrt((a * a).sum(dim=2, keepdim=True) + _EPS)
    v = u * torch.rsqrt((u * u).sum(dim=1, keepdim=True) + _EPS)
    diff = warped_centers[:, :, None, :] - centers[None, None, :, :]
    s = ((diff * diff).sum(-1) < (cell - 0.5) ** 2).to(v.dtype)
    hinge = lambda_d * s * torch.relu(mp - v) + (1.0 - s) * torch.relu(v - mn)
    return (hinge * mask_j[:, None, :]).sum()


def hinge_descriptor_loss_plain(
    d: torch.Tensor,
    wd: torch.Tensor,
    warped_centers: torch.Tensor,
    centers: torch.Tensor,
    mask_j: torch.Tensor,
    lambda_d: float,
    mp: float,
    mn: float,
    cell: int,
) -> torch.Tensor:
    """The unnormalised double-normalised hinge sum, materialising the
    ``(B, N, N)`` tensors; differentiable in ``d`` and ``wd`` by autograd.

    ``d``/``wd``: ``(B, N, D)`` row-normalised descriptors; ``warped_centers``
    ``(B, N, 2)``: the original cell centers in the warped frame;
    ``centers`` ``(N, 2)``; ``mask_j`` ``(B, N)`` in {0, 1}.
    """
    return _hinge_from_dots(
        torch.relu(torch.einsum("bid,bjd->bij", d, wd)), warped_centers,
        centers, mask_j, lambda_d, mp, mn, cell,
    )


def _check(name: str, t: torch.Tensor, shape, device) -> torch.Tensor:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: want float32 {shape} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )
    t = t.contiguous()
    # the kernels copy rows 16 bytes at a time
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _HingeDescriptorLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, wd, warped_centers, centers, mask_j, lambda_d, mp, mn,
                cell):
        if d.dim() != 3:
            raise ValueError(f"d: want (B, N, D), got {tuple(d.shape)}")
        b, n, width = d.shape
        dev = d.device
        d = _check("d", d, (b, n, width), dev)
        wd = _check("wd", wd, (b, n, width), dev)
        wc = _check("warped_centers", warped_centers, (b, n, 2), dev)
        ct = _check("centers", centers, (n, 2), dev)
        mj = _check("mask_j", mask_j, (b, n), dev)
        lib = load_library("descriptor_loss", _SIGNATURES)
        if b == 0 or n == 0 or not 0 < width <= lib.descriptor_loss_max_dim():
            raise ValueError(
                f"the descriptor-loss kernel takes B, N >= 1 and D <= "
                f"{lib.descriptor_loss_max_dim()}, got {(b, n, width)}"
            )
        dim = padded_dim(width)
        if dim != width:   # zero columns add nothing to any dot product
            d = torch.nn.functional.pad(d, (0, dim - width))
            wd = torch.nn.functional.pad(wd, (0, dim - width))
        rr = torch.empty((b, n), dtype=torch.float32, device=dev)
        c = torch.empty_like(rr)
        partial = torch.empty(partial_size(b, n), dtype=torch.float32,
                              device=dev)
        loss = torch.empty((), dtype=torch.float32, device=dev)
        scratch = torch.empty(scratch_size(b, n, dim, False),
                              dtype=torch.float32, device=dev)
        params = (float(lambda_d), float(mp), float(mn), float(cell))
        with torch.cuda.device(dev):
            err = lib.descriptor_loss_fwd_launch(
                d.data_ptr(), wd.data_ptr(), wc.data_ptr(), ct.data_ptr(),
                mj.data_ptr(), rr.data_ptr(), c.data_ptr(), partial.data_ptr(),
                loss.data_ptr(), scratch.data_ptr(), b, n, dim, *params,
                stream_of(d),
            )
        check_launch(err, "descriptor_loss_fwd_launch")
        profiling.count("kernel.desc_loss_fwd")
        ctx.save_for_backward(d, wd, wc, ct, mj, rr, c)
        ctx.params = params
        ctx.width = width
        return loss

    @staticmethod
    def backward(ctx, grad_out):
        d, wd, wc, ct, mj, rr, c = ctx.saved_tensors
        b, n, dim = d.shape
        g = grad_out.to(torch.float32).reshape(1).contiguous()
        tcol = torch.empty_like(rr)
        srow = torch.empty_like(rr)
        dd = torch.empty_like(d)
        dwd = torch.empty_like(wd)
        scratch = torch.empty(scratch_size(b, n, dim, True),
                              dtype=torch.float32, device=d.device)
        lib = load_library("descriptor_loss", _SIGNATURES)
        with torch.cuda.device(d.device):
            err = lib.descriptor_loss_bwd_launch(
                d.data_ptr(), wd.data_ptr(), wc.data_ptr(), ct.data_ptr(),
                mj.data_ptr(), rr.data_ptr(), c.data_ptr(), g.data_ptr(),
                tcol.data_ptr(), srow.data_ptr(), dd.data_ptr(), dwd.data_ptr(),
                scratch.data_ptr(), b, n, dim, *ctx.params, stream_of(d),
            )
        check_launch(err, "descriptor_loss_bwd_launch")
        profiling.count("kernel.desc_loss_bwd")
        if ctx.width != dim:
            dd, dwd = dd[..., :ctx.width], dwd[..., :ctx.width]
        return dd, dwd, None, None, None, None, None, None, None


def hinge_descriptor_loss_cuda(
    d: torch.Tensor,
    wd: torch.Tensor,
    warped_centers: torch.Tensor,
    centers: torch.Tensor,
    mask_j: torch.Tensor,
    lambda_d: float,
    mp: float,
    mn: float,
    cell: int,
) -> torch.Tensor:
    """The descriptor-loss kernels on CUDA tensors (forward now, backward
    when autograd asks), the plain version on CPU tensors.  Arguments and
    result as :func:`hinge_descriptor_loss_plain`; no gradient flows to the
    centers or the mask.  The tracer's counters ``kernel.desc_loss_fwd`` /
    ``kernel.desc_loss_bwd`` count the calls of each direction's launcher;
    a forward call is 5 CUDA launches (the split, three sweeps, the sum of
    the partial losses) and a backward call 6 (two splits, four sweeps)."""
    if not d.is_cuda:
        return hinge_descriptor_loss_plain(
            d, wd, warped_centers, centers, mask_j, lambda_d, mp, mn, cell
        )
    return _HingeDescriptorLoss.apply(
        d, wd, warped_centers.detach(), centers.detach(), mask_j.detach(),
        lambda_d, mp, mn, cell,
    )
