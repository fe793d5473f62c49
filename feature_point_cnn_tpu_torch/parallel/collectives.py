"""The collectives of the data-parallel layer.

In JAX, data parallelism is GSPMD: one jitted step consumes a batch sharded
over the ``data`` mesh axis and XLA inserts the reductions, so the d-device
step computes what the one-device step computes on the global batch
(`feature_point_cnn_tpu/parallel/mesh.py:1-9`).  Here every module that
reduces over the batch (train-mode BatchNorm, the loss divisors, the
gradient, the metrics) calls one of these sums over the **data group**
itself.

The data group is the job's default group, or, inside a ``with
data_group(g)`` block, the group ``g``: `train.trainer.Trainer` runs its
steps inside its mesh's group (a subgroup when the mesh leaves ranks out),
and nothing else sets it.  With no process group initialized both sums are
the identity; with one, even of one rank, they call the collective.  The
module calls ``all_reduce``, and ``broadcast`` to replicate state, and
nothing else: gloo carries CUDA tensors for those two collectives only, and
two ranks that share one card run over gloo.

The data group is one of two.  Inside ``with spatial.width_group(g)``
(`parallel/spatial.py`) every rank holds a block of columns of every image
and the whole batch, so there the batch's sums run over the width group
instead: `group` returns it, and `shard` says that this rank holds every
row.  The same modules then compute JAX's step on a W-sharded batch.  The
JAX package's meshes have one axis, data or width, so a data group set by
``data_group`` inside a width group raises.  The width group's exchanges and
gathers keep to the same rule, ``all_reduce`` alone.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from feature_point_cnn_tpu_torch.parallel import spatial

_DATA_GROUP: Optional[dist.ProcessGroup] = None


@contextlib.contextmanager
def data_group(g: Optional[dist.ProcessGroup]) -> Iterator[None]:
    """Inside the block the data group is ``g`` (``None``: the job's default
    group); the previous one is back after it."""
    global _DATA_GROUP
    previous, _DATA_GROUP = _DATA_GROUP, g
    try:
        yield
    finally:
        _DATA_GROUP = previous


def group() -> Optional[dist.ProcessGroup]:
    """The group the batch's sums run over: the width group inside one,
    else the data group, ``None`` when no process group is initialized.
    Raises where a data group was set inside a width group."""
    w = spatial.group()
    if w is not None:
        if _DATA_GROUP is not None:
            raise ValueError("a data group inside a width group: the JAX package's "
                             "meshes have one axis, data or width, so a data x width "
                             "mesh is not ported")
        return w
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return _DATA_GROUP if _DATA_GROUP is not None else dist.group.WORLD


def shard() -> Tuple[int, int]:
    """``(index, count)`` of this rank in the data group; ``(0, 1)`` with no
    group and inside a width group, whose ranks each hold the whole batch.
    A batch of ``b`` rows a rank holds rows ``[index * b, (index + 1) * b)``
    of the global batch of ``count * b`` rows."""
    g = group()
    if g is None or spatial.group() is not None:
        return 0, 1
    return dist.get_rank(g), dist.get_world_size(g)


class _AllSum(torch.autograd.Function):
    """``all_reduce(SUM)`` whose backward is again an ``all_reduce(SUM)``:
    every rank receives the sum, so the gradient of a rank's input sums the
    gradients of every rank's output.  (`torch.distributed.nn.functional.
    all_reduce` is this Function; torch 2.13 deprecates it.)"""

    @staticmethod
    def forward(ctx, x, g):
        ctx.group = g
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _AllSum.apply(grad, ctx.group), None


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over `group`, differentiable."""
    g = group()
    return x if g is None else _AllSum.apply(x, g)


@torch.no_grad()
def all_sum_(x: torch.Tensor, g: Optional[dist.ProcessGroup] = None
             ) -> torch.Tensor:
    """The sum of ``x`` over group ``g`` (``None``: `group`), out of place
    and without a gradient (divisors, metrics, the gradient itself)."""
    g = g if g is not None else group()
    if g is None:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=g)
    return y


@torch.no_grad()
def gather_rows(x: torch.Tensor, g: Optional[dist.ProcessGroup] = None
                ) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) stacked along dim 0 in
    rank order, on every rank of group ``g`` (``None``: the data group): a
    zero global buffer into which this rank writes its rows, summed over
    the group.  Exact, since ``x + 0 = x``.  Bool tensors travel as int32."""
    g = g if g is not None else group()
    if g is None:
        return x
    index, count = dist.get_rank(g), dist.get_world_size(g)
    kind = x.dtype
    src = x.to(torch.int32) if kind == torch.bool else x
    buf = torch.zeros((count * x.shape[0],) + tuple(x.shape[1:]), dtype=src.dtype,
                      device=x.device)
    buf[index * x.shape[0]:(index + 1) * x.shape[0]] = src
    dist.all_reduce(buf, group=g)
    return buf.to(kind)


@torch.no_grad()
def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0,
               g: Optional[dist.ProcessGroup] = None) -> None:
    """Overwrite ``tensors`` in place with the values of rank ``src`` of
    group ``g`` (``None``: the data group), one ``broadcast`` a tensor."""
    g = g if g is not None else group()
    if g is None:
        return
    root = dist.get_global_rank(g, src)
    for t in tensors:
        if t.is_contiguous():
            dist.broadcast(t, root, group=g)
        else:
            tmp = t.contiguous()
            dist.broadcast(tmp, root, group=g)
            t.copy_(tmp)
