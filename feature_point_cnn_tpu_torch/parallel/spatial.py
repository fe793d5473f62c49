"""W-sharded convolutions and pools: the halo exchanges GSPMD inserts.

The JAX package shards one NHWC image along W over a ``width`` mesh
(`feature_point_cnn_tpu/parallel/mesh.py:64-85`), and GSPMD inserts a halo
exchange at each convolution, so one large image is computed across
devices.  Here the exchanges are written by hand.  Inside ``with
width_group(g):`` the model's `Conv2d`, `ConvTranspose2d` and max pool
(`models/blocks.py`, `models/superpoint.py`) call the functions below,
and the forward of a rank's block of columns computes that block of the
one-process forward.  No rank holds a full-width activation.  With no
width group set, nothing here runs: the modules read one module-level
global and call the plain op, so `torch.export`, AOTInductor and the
CUDA-graph trainer trace what they traced before.

**Layout.**  Rank ``r`` of ``d`` holds the input's columns ``[r w, (r +
1) w)``: equal blocks, from `mesh.shard_images_spatial`.  Output column
``j`` of an op of stride ``s`` belongs to the rank that holds input column
``s j``, the column the op's window is centred on.  Equal blocks of odd
width thus give uneven blocks after a stride of 2: at 48 px and d = 2 the
1/8 grid holds 3 columns a rank and the 1/16 grid 2 and 1.  A strided
op's input must be equally sharded, as every strided op of the model's
is; ops of stride 1 take any blocks.  The transposed convolution, which
returns from 1/16 to 1/8, is told the block width of the equally sharded
grid its output joins (the embeddings').  It hands the last rank any
column past that grid, and the descriptor head's crop then drops it there
alone.

**Exchange.**  Each op widens its block by the columns its windows read
past the block's edges: ``l`` from the left neighbour and ``r`` from the
right one.  At the image's borders it pads with the op's own value: 0
for a convolution, -inf for the max pool.  The exchange is ONE
``all_reduce`` of a zero buffer ``(d, 2, N, C, H, h)`` into which each
rank writes its two edge strips of ``h`` columns, as
`collectives.gather_rows` does.  Each strip is summed with zeros only, so
it arrives exact.  It uses ``all_reduce`` alone, so gloo carries CUDA
tensors through it, as it does NCCL's.  Its backward is the same exchange
in reverse: the halo's gradients go back to their owners and are added
onto the owners' edge columns.  A shard must be at least ``h`` columns
wide.  A strided op says so when one of its output blocks would be empty.

A group of one rank holds the whole width, so there the ops are the plain
ones.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

Pair = Union[int, Sequence[int]]


class Width(NamedTuple):
    group: dist.ProcessGroup
    rank: int
    size: int


_WIDTH: Optional[Width] = None

# what the exchanges carried since `reset_counts`: calls (forward and
# backward), bytes all-reduced, and the largest buffer in bytes
counts = {"exchanges": 0, "bytes": 0, "largest_bytes": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


@contextlib.contextmanager
def width_group(g: Optional[dist.ProcessGroup]) -> Iterator[None]:
    """Inside the block the model's forward is W-sharded over ``g`` (``None``:
    not sharded); the previous setting is back after it."""
    global _WIDTH
    w = None
    if g is not None:
        w = Width(g, dist.get_rank(g), dist.get_world_size(g))
        if w.rank < 0:
            raise ValueError("this rank is outside the width group")
    previous, _WIDTH = _WIDTH, w
    try:
        yield
    finally:
        _WIDTH = previous


def group() -> Optional[dist.ProcessGroup]:
    """The width group, or ``None`` outside ``width_group``."""
    return None if _WIDTH is None else _WIDTH.group


def _pair(v: Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class _Exchange(torch.autograd.Function):
    """``x`` widened by ``left`` columns of the left neighbour and ``right``
    of the right one (``pad`` past the image's borders), through one
    ``all_reduce`` of every rank's ``h``-column edge strips."""

    @staticmethod
    def forward(ctx, x, left, right, h, pad, w):
        n, c, hh, width = x.shape
        if width < h:
            raise ValueError(f"a W shard of {width} columns is narrower than its "
                             f"{h}-column halo")
        buf = x.new_zeros((w.size, 2, n, c, hh, h))
        buf[w.rank, 0] = x[..., :h]
        buf[w.rank, 1] = x[..., width - h:]
        _all_reduce(buf, w.group)
        out = torch.empty((n, c, hh, left + width + right), dtype=x.dtype,
                          device=x.device,
                          memory_format=_memory_format(x))
        out[..., left:left + width] = x
        if left:
            out[..., :left] = (buf[w.rank - 1, 1, ..., h - left:] if w.rank > 0
                               else pad)
        if right:
            out[..., left + width:] = (buf[w.rank + 1, 0, ..., :right]
                                       if w.rank < w.size - 1 else pad)
        ctx.geometry = (left, right, h, width, w)
        return out

    @staticmethod
    def backward(ctx, g):
        left, right, h, width, w = ctx.geometry
        n, c, hh, _ = g.shape
        buf = g.new_zeros((w.size, 2, n, c, hh, h))
        if left and w.rank > 0:
            buf[w.rank - 1, 1, ..., h - left:] = g[..., :left]
        if right and w.rank < w.size - 1:
            buf[w.rank + 1, 0, ..., :right] = g[..., left + width:]
        _all_reduce(buf, w.group)
        gx = g[..., left:left + width].clone()
        gx[..., :h] += buf[w.rank, 0]
        gx[..., width - h:] += buf[w.rank, 1]
        return gx, None, None, None, None, None


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last) \
            and not x.is_contiguous():
        return torch.channels_last
    return torch.contiguous_format


def _all_reduce(buf: torch.Tensor, g: dist.ProcessGroup) -> None:
    nbytes = buf.numel() * buf.element_size()
    counts["exchanges"] += 1
    counts["bytes"] += nbytes
    counts["largest_bytes"] = max(counts["largest_bytes"], nbytes)
    dist.all_reduce(buf, group=g)


def halo(x: torch.Tensor, left: int, right: int, pad: float = 0.0,
         h: Optional[int] = None) -> torch.Tensor:
    """``(N, C, H, w)`` block -> ``(N, C, H, left + w + right)``: the
    neighbours' columns on each side, ``pad`` past the image's borders,
    differentiable.  ``h`` (default ``max(left, right)``) is the strip
    width every rank exchanges: the same on every rank of the group, at
    least what any of them reads."""
    w = _WIDTH
    if w is None:
        raise ValueError("halo needs a width group")
    h = max(left, right) if h is None else h
    return _Exchange.apply(x, left, right, h, pad, w)


Window = Tuple[int, int, int]


def _windows(width: int, size: int, k: int, s: int, p: int) -> List[Window]:
    """Each rank's input window ``(start, stop, block width)``, ``[start,
    stop)`` relative to its block, for an op of kernel extent ``k``, stride
    ``s`` and padding ``p`` over equal blocks of ``width``: the columns its
    output block reads."""
    out = []
    for r in range(size):
        a = r * width
        j0, j1 = _ceil_div(a, s), _ceil_div(a + width, s)
        if j1 <= j0:
            raise ValueError(
                f"a stride-{s} op over W shards of {width} columns leaves rank {r} "
                f"no output column: make each shard at least {s} columns wide")
        out.append((s * j0 - p - a, s * (j1 - 1) - p + k - a, width))
    return out


def _window(x: torch.Tensor, w: Width, windows: List[Window],
            pad: float) -> torch.Tensor:
    """This rank's window of ``windows``, exchanged and padded.  Every rank
    computes every rank's halos, so all exchange strips of one width."""
    need = [(max(0, -a), max(0, b - n)) for a, b, n in windows]
    h = max(max(pair) for pair in need)
    start, stop, _ = windows[w.rank]
    left, right = need[w.rank]
    if h:
        x = halo(x, left, right, pad, h)
    return x[..., start + left:stop + left]


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           stride: Pair = 1, padding: Pair = 0, dilation: Pair = 1,
           groups: int = 1) -> torch.Tensor:
    """`F.conv2d` (zero padding) of the W-sharded ``x``: this rank's block
    of the output."""
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    w = _WIDTH
    if w is None or w.size == 1:
        return F.conv2d(x, weight, bias, (sh, sw), (ph, pw), (dh, dw), groups)
    k = (weight.shape[-1] - 1) * dw + 1
    x = _window(x, w, _windows(x.shape[-1], w.size, k, sw, pw), 0.0)
    return F.conv2d(x, weight, bias, (sh, sw), (ph, 0), (dh, dw), groups)


def max_pool2d(x: torch.Tensor, kernel_size: Pair, stride: Optional[Pair] = None,
               padding: Pair = 0) -> torch.Tensor:
    """`F.max_pool2d` of the W-sharded ``x`` (-inf past the borders)."""
    (kh, kw), (ph, pw) = _pair(kernel_size), _pair(padding)
    sh, sw = _pair(kernel_size if stride is None else stride)
    w = _WIDTH
    if w is None or w.size == 1:
        return F.max_pool2d(x, (kh, kw), (sh, sw), (ph, pw))
    x = _window(x, w, _windows(x.shape[-1], w.size, kw, sw, pw), -math.inf)
    return F.max_pool2d(x, (kh, kw), (sh, sw), (ph, 0))


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor], stride: Pair = 1, padding: Pair = 0,
                     output_padding: Pair = 0, groups: int = 1, dilation: Pair = 1,
                     block_width: Optional[int] = None) -> torch.Tensor:
    """`F.conv_transpose2d` of the W-sharded ``x``, whose output joins the
    equally sharded grid of ``block_width`` columns a rank: ``x``'s blocks
    are that grid's stride-``s`` image (the ownership rule), and this rank
    returns the grid's columns ``[r n, (r + 1) n)``, the last rank also
    any column of the global output past ``d n``."""
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    (oh, ow), (dh, dw) = _pair(output_padding), _pair(dilation)
    w = _WIDTH
    if w is None or w.size == 1:
        return F.conv_transpose2d(x, weight, bias, (sh, sw), (ph, pw), (oh, ow),
                                  groups, (dh, dw))
    if block_width is None:
        raise ValueError("a W-sharded transposed convolution needs the block width "
                         "of the grid its output joins")
    n, d, k = block_width, w.size, (weight.shape[-1] - 1) * dw + 1
    blocks = [(_ceil_div(r * n, sw), _ceil_div((r + 1) * n, sw)) for r in range(d)]
    a, b = blocks[w.rank]
    if x.shape[-1] != b - a:
        raise ValueError(f"rank {w.rank}'s block of {x.shape[-1]} columns is not the "
                         f"stride-{sw} image of {n}-column blocks ({b - a})")
    w_out = (blocks[-1][1] - 1) * sw - 2 * pw + k + ow
    outs = [(r * n, (r + 1) * n if r < d - 1 else w_out) for r in range(d)]
    windows = []
    for (ar, br), (j0, j1) in zip(blocks, outs):
        i_lo, i_hi = _ceil_div(j0 + pw - k + 1, sw), (j1 - 1 + pw) // sw
        windows.append((i_lo - ar, i_hi + 1 - ar, br - ar))
    xw = _window(x, w, windows, 0.0)
    i_lo = a + windows[w.rank][0]
    j0, j1 = outs[w.rank]
    span = (xw.shape[-1] - 1) * sw + k
    extra = max(0, j1 - sw * i_lo + pw - span)     # < sw: columns of no input
    y = F.conv_transpose2d(xw, weight, bias, (sh, sw), (ph, 0), (oh, extra),
                           groups, (dh, dw))
    return y[..., j0 - sw * i_lo + pw:j1 - sw * i_lo + pw]


@torch.no_grad()
def gather_width(x: torch.Tensor, dim: int,
                 g: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Every rank's equal block of ``x`` along ``dim``, in rank order, on
    every rank of ``g`` (``None``: the width group): a zero global buffer
    into which each rank writes its block, summed over the group.  For
    tests and checks; the forward never calls it."""
    g = g if g is not None else group()
    if g is None:
        return x
    rank, size = dist.get_rank(g), dist.get_world_size(g)
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = size * n
    buf = x.new_zeros(shape)
    buf.narrow(dim, rank * n, n).copy_(x)
    dist.all_reduce(buf, group=g)
    return buf
