"""W-sharded convolutions and pools: the halo exchanges GSPMD inserts.

The JAX package shards one NHWC image along W over a ``width`` mesh
(`feature_point_cnn_tpu/parallel/mesh.py:64-85`), and GSPMD inserts a halo
exchange at each convolution, so one large image is computed across
devices.  Here the exchanges are written by hand.  Inside ``with
width_group(g):`` the models' `Conv2d`, `ConvTranspose2d` and max pools
(`models/blocks.py`, `models/superpoint.py`, `models/vgg_superpoint.py`)
call the functions below, and the forward of a rank's block of columns
computes that block of the one-process forward.  No rank holds a
full-width activation.  With no width group set, nothing here runs: the
modules read one module-level global and call the plain op, so
`torch.export`, AOTInductor and the CUDA-graph trainer trace what they
traced before.

**Layout.**  Rank ``r`` of ``d`` holds the input's columns ``[r w, (r +
1) w)``: equal blocks, from `mesh.shard_images_spatial`.  Output column
``j`` of an op of stride ``s`` belongs to the rank that holds input column
``s j``, the column the op's window is centred on (`ownership`).  Equal
blocks of odd width thus give uneven blocks after a stride of 2: at 48 px
and d = 2 the 1/8 grid holds 3 columns a rank and the 1/16 grid 2 and 1;
at 8 px a shard the 1/8 grid holds one column a rank and the 1/16 grid
only the even ranks' columns, so an odd rank's 1/16 block is empty.  A
rank with an empty block still takes part in every exchange, and its ops
return empty blocks without running.  A strided op's input must be
equally sharded, as every strided op of the models' is; ops of stride 1
take any blocks.  The transposed convolution, which returns from 1/16 to
1/8, is told the block width of the equally sharded grid its output joins
(the embeddings').  It hands the last rank any column past that grid, and
the descriptor head's crop then drops it there alone.

Every rank works out every rank's block width from the geometry alone, so
no exchange reads anything back to the host.  Each op records the blocks
it returns under its output's height in the width group's `Width.layouts`
(a strided op its `ownership` image, the transposed convolution the grid
it joins, a stride-1 op its input's), and an op reads its input's blocks
there (`_layout`); a height no op has returned is the image's, in equal
blocks.  The models' strides are square, so within one forward a height
names one scale; a strided op that would keep its input's height (the
ResNet's descriptor head on an image 8 px high) raises.

**Exchange.**  Each op widens its block by the columns its windows read
past the block's edges: ``l`` columns on the left and ``r`` on the right.
At the image's borders it pads with the op's own value: 0 for a
convolution, -inf for the max pool.  The exchange is ONE ``all_reduce`` of
a zero buffer into which each rank writes its two edge strips of ``h``
columns, ``(d, 2, N, C, H, h)``, as `collectives.gather_rows` does; rank
``q``'s strips hold ``min(block width of q, h)`` columns.  A rank then
takes its ``l`` columns from the right strips of the ranks before it,
nearest first, and its ``r`` from the left strips of the ranks after it:
past an empty or narrow block the columns come from two or more ranks
away (`halo_plan`).  Each strip is summed with zeros only, so it arrives
exact.  It uses ``all_reduce`` alone, so gloo carries CUDA tensors through
it, as it does NCCL's.  Its backward is the same exchange in reverse: the
halo's gradients go back to their owners and are added onto the owners'
edge columns.  Every rank computes ``h`` from the op alone, so all ranks
exchange strips of one width in one order, and no exchange reads a
device value back to the host.

A group of one rank holds the whole width, so there the ops are the plain
ones.

**Whole tensors.**  `gather_width` assembles every rank's block by one
exact sum, and its backward returns each rank its columns of the summed
gradient: the train steps gather the image for its augmentation and the
descriptor maps for the descriptor loss (`train/steps.py`,
`train/loss.py`), and `own_block` takes a rank's columns of a whole
tensor.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

Pair = Union[int, Sequence[int]]


class Width(NamedTuple):
    group: dist.ProcessGroup
    rank: int
    size: int
    # every rank's block width of the tensors of each height, as the last
    # op that returned one recorded it (`_record`)
    layouts: Dict[int, List[int]]


_WIDTH: Optional[Width] = None

# what the exchanges and gathers carried since `reset_counts`: exchanges
# (forward and backward), bytes all-reduced and the largest buffer in bytes;
# gathers (`gather_width` forward and backward, `sum_blocks`) and their bytes
counts = {"exchanges": 0, "bytes": 0, "largest_bytes": 0, "gathers": 0,
          "gather_bytes": 0}


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
        w = Width(g, dist.get_rank(g), dist.get_world_size(g), {})
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


def split() -> Tuple[int, int]:
    """``(rank, size)`` in the width group; ``(0, 1)`` outside one."""
    return (0, 1) if _WIDTH is None else (_WIDTH.rank, _WIDTH.size)


def _pair(v: Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# the geometry, pure: which rank owns which output column, and what it reads

Span = Tuple[int, int]


def ownership(width: int, size: int, s: int, w_out: int) -> List[Span]:
    """Each rank's output columns ``[j0, j1)`` of an op of stride ``s`` and
    ``w_out`` output columns over ``size`` equal blocks of ``width``: column
    ``j`` goes to the rank that holds input column ``s j``, and the last
    rank also takes any column past ``ceil(size width / s)``."""
    starts = [min(_ceil_div(r * width, s), w_out) for r in range(size)] + [w_out]
    starts[0] = 0
    return [(starts[r], starts[r + 1]) for r in range(size)]


def strided_windows(width: int, size: int, k: int, s: int, p: int) -> List[Span]:
    """Each rank's input window ``[start, stop)``, relative to its block, of
    an op of kernel extent ``k``, stride ``s`` and padding ``p`` over equal
    blocks of ``width``: the columns its output block reads; ``(0, 0)``
    where the rank owns no output column."""
    w_out = (size * width + 2 * p - k) // s + 1
    out = []
    for r, (j0, j1) in enumerate(ownership(width, size, s, w_out)):
        a = r * width
        out.append((s * j0 - p - a, s * (j1 - 1) - p + k - a) if j1 > j0 else (0, 0))
    return out


def transposed_windows(n: int, size: int, k: int, s: int, p: int,
                       op: int) -> Tuple[List[Span], List[Span], List[Span]]:
    """A stride-``s`` transposed convolution whose output joins the equally
    sharded grid of ``n`` columns a rank: ``(blocks, outs, windows)``, each
    rank's input block (the grid's `ownership` image), output columns and
    input window ``[start, stop)`` relative to its block, all global but
    the windows."""
    blocks = ownership(n, size, s, _ceil_div(size * n, s))
    w_out = (blocks[-1][1] - 1) * s - 2 * p + k + op
    outs = [(r * n, (r + 1) * n if r < size - 1 else w_out) for r in range(size)]
    windows = []
    for (a, _), (j0, j1) in zip(blocks, outs):
        windows.append((_ceil_div(j0 + p - k + 1, s) - a, (j1 - 1 + p) // s + 1 - a))
    return blocks, outs, windows


def halo_need(window: Span, width: int) -> Tuple[int, int]:
    """The columns a window reads past its block's left and right edges."""
    start, stop = window
    return (max(0, -start), max(0, stop - width)) if stop > start else (0, 0)


Piece = Tuple[int, int, int, int, int]


def halo_plan(rank: int, left: int, right: int, held: Sequence[int],
              h: int) -> Tuple[List[Piece], int, List[Piece], int]:
    """Where rank ``rank``'s ``left`` and ``right`` halo columns come from,
    given how many columns each rank's strips hold (``held[q] = min(block
    width, h)``): ``(left pieces, left pad, right pieces, right pad)``.  A
    piece ``(lo, hi, q, src_lo, src_hi)`` puts strip columns ``[src_lo,
    src_hi)`` of rank ``q`` (its right strip for the left halo, its left
    strip for the right one) at halo columns ``[lo, hi)``; the pads are the
    columns past the image's border: the left halo's first ``left pad``
    columns and the right halo's last ``right pad``."""
    lpieces, need, q = [], left, rank - 1
    while need and q >= 0:
        t = min(held[q], need)
        if t:
            lpieces.append((need - t, need, q, h - t, h))
        need, q = need - t, q - 1
    rpieces, got, q = [], 0, rank + 1
    while got < right and q < len(held):
        t = min(held[q], right - got)
        if t:
            rpieces.append((got, got + t, q, 0, t))
        got, q = got + t, q + 1
    return lpieces, need, rpieces, right - got


def put_strips(strips: torch.Tensor, x: torch.Tensor) -> int:
    """Write ``x``'s first and last ``min(width, h)`` columns into
    ``strips`` ``(2, N, C, H, h)``, left-aligned in the first and
    right-aligned in the second; returns that count."""
    h, width = strips.shape[-1], x.shape[-1]
    m = min(width, h)
    strips[0, ..., :m] = x[..., :m]
    strips[1, ..., h - m:] = x[..., width - m:]
    return m


def assemble(x: torch.Tensor, strips: torch.Tensor, plan, left: int, right: int,
             pad: float) -> torch.Tensor:
    """``x`` widened to ``[left halo | x | right halo]`` from every rank's
    strips ``(d, 2, N, C, H, h)`` by `halo_plan`'s ``plan``."""
    lpieces, lpad, rpieces, rpad = plan
    n, c, hh, width = x.shape
    out = torch.empty((n, c, hh, left + width + right), dtype=x.dtype, device=x.device,
                      memory_format=_memory_format(x))
    out[..., left:left + width] = x
    out[..., :lpad] = pad
    for lo, hi, q, slo, shi in lpieces:
        out[..., lo:hi] = strips[q, 1, ..., slo:shi]
    end = left + width
    for lo, hi, q, slo, shi in rpieces:
        out[..., end + lo:end + hi] = strips[q, 0, ..., slo:shi]
    if rpad:
        out[..., end + right - rpad:] = pad
    return out


# ---------------------------------------------------------------------------
# the exchange

class _Exchange(torch.autograd.Function):
    """``x`` widened by ``left`` columns of the ranks before it and
    ``right`` of the ranks after it (``pad`` past the image's borders),
    through one ``all_reduce`` of every rank's ``h``-column edge strips,
    by `halo_plan`'s ``plan``."""

    @staticmethod
    def forward(ctx, x, left, right, h, pad, plan, w):
        n, c, hh, width = x.shape
        buf = x.new_zeros((w.size, 2, n, c, hh, h))
        m = put_strips(buf[w.rank], x)
        _all_reduce(buf, w.group)
        ctx.geometry = (left, right, h, width, m, plan, w)
        return assemble(x, buf, plan, left, right, pad)

    @staticmethod
    def backward(ctx, g):
        left, right, h, width, m, (lpieces, _, rpieces, _), w = ctx.geometry
        n, c, hh, _ = g.shape
        buf = g.new_zeros((w.size, 2, n, c, hh, h))
        for lo, hi, q, slo, shi in lpieces:
            buf[q, 1, ..., slo:shi] = g[..., lo:hi]
        end = left + width
        for lo, hi, q, slo, shi in rpieces:
            buf[q, 0, ..., slo:shi] = g[..., end + lo:end + hi]
        _all_reduce(buf, w.group)
        gx = g[..., left:end].clone()
        gx[..., :m] += buf[w.rank, 0, ..., :m]
        gx[..., width - m:] += buf[w.rank, 1, ..., h - m:]
        return gx, None, None, None, None, None, None


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
         h: Optional[int] = None, widths: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``(N, C, H, w)`` block -> ``(N, C, H, left + w + right)``: the
    columns of the ranks before and after it on each side, ``pad`` past the
    image's borders, differentiable.  ``h`` (default ``max(left, right)``)
    is the strip width every rank exchanges, and ``widths`` (default equal
    blocks) every rank's block width: both the same on every rank of the
    group, ``h`` at least what any of them reads."""
    w = _WIDTH
    if w is None:
        raise ValueError("halo needs a width group")
    h = max(left, right) if h is None else h
    if max(left, right) > h:
        raise ValueError(f"a halo of {left} and {right} columns is wider than the "
                         f"{h}-column strips")
    widths = [x.shape[-1]] * w.size if widths is None else widths
    if widths[w.rank] != x.shape[-1]:
        raise ValueError(f"rank {w.rank}'s block of {x.shape[-1]} columns is not the "
                         f"{widths[w.rank]} of the layout {list(widths)}")
    plan = halo_plan(w.rank, left, right, [min(n, h) for n in widths], h)
    return _Exchange.apply(x, left, right, h, pad, plan, w)


def _layout(x: torch.Tensor, w: Width) -> List[int]:
    """Every rank's block width of ``x``: what the last op that returned a
    tensor of ``x``'s height recorded, else equal blocks (the image's)."""
    widths = w.layouts.get(x.shape[-2])
    if widths is None:
        return [x.shape[-1]] * w.size
    if widths[w.rank] != x.shape[-1]:
        raise ValueError(f"rank {w.rank}'s block of {x.shape[-1]} columns is not the "
                         f"{widths[w.rank]} that the op before it returned")
    return widths


def _record(w: Width, height: int, widths: List[int], in_height: int,
            strided: bool) -> None:
    if strided and height == in_height:
        raise ValueError("a W-sharded strided op must shrink the height, which names "
                         "its blocks; the image is too low")
    w.layouts[height] = widths


def _window(x: torch.Tensor, window: Span, h: int, pad: float,
            widths: Sequence[int]) -> torch.Tensor:
    """This rank's ``window`` of its block ``x``, exchanged (strips of
    ``h``, the largest need of any rank; ``widths`` every rank's block)
    and padded."""
    left, right = halo_need(window, x.shape[-1])
    if h:
        x = halo(x, left, right, pad, h, widths)
    return x[..., window[0] + left:window[1] + left]


def op_window(widths: Sequence[int], rank: int, k: int, s: int,
              p: int) -> Tuple[Span, int, List[int]]:
    """``(window, h, out)``: the window that rank ``rank``'s output block of
    an op (kernel extent ``k``, stride ``s``, padding ``p``) reads from its
    block, the strip width of the op's exchange, and every rank's output
    block width, given every rank's input block width ``widths``.  Stride
    1 reads ``p`` and ``k - 1 - p`` columns past any block that is not
    empty and keeps the blocks; a strided op's input must be in equal
    blocks, its windows follow from them, and ``h`` is the most any rank
    reads."""
    width, size = widths[rank], len(widths)
    if s == 1:
        window = (-p, width + k - 1 - p) if width else (0, 0)
        return window, max(p, k - 1 - p), list(widths)
    if len(set(widths)) != 1:
        raise ValueError(f"a strided op's input must be in equal blocks, not {list(widths)}")
    windows = strided_windows(width, size, k, s, p)
    h = max(max(halo_need(win, width)) for win in windows)
    w_out = (size * width + 2 * p - k) // s + 1
    return windows[rank], h, [j1 - j0 for j0, j1 in ownership(width, size, s, w_out)]


def _out_len(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _empty_block(x: torch.Tensor, shape: Tuple[int, ...], *params) -> torch.Tensor:
    """An empty output block of ``shape``, without running the op.  Under
    autograd it depends on ``x`` and ``params``, so that the backward
    reaches this rank's exchanges, as it does every other rank's, and the
    parameters get zero gradients here rather than none."""
    out = x.new_zeros(shape)
    if torch.is_grad_enabled():
        for t in (x, *params):
            if t is not None and t.requires_grad:
                out = out + t.sum() * 0
    return out


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           stride: Pair = 1, padding: Pair = 0, dilation: Pair = 1,
           groups: int = 1) -> torch.Tensor:
    """`F.conv2d` (zero padding) of the W-sharded ``x``: this rank's block
    of the output, empty where it owns no output column."""
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    w = _WIDTH
    if w is None or w.size == 1:
        return F.conv2d(x, weight, bias, (sh, sw), (ph, pw), (dh, dw), groups)
    in_h, widths = x.shape[-2], _layout(x, w)
    window, h, out = op_window(widths, w.rank, (weight.shape[-1] - 1) * dw + 1, sw, pw)
    x = _window(x, window, h, 0.0, widths)
    if x.shape[-1] == 0:
        kh = (weight.shape[-2] - 1) * dh + 1
        y = _empty_block(x, (x.shape[0], weight.shape[0], _out_len(in_h, kh, sh, ph), 0),
                         weight, bias)
    else:
        y = F.conv2d(x, weight, bias, (sh, sw), (ph, 0), (dh, dw), groups)
    _record(w, y.shape[-2], out, in_h, sw > 1)
    return y


def max_pool2d(x: torch.Tensor, kernel_size: Pair, stride: Optional[Pair] = None,
               padding: Pair = 0) -> torch.Tensor:
    """`F.max_pool2d` of the W-sharded ``x`` (-inf past the borders)."""
    (kh, kw), (ph, pw) = _pair(kernel_size), _pair(padding)
    sh, sw = _pair(kernel_size if stride is None else stride)
    w = _WIDTH
    if w is None or w.size == 1:
        return F.max_pool2d(x, (kh, kw), (sh, sw), (ph, pw))
    in_h, widths = x.shape[-2], _layout(x, w)
    window, h, out = op_window(widths, w.rank, kw, sw, pw)
    x = _window(x, window, h, -math.inf, widths)
    if x.shape[-1] == 0:
        y = _empty_block(x, (*x.shape[:2], _out_len(in_h, kh, sh, ph), 0))
    else:
        y = F.max_pool2d(x, (kh, kw), (sh, sw), (ph, 0))
    _record(w, y.shape[-2], out, in_h, sw > 1)
    return y


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor], stride: Pair = 1, padding: Pair = 0,
                     output_padding: Pair = 0, groups: int = 1, dilation: Pair = 1,
                     block_width: Optional[int] = None) -> torch.Tensor:
    """`F.conv_transpose2d` of the W-sharded ``x``, whose output joins the
    equally sharded grid of ``block_width`` columns a rank: ``x``'s blocks
    are that grid's stride-``s`` image (the ownership rule; some may be
    empty), and this rank returns the grid's columns ``[r n, (r + 1) n)``,
    the last rank also any column of the global output past ``d n``.  It
    records the grid's equal blocks, which the descriptor head's crop
    leaves."""
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    (oh, ow), (dh, dw) = _pair(output_padding), _pair(dilation)
    w = _WIDTH
    if w is None or w.size == 1:
        return F.conv_transpose2d(x, weight, bias, (sh, sw), (ph, pw), (oh, ow),
                                  groups, (dh, dw))
    if block_width is None:
        raise ValueError("a W-sharded transposed convolution needs the block width "
                         "of the grid its output joins")
    k = (weight.shape[-1] - 1) * dw + 1
    blocks, outs, windows = transposed_windows(block_width, w.size, k, sw, pw, ow)
    widths, got = [b - a for a, b in blocks], _layout(x, w)
    if got != widths:
        raise ValueError(f"the blocks {got} are not the stride-{sw} image {widths} of "
                         f"{block_width}-column blocks")
    a = blocks[w.rank][0]
    h = max(max(halo_need(win, n)) for win, n in zip(windows, widths))
    xw = _window(x, windows[w.rank], h, 0.0, widths)
    i_lo = a + windows[w.rank][0]
    j0, j1 = outs[w.rank]
    span = (xw.shape[-1] - 1) * sw + k
    extra = max(0, j1 - sw * i_lo + pw - span)     # < sw: columns of no input
    y = F.conv_transpose2d(xw, weight, bias, (sh, sw), (ph, 0), (oh, extra),
                           groups, (dh, dw))
    y = y[..., j0 - sw * i_lo + pw:j1 - sw * i_lo + pw]
    _record(w, y.shape[-2], [block_width] * w.size, x.shape[-2], False)
    return y


# ---------------------------------------------------------------------------
# whole tensors from blocks

class _GatherWidth(torch.autograd.Function):
    """Every rank's equal block of ``x`` along ``dim`` in rank order: a zero
    global buffer into which this rank writes its block, summed over the
    group.  Backward, the adjoint of that all-gather: one all-reduce of the
    gathered tensor's gradient (every rank's use of every block), then this
    rank's block of it."""

    @staticmethod
    def forward(ctx, x, dim, g, rank, size):
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = size * n
        buf = x.new_zeros(shape)
        buf.narrow(dim, rank * n, n).copy_(x)
        _gather(buf, g)
        ctx.geometry = (dim, g, rank, n)
        return buf

    @staticmethod
    def backward(ctx, grad):
        dim, g, rank, n = ctx.geometry
        total = grad.clone(memory_format=torch.contiguous_format)
        _gather(total, g)
        return total.narrow(dim, rank * n, n), None, None, None, None


def gather_width(x: torch.Tensor, dim: int,
                 g: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Every rank's equal block of ``x`` along ``dim``, in rank order, on
    every rank of ``g`` (``None``: the width group), differentiable: the
    forward is exact, since ``x + 0 = x``, and so is the backward where each
    entry's gradient comes from one rank (the descriptor loss's items).
    ``x`` itself outside a width group or in a group of one rank."""
    g = g if g is not None else group()
    if g is None or dist.get_world_size(g) == 1:
        return x
    return _GatherWidth.apply(x, dim, g, dist.get_rank(g), dist.get_world_size(g))


def own_block(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's equal block along ``dim`` of a whole-width tensor, as a
    compact copy; ``x`` itself outside a width group."""
    rank, size = split()
    if size == 1:
        return x
    if x.shape[dim] % size:
        raise ValueError(f"{x.shape[dim]} columns do not split into {size} equal blocks")
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n).contiguous()


@torch.no_grad()
def sum_blocks(x: torch.Tensor, g: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """``x`` summed over ``g`` (``None``: the width group) in place, where
    one rank holds each entry and the others zeros: exact, like
    `gather_width`."""
    g = g if g is not None else group()
    if g is not None and dist.get_world_size(g) > 1:
        _gather(x, g)
    return x


def _gather(buf: torch.Tensor, g: dist.ProcessGroup) -> None:
    counts["gathers"] += 1
    counts["gather_bytes"] += buf.numel() * buf.element_size()
    dist.all_reduce(buf, group=g)
