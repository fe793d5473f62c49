"""SuperGlue: a learned matcher of SuperPoint keypoints (Sarlin, DeTone,
Malisiewicz and Rabinovich, "SuperGlue: Learning Feature Matching with Graph
Neural Networks", CVPR 2020, arXiv:1911.11763), as the published code
computes it (magicleap/SuperGluePretrainedNetwork, ``models/superglue.py``).

* Keypoint encoder: positions normalised as ``(k - [W/2, H/2]) / (0.7
  max(W, H))``, then ``desc += MLP([3, 32, 64, 128, 256, 256])(x, y,
  score)``; an MLP is a chain of 1x1 convolutions, each but the last
  followed by BatchNorm and ReLU.
* Attentional propagation, 18 layers alternating self and cross: ``q, k, v
  = proj(x), proj(src), proj(src)`` viewed as ``(b, 64, 4, n)`` (channel
  ``c = d * 4 + h``: the heads interleave), ``msg = merge(softmax(q^T k /
  8) v)``, ``x += MLP([512, 512, 256])(cat[x, msg])``; both sides update
  from the same layer input and share the layer's weights.
* Assignment: ``S = final_proj(x0)^T final_proj(x1) / 16``, a learned
  dustbin ``bin_score`` around it, 100 iterations of the log-space
  Sinkhorn with the marginals ``[-log(M+N)] * N ++ [log M - log(M+N)]``,
  and ``Z = S + u + v + log(M+N)``.
* Matches: mutual row and column argmaxes of ``Z[:N, :M]`` whose score
  ``exp(max_j Z_ij)`` exceeds ``match_threshold``.

Parameter names are the published state dict's (``kenc.encoder.*``,
``gnn.layers.{i}.attn.proj.{0,1,2}.*``, ``.attn.merge.*``, ``.mlp.*``,
``final_proj.*``, ``bin_score``), so a published ``.pth`` loads unchanged.

Unlike the published code, which takes one unpadded pair, this takes a
batch of pairs padded to fixed widths with each side's valid row count:
attention masks the padded keys, and the Sinkhorn gives padded rows and
columns a marginal of -inf (and starts their potentials there), so a
pair's valid rows get what the unpadded pair gives.  Layout inside is
``(pairs, rows, channels)``; the 1x1 convolutions are matrix products.
The projections are applied with their output channels permuted to
head-major order (a fixed permutation of the published weights, the merge's
input columns permuted alike), so that each head's 64 channels lie
together for `scaled_dot_product_attention`; the arithmetic is the
published interleave's.

Precision (`config.SuperGlueConfig`): the 1x1 convolutions, the attention
and the MLPs' products run in ``compute_dtype``; the residual stream,
BatchNorm (eval: running statistics), the score matrix and the whole
Sinkhorn in float32.  The Sinkhorn is `ops/kernels/sinkhorn.py`'s: a
hand-written CUDA kernel on the card, the plain loop on the CPU; it is
called through this module's ``log_optimal_transport`` name.

The tracer's spans inside a call: ``superglue.encode`` (the keypoint
encoder), ``superglue.gnn`` and ``superglue.sinkhorn`` (the score matrix,
the Sinkhorn and the matches); the counters ``superglue.pairs`` and
``superglue.sinkhorn_iters`` (iterations times pairs).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from feature_point_cnn_tpu_torch.config import SuperGlueConfig
from feature_point_cnn_tpu_torch.ops.kernels.sinkhorn import log_optimal_transport
from feature_point_cnn_tpu_torch.utils import profiling

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def mlp(channels: List[int]) -> nn.Sequential:
    """The published ``MLP``: 1x1 ``Conv1d`` layers, each but the last
    followed by ``BatchNorm1d`` and ReLU."""
    layers: List[nn.Module] = []
    for i in range(1, len(channels)):
        layers.append(nn.Conv1d(channels[i - 1], channels[i], kernel_size=1, bias=True))
        if i < len(channels) - 1:
            layers += [nn.BatchNorm1d(channels[i]), nn.ReLU()]
    return nn.Sequential(*layers)


class KeypointEncoder(nn.Module):
    def __init__(self, feature_dim: int, layers: Tuple[int, ...]):
        super().__init__()
        self.encoder = mlp([3, *layers, feature_dim])


class MultiHeadedAttention(nn.Module):
    def __init__(self, num_heads: int, d_model: int):
        super().__init__()
        self.num_heads = num_heads
        self.merge = nn.Conv1d(d_model, d_model, kernel_size=1)
        self.proj = nn.ModuleList([nn.Conv1d(d_model, d_model, kernel_size=1)
                                   for _ in range(3)])
        # head-major channel j = h * dim + d holds the published channel
        # d * num_heads + h
        dim = d_model // num_heads
        order = torch.arange(dim)[None, :] * num_heads + torch.arange(num_heads)[:, None]
        self.register_buffer("head_major", order.reshape(-1), persistent=False)


class AttentionalPropagation(nn.Module):
    def __init__(self, feature_dim: int, num_heads: int):
        super().__init__()
        self.attn = MultiHeadedAttention(num_heads, feature_dim)
        self.mlp = mlp([feature_dim * 2, feature_dim * 2, feature_dim])


class AttentionalGNN(nn.Module):
    def __init__(self, feature_dim: int, layer_names: Tuple[str, ...], num_heads: int):
        super().__init__()
        self.layers = nn.ModuleList([AttentionalPropagation(feature_dim, num_heads)
                                     for _ in layer_names])
        self.names = tuple(layer_names)


def _linear(conv: nn.Conv1d, x: torch.Tensor, dtype, rows=None, cols=None) -> torch.Tensor:
    """A 1x1 ``Conv1d`` on ``(..., rows, channels)``: ``x W^T + b`` in
    ``dtype``; ``rows``/``cols`` permute the weight's output/input
    channels."""
    w, b = conv.weight[..., 0], conv.bias
    if rows is not None:
        w, b = w[rows], b[rows]
    if cols is not None:
        w = w[:, cols]
    return F.linear(x.to(dtype), w.to(dtype), b.to(dtype))


def _run_mlp(seq: nn.Sequential, x: torch.Tensor, dtype) -> torch.Tensor:
    """An `mlp` on ``(B, L, C)``: products in ``dtype``, BatchNorm (eval)
    in float32; the last product's output is returned in ``dtype``."""
    for m in seq:
        if isinstance(m, nn.Conv1d):
            x = _linear(m, x, dtype)
        elif isinstance(m, nn.BatchNorm1d):
            c = x.shape[-1]
            x = F.batch_norm(x.float().reshape(-1, c), m.running_mean, m.running_var,
                             m.weight, m.bias, False, 0.0, m.eps).view(x.shape)
        else:
            x = torch.relu(x)
    return x


def normalize_keypoints(kp: torch.Tensor, image_size: Tuple[int, int]) -> torch.Tensor:
    """``(..., 3)`` ``[y, x, score]`` pixels -> ``(..., 3)`` ``[x', y',
    score]``, the positions as the published ``normalize_keypoints``."""
    h, w = image_size
    scale = 0.7 * max(h, w)
    return torch.stack([(kp[..., 1] - w / 2) / scale, (kp[..., 0] - h / 2) / scale,
                        kp[..., 2]], dim=-1)


class SuperGlue(nn.Module):
    """``forward(kp0, desc0, num0, kp1, desc1, num1, image_size) -> (index,
    score)`` (`assign`), and `log_assignment` with the same arguments ->
    ``Z``.

    ``kp*``: ``(B, N|M, 3)`` float32 ``[y, x, score]`` in pixels of an
    ``image_size = (H, W)`` frame; ``desc*``: ``(B, N|M, D)`` unit
    descriptors (any float type); ``num*``: ``(B,)`` valid rows, the first
    ones of each side.  ``Z``: ``(B, N+1, M+1)`` float32 log assignment
    with the dustbins last, -inf at padded rows and columns."""

    def __init__(self, config: SuperGlueConfig = SuperGlueConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.compute_dtype = _DTYPES[config.compute_dtype]
        d = config.descriptor_dim
        self.kenc = KeypointEncoder(d, config.keypoint_encoder)
        self.gnn = AttentionalGNN(d, config.gnn_layers, config.num_heads)
        self.final_proj = nn.Conv1d(d, d, kernel_size=1, bias=True)
        self.bin_score = nn.Parameter(torch.tensor(1.0))
        for m in self.modules():
            if isinstance(m, nn.BatchNorm1d):
                m.eps = config.bn_eps
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """LeCun-normal kernels drawn from ``generator``, zero biases,
        identity BatchNorms, ``bin_score`` 1 (the published initial value)."""
        for m in self.modules():
            if isinstance(m, nn.Conv1d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()
        self.bin_score.fill_(1.0)

    def _attend(self, layer: AttentionalPropagation, x, src, key_mask) -> torch.Tensor:
        """The layer's message: ``(B2, L, C)`` queries ``x`` over the keys
        ``src`` where ``key_mask`` ``(B2, L)`` holds."""
        attn, dtype = layer.attn, self.compute_dtype
        b, n, c = x.shape
        heads = attn.num_heads
        order = attn.head_major

        def split(t):
            return t.view(b, -1, heads, c // heads).transpose(1, 2)

        q = split(_linear(attn.proj[0], x, dtype, rows=order))
        k = split(_linear(attn.proj[1], src, dtype, rows=order))
        v = split(_linear(attn.proj[2], src, dtype, rows=order))
        msg = F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask[:, None, None, :])
        return _linear(attn.merge, msg.transpose(1, 2).reshape(b, n, c), dtype, cols=order)

    def forward(self, kp0, desc0, num0, kp1, desc1, num1,
                image_size: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.log_assignment(kp0, desc0, num0, kp1, desc1, num1, image_size)
        with profiling.span("superglue.sinkhorn"):
            return assign(z, num0, self.config.match_threshold)

    def log_assignment(self, kp0, desc0, num0, kp1, desc1, num1,
                       image_size: Tuple[int, int]) -> torch.Tensor:
        cfg, dtype = self.config, self.compute_dtype
        b, n, m = kp0.shape[0], kp0.shape[1], kp1.shape[1]
        width = max(n, m)
        valid0 = torch.arange(n, device=kp0.device) < num0[:, None]
        valid1 = torch.arange(m, device=kp1.device) < num1[:, None]
        profiling.count("superglue.pairs", b)
        profiling.count("superglue.sinkhorn_iters", b * cfg.sinkhorn_iterations)

        def both(t0, t1):
            # the two sides as one batch of 2B, padded to one width
            return torch.cat([F.pad(t0, (0, 0, 0, width - n)), F.pad(t1, (0, 0, 0, width - m))])

        with profiling.span("superglue.encode"):
            kp = normalize_keypoints(both(kp0, kp1), image_size)
            x = both(desc0.float(), desc1.float()) + _run_mlp(self.kenc.encoder, kp, dtype).float()
        with profiling.span("superglue.gnn"):
            mask = torch.cat([F.pad(valid0, (0, width - n)), F.pad(valid1, (0, width - m))])
            # a side with no keypoints attends to its padding: finite
            # messages, to rows that no output reads
            mask = mask | ~mask.any(1, keepdim=True)
            swapped = torch.cat([mask[b:], mask[:b]])
            for layer, name in zip(self.gnn.layers, self.gnn.names):
                if name == "cross":
                    src, key_mask = torch.cat([x[b:], x[:b]]), swapped
                else:
                    src, key_mask = x, mask
                msg = self._attend(layer, x, src, key_mask)
                x = x + _run_mlp(layer.mlp, torch.cat([x.to(dtype), msg], -1), dtype).float()
        with profiling.span("superglue.sinkhorn"):
            md = _linear(self.final_proj, x, dtype).float()
            scores = torch.einsum("bnd,bmd->bnm", md[:b, :n], md[b:, :m])
            scores = scores / cfg.descriptor_dim ** 0.5
            return log_optimal_transport(scores, self.bin_score, valid0, valid1,
                                         cfg.sinkhorn_iterations)


def assign(z: torch.Tensor, num0: torch.Tensor, threshold: float
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``Z`` -> ``(index (B, N) int64, -1 = none; score (B, N) float32)``:
    a valid row's match is its row argmax where that is mutual and
    ``exp(max_j Z_ij)`` exceeds ``threshold``; ``score`` is that
    ``exp(max_j Z_ij)`` on every valid row (0 elsewhere), before the mutual
    and threshold tests."""
    core = z[:, :-1, :-1]
    n = core.shape[1]
    best0, index0 = core.max(2)
    index1 = core.max(1).indices
    rows = torch.arange(n, device=z.device)
    valid0 = rows < num0[:, None]
    mutual = rows[None] == index1.gather(1, index0)
    score = torch.where(valid0, best0.exp(), 0.0)
    keep = valid0 & mutual & (score > threshold)
    return torch.where(keep, index0, -1), score
