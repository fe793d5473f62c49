"""A plain reference of SuperGlue (Sarlin et al., CVPR 2020, arXiv:1911.11763):
one pair at a time, on that pair's valid keypoints only, in float32 (the
caller turns TF32 off), following the published code line by line
(magicleap/SuperGluePretrainedNetwork, ``models/superglue.py``): the MLPs
of 1x1 ``Conv1d`` + ``BatchNorm1d`` (eval) + ReLU, the heads interleaved
as ``view(b, dim, heads, n)``, attention by ``einsum``, the dustbin and
the log-space Sinkhorn.  Imports nothing of the port.

The weights are a flat dict under the published state-dict names; ``cfg``
holds the published ``default_config`` keys (``descriptor_dim``,
``keypoint_encoder``, ``GNN_layers``, ``sinkhorn_iterations``,
``match_threshold``) and ``num_heads`` and ``bn_eps``.  Keypoints are
``(n, 3)`` ``[y, x, score]`` in pixels, descriptors ``(n, D)``.

``q`` rounds the operands of every product (each 1x1 convolution's input
and weight, both attention products and the score matrix): the identity
for the reference, a lower precision for a control.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

Q = Callable[[torch.Tensor], torch.Tensor]


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _conv(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor, q: Q) -> torch.Tensor:
    return F.conv1d(q(x), q(p[f"{name}.weight"]), p[f"{name}.bias"])


def mlp(p, name: str, n_layers: int, x: torch.Tensor, q: Q, eps: float) -> torch.Tensor:
    """The published ``MLP`` (``nn.Sequential`` of ``Conv1d``,
    ``BatchNorm1d``, ``ReLU``, ..., ``Conv1d``) of ``n_layers`` convolutions
    on ``(1, C, n)``."""
    i = 0
    for layer in range(n_layers):
        x = _conv(p, f"{name}.{i}", x, q)
        i += 1
        if layer < n_layers - 1:
            bn = f"{name}.{i}"
            x = F.batch_norm(x, p[f"{bn}.running_mean"], p[f"{bn}.running_var"],
                             p[f"{bn}.weight"], p[f"{bn}.bias"], False, 0.0, eps)
            x = torch.relu(x)
            i += 2
    return x


def normalize_keypoints(kpts: torch.Tensor, image_shape) -> torch.Tensor:
    """The published normalisation of ``(1, n, 2)`` ``(x, y)`` keypoints."""
    _, _, height, width = image_shape
    one = kpts.new_tensor(1)
    size = torch.stack([one * width, one * height])[None]
    center = size / 2
    scaling = size.max(1, keepdim=True).values * 0.7
    return (kpts - center[:, None, :]) / scaling[:, None, :]


def attention(query, key, value, q: Q):
    dim = query.shape[1]
    scores = torch.einsum("bdhn,bdhm->bhnm", q(query), q(key)) / dim ** .5
    prob = torch.nn.functional.softmax(scores, dim=-1)
    return torch.einsum("bhnm,bdhm->bdhn", q(prob), q(value))


def multi_head(p, name: str, heads: int, query, key, value, q: Q):
    batch_dim = query.size(0)
    dim = query.shape[1] // heads
    query, key, value = [_conv(p, f"{name}.proj.{i}", x, q).view(batch_dim, dim, heads, -1)
                         for i, x in enumerate((query, key, value))]
    x = attention(query, key, value, q)
    return _conv(p, f"{name}.merge", x.contiguous().view(batch_dim, dim * heads, -1), q)


def propagate(p, name: str, cfg: dict, x, source, q: Q):
    message = multi_head(p, f"{name}.attn", cfg["num_heads"], x, source, source, q)
    return mlp(p, f"{name}.mlp", 2, torch.cat([x, message], dim=1), q, cfg["bn_eps"])


def gnn(p, cfg: dict, desc0, desc1, q: Q):
    for i, name in enumerate(cfg["GNN_layers"]):
        if name == "cross":
            src0, src1 = desc1, desc0
        else:  # if name == 'self':
            src0, src1 = desc0, desc1
        layer = f"gnn.layers.{i}"
        delta0 = propagate(p, layer, cfg, desc0, src0, q)
        delta1 = propagate(p, layer, cfg, desc1, src1, q)
        desc0, desc1 = (desc0 + delta0), (desc1 + delta1)
    return desc0, desc1


def log_sinkhorn_iterations(Z, log_mu, log_nu, iters: int):
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z + v.unsqueeze(1), dim=2)
        v = log_nu - torch.logsumexp(Z + u.unsqueeze(2), dim=1)
    return Z + u.unsqueeze(2) + v.unsqueeze(1)


def log_optimal_transport(scores, alpha, iters: int):
    b, m, n = scores.shape
    one = scores.new_tensor(1)
    ms, ns = (m * one).to(scores), (n * one).to(scores)
    bins0 = alpha.expand(b, m, 1)
    bins1 = alpha.expand(b, 1, n)
    alpha = alpha.expand(b, 1, 1)
    couplings = torch.cat([torch.cat([scores, bins0], -1),
                           torch.cat([bins1, alpha], -1)], 1)
    norm = - (ms + ns).log()
    log_mu = torch.cat([norm.expand(m), ns.log()[None] + norm])
    log_nu = torch.cat([norm.expand(n), ms.log()[None] + norm])
    log_mu, log_nu = log_mu[None].expand(b, -1), log_nu[None].expand(b, -1)
    Z = log_sinkhorn_iterations(couplings, log_mu, log_nu, iters)
    return Z - norm


@torch.no_grad()
def match_pair(p: Dict[str, torch.Tensor], cfg: dict, kp0: torch.Tensor,
               desc0: torch.Tensor, kp1: torch.Tensor, desc1: torch.Tensor,
               image_size: Tuple[int, int], q: Q = _same) -> dict:
    """One pair: ``Z (n+1, m+1)`` (None without keypoints on a side),
    ``index (n,)`` int64 (-1 = no match) and ``score (n,)``, ``exp(max_j
    Z_ij)`` before the mutual and threshold tests (0 without keypoints on
    the other side)."""
    n, m = kp0.shape[0], kp1.shape[0]
    if n == 0 or m == 0:
        return {"Z": None, "index": torch.full((n,), -1, dtype=torch.int64, device=kp0.device),
                "score": kp0.new_zeros(n)}
    shape = (1, 1, *image_size)
    layers = len(cfg["keypoint_encoder"]) + 1

    def kenc(kpts, scores):
        inputs = [kpts.transpose(1, 2), scores.unsqueeze(1)]
        return mlp(p, "kenc.encoder", layers, torch.cat(inputs, dim=1), q, cfg["bn_eps"])

    kpts0 = normalize_keypoints(kp0[None, :, [1, 0]].float(), shape)
    kpts1 = normalize_keypoints(kp1[None, :, [1, 0]].float(), shape)
    desc0 = desc0.float().T[None] + kenc(kpts0, kp0[None, :, 2].float())
    desc1 = desc1.float().T[None] + kenc(kpts1, kp1[None, :, 2].float())
    desc0, desc1 = gnn(p, cfg, desc0, desc1, q)
    mdesc0, mdesc1 = _conv(p, "final_proj", desc0, q), _conv(p, "final_proj", desc1, q)
    scores = torch.einsum("bdn,bdm->bnm", q(mdesc0), q(mdesc1))
    scores = scores / cfg["descriptor_dim"] ** .5
    scores = log_optimal_transport(scores, p["bin_score"], cfg["sinkhorn_iterations"])
    max0, max1 = scores[:, :-1, :-1].max(2), scores[:, :-1, :-1].max(1)
    indices0, indices1 = max0.indices, max1.indices
    mutual0 = torch.arange(n, device=scores.device)[None] == indices1.gather(1, indices0)
    zero = scores.new_tensor(0)
    mscores0 = torch.where(mutual0, max0.values.exp(), zero)
    valid0 = mutual0 & (mscores0 > cfg["match_threshold"])
    indices0 = torch.where(valid0, indices0, indices0.new_tensor(-1))
    return {"Z": scores[0], "index": indices0[0], "score": max0.values.exp()[0]}
