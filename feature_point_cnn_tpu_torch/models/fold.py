"""BatchNorm folding: an exact inference-time transform of a ``state_dict``
(`feature_point_cnn_tpu/models/fold.py:45-95`).

At inference BatchNorm is the per-channel affine ``y = (x - mu) * g + beta``
with ``g = gamma / sqrt(var + eps)``; after a convolution it is exactly a
convolution with weight ``W * g`` (scaled along the output channels) and
bias ``(b - mu) * g + beta``.  The folded model (``fold_bn=True``) has no
BatchNorm pass at all and gives its convolutions a bias instead.

Pairs, by the port's parameter names: ``bn1 <- conv1`` and ``bn2 <- conv2``
in every block and in the stem, ``identity_downsample.1 <-
identity_downsample.0``, and the descriptor head's ``bn <- up_sample``.  A
``ConvTranspose2d`` keeps its weight as ``(C_in, C_out, kh, kw)``, so its
scale runs along dim 1.  An unpaired BatchNorm raises, so a change of
topology cannot skip a fold.  The arithmetic is float32, eps 1e-5.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

_EPS = 1e-5
_BN_FIELDS = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked")
_TRANSPOSED = ("descriptor.up_sample",)


def _partner(bn: str) -> str:
    """The convolution a BatchNorm normalizes."""
    head, _, last = bn.rpartition(".")
    if last in ("bn1", "bn2"):
        return f"{head}.conv{last[-1]}"
    if bn.endswith("identity_downsample.1"):
        return f"{head}.0"
    if bn == "descriptor.bn":
        return "descriptor.up_sample"
    raise ValueError(f"unrecognized BatchNorm {bn!r}")


def fold_batchnorm(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The live-BN ``state_dict`` -> the ``fold_bn=True`` model's, float32,
    on the tensors' own device."""
    bns = [k[: -len(".running_mean")] for k in state_dict
           if k.endswith(".running_mean")]
    bn_keys = {f"{bn}.{f}" for bn in bns for f in _BN_FIELDS}
    out = {k: v for k, v in state_dict.items() if k not in bn_keys}
    for bn in bns:
        conv = _partner(bn)
        if f"{conv}.weight" not in state_dict:
            raise ValueError(f"BatchNorm {bn!r} has no partner {conv!r}")

        def f32(name: str) -> torch.Tensor:
            return state_dict[name].to(torch.float32)

        mean, var = f32(f"{bn}.running_mean"), f32(f"{bn}.running_var")
        g = f32(f"{bn}.weight") / torch.sqrt(var + _EPS)
        weight = f32(f"{conv}.weight")
        shape = (1, -1, 1, 1) if conv in _TRANSPOSED else (-1, 1, 1, 1)
        bias = (state_dict[f"{conv}.bias"].to(torch.float32)
                if f"{conv}.bias" in state_dict else torch.zeros_like(mean))
        out[f"{conv}.weight"] = weight * g.reshape(shape)
        out[f"{conv}.bias"] = (bias - mean) * g + f32(f"{bn}.bias")
    return out
