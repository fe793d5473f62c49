"""Plain float32 forwards of the two SuperPoint families, NCHW, from a
configuration file's widths.  Imports nothing of the port.

ResNet SuperPoint (Kolkir/feature-point-cnn ``superpoint.py``): conv7x7/2
+ BatchNorm + ReLU + max pool 3/2, residual layers (conv3x3-BN-ReLU,
conv1x1-BN, a 1x1-BN projected identity on a layer's first block, ReLU of
the sum), a detector layer to 65 logits, and a descriptor branch: a layer
at 1/16, a transposed conv back to 1/8, BN, ReLU, concatenated with the
encoder's output, a layer to D.  Weights come from the snapshot ``.npz``
(Flax layout: HWIO kernels, the transposed kernel in flipped correlation
form, BatchNorm ``scale``/``bias`` with ``mean``/``var`` statistics), read
here with numpy.

VGG SuperPoint (magicleap ``SuperPointNet``): 3x3 conv pairs with ReLU and
2x2 max pools between pairs, heads conv3x3-ReLU-conv1x1, the descriptor
L2-normalised.  Weights: a flat dict ``{name: (weight OIHW, bias)}``.

``q`` rounds every convolution's input and weight, and ``q.out`` its
output (`precision.QUANT`).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Q = Callable[[torch.Tensor], torch.Tensor]


def load_resnet_npz(path: str, device) -> Dict[str, torch.Tensor]:
    """The snapshot's arrays as float32 tensors on ``device``, keyed by
    their ``/`` paths without the top level: kernels OIHW (the transposed
    conv's ``(in, out, kh, kw)``), BatchNorm as ``<name>/scale``,
    ``/bias``, ``/mean``, ``/var``."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            top, rest = key.split("/", 1)
            a = np.asarray(z[key], np.float32)
            if rest.endswith("up_sample/kernel"):
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            elif rest.endswith("kernel"):
                a = a.transpose(3, 2, 0, 1)
            out[rest] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def eval_bn(p, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    """BatchNorm with the snapshot's running statistics."""
    c = (1, -1, 1, 1)
    inv = torch.rsqrt(p[f"{name}/var"] + eps).view(c)
    return (x - p[f"{name}/mean"].view(c)) * inv * p[f"{name}/scale"].view(c) \
        + p[f"{name}/bias"].view(c)


def _conv(p, name: str, x: torch.Tensor, q: Q, stride: int = 1) -> torch.Tensor:
    w = p[f"{name}/kernel"]
    return q.out(F.conv2d(q(x), q(w), stride=stride, padding=w.shape[-1] // 2))


def _layer(p, name: str, x: torch.Tensor, stride: int, blocks: int, q: Q,
           eps: float, _bn) -> torch.Tensor:
    for i in range(blocks):
        pre = f"{name}/block{i}"
        s = stride if i == 0 else 1
        y = torch.relu(_bn(p, f"{pre}/bn1", _conv(p, f"{pre}/conv1", x, q, s), eps))
        y = _bn(p, f"{pre}/bn2", _conv(p, f"{pre}/conv2", y, q), eps)
        if i == 0:
            x = _bn(p, f"{pre}/identity_bn", _conv(p, f"{pre}/identity_conv", x, q, s), eps)
        x = torch.relu(y + x)
    return x


def resnet_forward(p, cfg: dict, image: torch.Tensor, q: Q, _bn=eval_bn
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(B, C, H, W)`` float32 in [0, 1] -> ``(logits (B, 65, Hc, Wc),
    desc (B, D, Hc, Wc))``, the descriptor not normalised.  ``_bn(p, name,
    x, eps)`` is the BatchNorm (`eval_bn`, or a train-mode one)."""
    eps, n = cfg["bn_eps"], cfg["blocks_per_layer"]
    x = torch.relu(_bn(p, "encoder/bn1",
                       _conv(p, "encoder/conv1", image, q, 2), eps))
    x = F.max_pool2d(x, 3, 2, 1)
    x = _layer(p, "encoder/layer1", x, 1, n, q, eps, _bn)
    x = _layer(p, "encoder/layer2", x, 2, n, q, eps, _bn)
    logits = _layer(p, "detector/layer", x, 1, n, q, eps, _bn)
    hc, wc = x.shape[-2:]
    y = _layer(p, "descriptor/layer_in", x, 2, n, q, eps, _bn)
    y = q.out(F.conv_transpose2d(q(y), q(p["descriptor/up_sample/kernel"]),
                                 p["descriptor/up_sample/bias"], stride=2, padding=1,
                                 output_padding=1))
    y = torch.relu(_bn(p, "descriptor/bn", y, eps))[:, :, :hc, :wc]
    desc = _layer(p, "descriptor/layer_out", torch.cat([y, x], 1), 1, n, q, eps, _bn)
    return logits, desc


def vgg_forward(p, cfg: dict, image: torch.Tensor, q: Q):
    """``(B, 1, H, W)`` -> ``(logits (B, 65, Hc, Wc), desc (B, D, Hc, Wc))``,
    the descriptor L2-normalised over D."""
    def conv(name, x):
        w, b = p[name]
        return q.out(F.conv2d(q(x), q(w), b, padding=w.shape[-1] // 2))

    x, last = image, len(cfg["encoder_channels"]) - 1
    for i in range(last + 1):
        x = torch.relu(conv(f"encoder_conv{i}_a", x))
        x = torch.relu(conv(f"encoder_conv{i}_b", x))
        if i != last:
            x = F.max_pool2d(x, 2, 2)
    logits = conv("detector_conv_b", torch.relu(conv("detector_conv_a", x)))
    desc = conv("descriptor_conv_b", torch.relu(conv("descriptor_conv_a", x)))
    desc = desc / torch.linalg.vector_norm(desc, dim=1, keepdim=True).clamp_min(1e-12)
    return logits, desc


def prob_map(logits: torch.Tensor, cell: int) -> torch.Tensor:
    """``(B, 65, Hc, Wc)`` -> ``(B, H, W)``: the reference implementation's
    softmax ``exp(l) / (sum exp(l) + 1e-5)``, the dustbin dropped, each
    cell's 64 channels laid out row-major in its 8x8 pixels."""
    m = logits.amax(1, keepdim=True)
    e = torch.exp(logits - m)
    p = e / (e.sum(1, keepdim=True) + 1e-5 * torch.exp(-m))
    b, _, hc, wc = logits.shape
    p = p[:, :cell * cell].reshape(b, cell, cell, hc, wc)
    return p.permute(0, 3, 1, 4, 2).reshape(b, hc * cell, wc * cell)


@torch.no_grad()
def vgg_maps(cfg: dict, weights: dict, frames: np.ndarray, device, q,
                   chunk: int = 8) -> dict:
    """The plain VGG forward of ``(B, H, W, 1)`` u8 frames, in chunks, as
    numpy ``prob (B, H, W)``, ``desc (B, Hc, Wc, D)``, ``logits (B, Hc, Wc,
    65)``."""
    out = {"prob": [], "desc": [], "logits": []}
    for s in range(0, len(frames), chunk):
        x = torch.from_numpy(frames[s:s + chunk]).to(device).permute(0, 3, 1, 2).float() / 255.0
        logits, desc = vgg_forward(weights, cfg, x, q)
        out["prob"].append(prob_map(logits, cfg["cell"]).cpu().numpy())
        out["desc"].append(desc.permute(0, 2, 3, 1).cpu().numpy())
        out["logits"].append(logits.permute(0, 2, 3, 1).cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}
