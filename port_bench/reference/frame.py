"""The plain reference of the serving frame: forward, decode, threshold,
exact greedy NMS, border strip, the top N keypoints, bilinear descriptor
sampling and mutual-nearest-neighbour matching against a keyframe, in
float32 (or the control's precision for the forward).  Imports nothing of
the port.

What it computes is the configuration's semantics:

* greedy NMS in the L-inf window of radius ``nms_dist``: points in order
  of falling score (the lower row-major index first among equal scores),
  each kept unless a kept point lies in its window; computed as rounds of
  "keep every remaining point that is the largest of its window, drop the
  windows of the kept", which is the same on a strict order;
* the border strip after NMS, so border points still suppress;
* descriptors sampled at ``(y / H * (Hc - 1), x / W * (Wc - 1))`` on the
  descriptor grid (``grid_sample`` with ``align_corners=True`` of the
  reference's normalisation), then L2-normalised;
* a match is mutual nearest by dot product, with ``L2 <= nn_thresh``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import models
from port_bench.reference.precision import QUANT

CHUNK = 16      # images a forward at once


def greedy_nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """``(B, H, W)`` thresholded scores (0 = none) -> the kept scores."""
    b, h, w = scores.shape
    # a strict order: float64 score, and below its float32 resolution the
    # lower index first
    index = torch.arange(h * w, device=scores.device, dtype=torch.float64).view(1, h, w)
    key = torch.where(scores > 0, scores.double() + (h * w - index) * 2.0 ** -50,
                      torch.zeros((), dtype=torch.float64, device=scores.device))
    kept = torch.zeros_like(scores, dtype=torch.bool)
    k = 2 * radius + 1
    while bool((key > 0).any()):
        wmax = F.max_pool2d(key[:, None], k, 1, radius)[:, 0]
        win = (key > 0) & (key == wmax)
        kept |= win
        dead = F.max_pool2d(win[:, None].double(), k, 1, radius)[:, 0] > 0
        key = torch.where(dead, torch.zeros_like(key), key)
    return torch.where(kept, scores, torch.zeros_like(scores))


def sample(desc_map: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
           h: int, w: int) -> torch.Tensor:
    """``(B, D, Hc, Wc)`` at ``(B, N)`` pixel coordinates -> ``(B, N, D)``
    unit vectors."""
    b, d, hc, wc = desc_map.shape
    sy, sx = y / h * (hc - 1), x / w * (wc - 1)
    y0, x0 = sy.floor(), sx.floor()
    wy, wx = (sy - y0)[..., None], (sx - x0)[..., None]
    y0, x0 = y0.long().clamp(0, hc - 1), x0.long().clamp(0, wc - 1)
    y1, x1 = (y0 + 1).clamp(max=hc - 1), (x0 + 1).clamp(max=wc - 1)
    flat = desc_map.flatten(2).transpose(1, 2)                 # (B, Hc*Wc, D)

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * wc + xx)[..., None].expand(-1, -1, d))

    v = (at(y0, x0) * (1 - wx) + at(y0, x1) * wx) * (1 - wy) \
        + (at(y1, x0) * (1 - wx) + at(y1, x1) * wx) * wy
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-12)


def mnn(desc_a: torch.Tensor, valid_a: torch.Tensor, desc_b: torch.Tensor,
        valid_b: torch.Tensor, max_l2: float) -> torch.Tensor:
    """``(N, D)`` against ``(M, D)`` -> ``(N,)`` index into b, -1 where no
    mutual nearest neighbour within ``max_l2``."""
    sim = desc_a @ desc_b.T
    sim = sim.masked_fill(~(valid_a[:, None] & valid_b[None, :]), float("-inf"))
    best = sim.argmax(1)
    best_sim = sim.amax(1)
    back = sim.argmax(0)
    ok = valid_a & torch.isfinite(best_sim) & (back[best] == torch.arange(
        len(best), device=best.device)) & (best_sim >= 1.0 - 0.5 * max_l2 * max_l2)
    return torch.where(ok, best, -1)


class ResNetFrame:
    """The frame of the ResNet SuperPoint configuration."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], device,
                 precision: str = "float32"):
        self.cfg, self.p, self.device = cfg, weights, device
        self.q = QUANT[precision]

    @torch.no_grad()
    def extract(self, images: np.ndarray) -> dict:
        """``(n, H, W, 1)`` uint8 frames -> the top N keypoints of each:
        ``y``, ``x``, ``score`` ``(n, N)``, ``valid`` and ``desc (n, N,
        D)``, score-sorted, invalid rows zero."""
        cfg = self.cfg
        out = {k: [] for k in ("y", "x", "score", "valid", "desc")}
        for s in range(0, len(images), CHUNK):
            x = torch.from_numpy(images[s:s + CHUNK]).to(self.device)
            x = x.permute(0, 3, 1, 2).float() / 255.0
            x = x.expand(-1, cfg["image_channels"], -1, -1)
            logits, desc_map = models.resnet_forward(self.p, cfg, x, self.q)
            part = keypoints(models.prob_map(logits, cfg["cell"]), desc_map, cfg)
            for k in out:
                out[k].append(part[k])
        return {k: torch.cat(v) for k, v in out.items()}


def keypoints(prob: torch.Tensor, desc_map: torch.Tensor, cfg: dict) -> dict:
    """Threshold, NMS, border, top N and descriptors of ``(B, H, W)``."""
    b, h, w = prob.shape
    scores = torch.where(prob >= cfg["confidence_thresh"], prob, torch.zeros_like(prob))
    scores = greedy_nms(scores, cfg["nms_dist"])
    br = cfg["border_remove"]
    border = torch.zeros_like(scores, dtype=torch.bool)
    border[:, br:h - br, br:w - br] = True
    scores = torch.where(border, scores, torch.zeros_like(scores))
    n = min(cfg["top_n"], cfg["max_keypoints"])
    top, idx = torch.sort(scores.flatten(1), dim=1, descending=True, stable=True)
    top, idx = top[:, :n], idx[:, :n]
    valid = top > 0
    y = torch.where(valid, idx // w, 0).float()
    x = torch.where(valid, idx % w, 0).float()
    desc = sample(desc_map, y, x, h, w) * valid[..., None]
    return {"y": y, "x": x, "score": top * valid, "valid": valid, "desc": desc}


def serve(frame: ResNetFrame, images: np.ndarray, key_images: list) -> dict:
    """The frame program's outputs as a reference computes them, for
    frames ``images (B, H, W, 1)`` matched against ``key_images[i]`` (an
    ``(H, W, 1)`` frame or None: no keyframe): numpy ``num_valid (B,)``,
    ``kp (B, N, 3)`` [y, x, score], ``match (B, N)``, ``desc (B, N, D)``
    and the keyframes' ``key_kp``."""
    ex = frame.extract(images)
    out = {"num_valid": ex["valid"].sum(1).cpu().numpy(),
           "kp": torch.stack([ex["y"], ex["x"], ex["score"]], -1).cpu().numpy(),
           "desc": ex["desc"].cpu().numpy()}
    n = ex["valid"].shape[1]
    match = np.full((len(images), n), -1, np.int64)
    key_kp = [None] * len(images)
    keyed = [i for i, k in enumerate(key_images) if k is not None]
    if keyed:
        kx = frame.extract(np.stack([key_images[i] for i in keyed]))
        for j, i in enumerate(keyed):
            m = mnn(ex["desc"][i], ex["valid"][i], kx["desc"][j], kx["valid"][j],
                    frame.cfg["nn_thresh"])
            match[i] = m.cpu().numpy()
            key_kp[i] = torch.stack([kx["y"][j], kx["x"][j]], -1)[
                kx["valid"][j]].cpu().numpy()
    out["match"], out["key_kp"] = match, key_kp
    return out
