"""The plain reference of the joint SuperPoint training step, float32 with
TF32 off.  Imports nothing of the port.

One step, as the configuration states it (the SuperPoint paper's joint
training, in the reference implementation's form):

* the batch's u8 gray images scaled to [0, 1], repeated to the model's
  channels;
* a random homography an image (a centred patch perturbed in perspective,
  scaled, translated and rotated, each choice uniform among those that keep
  the patch in the image), the image warped by it (bilinear, zero outside,
  pixel centres at +0.5), the warp's valid mask eroded by an elliptic
  element, the corner points warped by its inverse;
* 65-class cell labels of both views (a point's cell class, the dustbin
  where a cell has none, ties broken by uniform noise in [0, 0.1));
* one forward of both views with train-mode BatchNorm over the 2B images;
* the detector cross-entropy on each view (the warped view's masked by
  the valid cells) and the hinge descriptor loss over every pair of cells
  (the dot products' ReLU normalised over the warped cells, then over the
  original cells; positive margin 1 weighted by lambda_d on pairs whose
  warped centres lie within cell - 0.5 px, negative margin 0.2 elsewhere;
  the warped view's invalid cells masked; divided by the valid cells times
  N);
* the gradient's global norm clipped, then AdamW (bias-corrected moments,
  decoupled weight decay on the convolution kernels other than the
  projected identities', read before the update).

The random draws are the step's: they are made from one CUDA generator
seeded from ``(seed, epoch, index)``, in the order perspective, scales and
their pick, translation, rotation's pick, then the label noise of each
view, each draw of the shape the step draws.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import models

Params = Dict[str, torch.Tensor]


def step_generator(device, seed: int, epoch: int, index: int) -> torch.Generator:
    """The step's generator: seeded from ``(seed, epoch, index)``."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + epoch) * 1_000_003 + index)


def _rand(gen, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)


_PHI2 = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def _truncated_normal(gen, shape, mean=0.0, std=1.0) -> torch.Tensor:
    """A normal truncated to +-2 sigma, by its inverse CDF."""
    u = (1.0 - _PHI2) + _rand(gen, shape) * (2.0 * _PHI2 - 1.0)
    return (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(-2.0, 2.0) * std + mean


def _pick(gen, cands: torch.Tensor, artifacts: bool) -> torch.Tensor:
    """One ``(4, 2)`` candidate an item, uniform among the valid ones
    (Gumbel maximum)."""
    b, m = cands.shape[:2]
    if artifacts:
        valid = (torch.arange(m, device=cands.device) < m - 1).expand(b, m)
    else:
        valid = ((cands >= 0.0) & (cands < 1.0)).all(dim=3).all(dim=2)
    u = _rand(gen, (b, m)).clamp_min(torch.finfo(torch.float32).tiny)
    g = torch.where(valid, -torch.log(-torch.log(u)), torch.tensor(-math.inf, device=u.device))
    return cands[torch.arange(b, device=cands.device), g.argmax(1)]


def sample_homographies(gen, b: int, h: int, w: int, hc: dict) -> torch.Tensor:
    """``(b, 3, 3)`` float32 homographies mapping warped-image pixel
    coordinates (x, y) to source coordinates."""
    dev = gen.device
    margin = (1.0 - hc["patch_ratio"]) / 2.0
    unit = torch.tensor([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0]], device=dev)
    pts1 = (margin + hc["patch_ratio"] * unit).expand(b, 4, 2)
    pts2 = pts1
    art = hc["allow_artifacts"]
    if hc["perspective"]:
        ax, ay = hc["perspective_amplitude_x"], hc["perspective_amplitude_y"]
        if not art:
            ax, ay = min(ax, margin), min(ay, margin)
        persp = _truncated_normal(gen, (b,), std=ay / 2.0)
        left = _truncated_normal(gen, (b,), std=ax / 2.0)
        right = _truncated_normal(gen, (b,), std=ax / 2.0)
        pts2 = pts2 + torch.stack([torch.stack([left, persp], -1),
                                   torch.stack([left, -persp], -1),
                                   torch.stack([right, persp], -1),
                                   torch.stack([right, -persp], -1)], 1)
    if hc["scaling"]:
        scales = torch.cat([torch.ones((b, 1), device=dev), _truncated_normal(
            gen, (b, hc["n_scales"]), 1.0, hc["scaling_amplitude"] / 2.0)], 1)
        c = pts2.mean(1, keepdim=True)
        pts2 = _pick(gen, (pts2 - c)[:, None] * scales[:, :, None, None] + c[:, None], art)
    if hc["translation"]:
        t_min, t_max = pts2.min(1).values, (1.0 - pts2).min(1).values
        if art:
            t_min, t_max = t_min + hc["translation_overflow"], t_max + hc["translation_overflow"]
        shift = []
        for lo, hi in ((-t_min[:, 0], t_max[:, 0]), (-t_min[:, 1], t_max[:, 1])):
            lo, hi = torch.minimum(lo, hi), torch.maximum(lo, hi)
            hi = torch.where(hi - lo < 1e-12, lo + 1e-5, hi)
            shift.append(_rand(gen, lo.shape) * (hi - lo) + lo)
        pts2 = pts2 + torch.stack(shift, -1)[:, None]
    if hc["rotation"]:
        angles = torch.cat([torch.zeros(1), torch.linspace(
            -hc["max_angle"], hc["max_angle"], hc["n_angles"])]).to(dev)
        c = pts2.mean(1, keepdim=True)
        cos, sin = torch.cos(angles), torch.sin(angles)
        rot = torch.stack([torch.stack([cos, -sin], -1), torch.stack([sin, cos], -1)], -2)
        pts2 = _pick(gen, torch.einsum("bpj,ajk->bapk", pts2 - c, rot) + c[:, None], art)
    scale = torch.tensor([w, h], dtype=torch.float32, device=dev)
    p, q = pts1 * scale, pts2 * scale
    # the homography with H p = q at the four corners, h22 = 1
    px, py, qx, qy = p[..., 0], p[..., 1], q[..., 0], q[..., 1]
    z, o = torch.zeros_like(px), torch.ones_like(px)
    rows = torch.stack([torch.stack([px, py, o, z, z, z, -px * qx, -py * qx], -1),
                        torch.stack([z, z, z, px, py, o, -px * qy, -py * qy], -1)], 2)
    sol = torch.linalg.solve(rows.reshape(b, 8, 8), torch.stack([qx, qy], -1).reshape(b, 8))
    return torch.cat([sol, torch.ones((b, 1), device=dev)], 1).reshape(b, 3, 3)


def warp(images: torch.Tensor, hom: torch.Tensor, mode: str) -> torch.Tensor:
    """``(B, C, H, W)`` warped: output pixel (x, y) samples the source at
    ``H (x + 0.5, y + 0.5) - 0.5``, zero outside."""
    b, _, h, w = images.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=images.device, dtype=torch.float32),
                            torch.arange(w, device=images.device, dtype=torch.float32),
                            indexing="ij")
    pts = torch.stack([xs + 0.5, ys + 0.5, torch.ones_like(xs)], -1).reshape(-1, 3)
    src = torch.einsum("bij,nj->bni", hom, pts)
    src = src[..., :2] / src[..., 2:]                   # (B, HW, 2) x, y + 0.5
    grid = torch.stack([src[..., 0] / w * 2 - 1, src[..., 1] / h * 2 - 1], -1)
    return F.grid_sample(images, grid.view(b, h, w, 2), mode=mode,
                         padding_mode="zeros", align_corners=False)


def ellipse(radius: int) -> torch.Tensor:
    """OpenCV's elliptic structuring element of size ``2r x 2r``."""
    k = 2 * radius
    out = np.zeros((k, k), np.float32)
    for i in range(k):
        dy = i - radius
        dx = int(np.round(radius * np.sqrt(max(radius * radius - dy * dy, 0)) / radius))
        out[i, max(radius - dx, 0):min(radius + dx + 1, k)] = 1.0
    return torch.from_numpy(out)


def erode(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary erosion of ``(B, 1, H, W)`` by `ellipse` anchored at
    ``(r, r)``, outside the image counting as 0."""
    kern = ellipse(radius).to(mask.device)
    x = F.pad(mask, (radius, radius - 1, radius, radius - 1))
    hits = F.conv2d(x, kern[None, None])
    return (hits > kern.sum() - 0.5).float()


def warp_points(points: torch.Tensor, hom: torch.Tensor) -> torch.Tensor:
    """``(B, P, 2)`` (y, x) source points into the warped frame: by the
    inverse homography."""
    inv = torch.linalg.inv(hom)
    xy1 = torch.cat([points.flip(-1), torch.ones_like(points[..., :1])], -1)
    out = torch.einsum("bij,bpj->bpi", inv, xy1)
    return (out[..., :2] / out[..., 2:]).flip(-1)


def cell_labels(points, valid, noise, h: int, w: int, cell: int) -> torch.Tensor:
    """``(B, Hc, Wc)`` classes in [0, 64]: a point's position in its cell
    (row-major), the dustbin 64 where a cell holds none; ties by noise."""
    b = points.shape[0]
    y, x = points[..., 0].long(), points[..., 1].long()   # truncation toward 0
    keep = valid & (y >= 0) & (y < h) & (x >= 0) & (x < w)
    score = torch.zeros((b, h * w + 1), device=points.device)
    score.scatter_(1, torch.where(keep, y * w + x, h * w), 2.0)
    hc, wc = h // cell, w // cell
    s = score[:, :-1].view(b, hc, cell, wc, cell).permute(0, 1, 3, 2, 4).reshape(b, hc, wc, -1)
    s = torch.cat([s, torch.ones_like(s[..., :1])], -1)
    return (s + noise).argmax(-1)


def bn_train(p: Params, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Train-mode BatchNorm: the batch's mean and biased variance."""
    c = (1, -1, 1, 1)
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p[f"{name}/scale"].view(c) \
        + p[f"{name}/bias"].view(c)


def hinge_loss(desc, wdesc, hom, mask, cfg: dict) -> torch.Tensor:
    """The descriptor loss of ``(B, D, Hc, Wc)`` maps of both views."""
    b, dd, hc, wc = desc.shape
    n, cell = hc * wc, cfg["cell"]

    def unit(t):
        t = t.flatten(2).transpose(1, 2)
        return t * torch.rsqrt((t * t).sum(-1, keepdim=True) + 1e-12)

    d, wd = unit(desc), unit(wdesc)
    ys, xs = torch.meshgrid(torch.arange(hc, device=desc.device),
                            torch.arange(wc, device=desc.device), indexing="ij")
    centers = torch.stack([ys, xs], -1).reshape(-1, 2).float() * cell + cell // 2
    wcent = warp_points(centers.expand(b, n, 2), hom)
    mask = mask.reshape(b, n)
    a = torch.relu(d @ wd.transpose(1, 2))
    u = a * torch.rsqrt((a * a).sum(2, keepdim=True) + 1e-12)
    v = u * torch.rsqrt((u * u).sum(1, keepdim=True) + 1e-12)
    s = ((wcent[:, :, None, :] - centers[None, None]) ** 2).sum(-1) < (cell - 0.5) ** 2
    s = s.float()
    hinge = cfg["lambda_d"] * s * torch.relu(cfg["positive_margin"] - v) \
        + (1.0 - s) * torch.relu(v - cfg["negative_margin"])
    return (hinge * mask[:, None, :]).sum() / (mask.sum() * n).clamp_min(1.0)


class TrainStep:
    """The step on float32 parameters ``p`` (npz-style names) and AdamW
    state, in place."""

    def __init__(self, cfg: dict, params: Params, precision_q):
        self.cfg, self.p, self.q = cfg, params, precision_q
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0
        self.grads: Params = {}

    def loss(self, images_u8, points, valid, gen) -> torch.Tensor:
        cfg, hc = self.cfg, self.cfg["homography"]
        x = images_u8.permute(0, 3, 1, 2).float() / 255.0
        x = x.expand(-1, cfg["image_channels"], -1, -1).contiguous()
        b, _, h, w = x.shape
        with torch.no_grad():
            hom = sample_homographies(gen, b, h, w, hc)
            warped = warp(x, hom, "bilinear")
            valid_px = erode(warp(torch.ones_like(x[:, :1]), hom, "nearest"),
                             hc["valid_border_margin"])
            wpoints = warp_points(points, hom)
            wvalid = valid & (wpoints >= 0).all(-1) & (wpoints[..., 0] <= h - 1) \
                & (wpoints[..., 1] <= w - 1)
            cell = cfg["cell"]
            shape = (b, h // cell, w // cell, cell * cell + 1)
            labels = cell_labels(points, valid, 0.1 * _rand(gen, shape), h, w, cell)
            wlabels = cell_labels(wpoints, wvalid, 0.1 * _rand(gen, shape), h, w, cell)
            cmask = (F.max_pool2d(valid_px, cell) > 0).float()[:, 0]
        logits, desc = models.resnet_forward(self.p, cfg, torch.cat([x, warped]), self.q,
                                             bn_train)
        lp = F.log_softmax(logits, 1)
        ce = -lp.gather(1, torch.cat([labels, wlabels])[:, None])[:, 0]
        det = ce[:b].mean()
        wdet = (ce[b:] * cmask).sum() / cmask.sum().clamp_min(1.0)
        return det + wdet + hinge_loss(desc[:b], desc[b:], hom, cmask, cfg)

    def step(self, images_u8, points, valid, gen) -> float:
        """One step; returns its loss and leaves the clipped gradient that
        the optimizer took in ``self.grads``."""
        cfg, opt = self.cfg, self.cfg["optimizer"]
        for v in self.p.values():
            v.requires_grad_(True)
            v.grad = None
        loss = self.loss(images_u8, points, valid, gen)
        loss.backward()
        with torch.no_grad():
            g = {k: v.grad for k, v in self.p.items()}
            norm = torch.sqrt(sum((t * t).sum() for t in g.values()))
            scale = opt["clip_norm"] / norm if norm >= opt["clip_norm"] else 1.0
            self.count += 1
            b1, b2, lr = opt["beta1"], opt["beta2"], opt["learning_rate"]
            for k, v in self.p.items():
                gk = g[k] * scale
                self.grads[k] = gk
                self.mu[k] = b1 * self.mu[k] + (1 - b1) * gk
                self.nu[k] = b2 * self.nu[k] + (1 - b2) * gk * gk
                upd = (self.mu[k] / (1 - b1 ** self.count)) / (
                    torch.sqrt(self.nu[k] / (1 - b2 ** self.count)) + opt["eps"])
                new = v - lr * upd
                if k.endswith("/kernel") and "identity" not in k:
                    new = new - lr * opt["weight_decay"] * v
                v.copy_(new)
                v.grad = None
        return float(loss.detach())


def resnet_params(cfg: dict, device, gen: torch.Generator) -> Params:
    """Fresh float32 parameters under the snapshot's names, drawn in one
    call: LeCun-normal kernels (fan-in = in channels x kernel area), the
    transposed conv's bias 0, BatchNorm scale 1 and bias 0."""
    from port_bench.counts.resnet_superpoint import convs as resnet_convs

    shapes: List[tuple] = []
    for c in resnet_convs(cfg, 64, 64):
        shapes.append((c.name, (c.cin, c.cout, c.k, c.k) if c.transposed
                       else (c.cout, c.cin, c.k, c.k), c.cin * c.k * c.k))
    flat = torch.randn(sum(int(np.prod(s)) for _, s, _ in shapes), generator=gen,
                       device=device)
    out, at = {}, 0
    for name, shape, fan_in in shapes:
        n = int(np.prod(shape))
        out[snapshot_name(name) + "/kernel"] = flat[at:at + n].view(shape) * fan_in ** -0.5
        at += n
    for name, shape, _ in shapes:
        bn = batch_norm_of(name)
        if bn is not None:
            c = shape[1] if name.endswith("up_sample") else shape[0]
            out[f"{bn}/scale"] = torch.ones(c, device=device)
            out[f"{bn}/bias"] = torch.zeros(c, device=device)
    up = [k for k in out if k.endswith("up_sample/kernel")][0]
    out[up.replace("kernel", "bias")] = torch.zeros(out[up].shape[1], device=device)
    return out


def snapshot_name(conv: str) -> str:
    """A conv's name in `counts.convs` (``encoder.layer1.0.conv1``) as the
    snapshot names it (``encoder/layer1/block0/conv1``)."""
    out = []
    for part in conv.split("."):
        if part.isdigit():
            out.append(f"block{part}")
        elif part == "identity":
            out.append("identity_conv")
        else:
            out.append(part)
    return "/".join(out)


def batch_norm_of(conv_snapshot: str):
    """The BatchNorm after a conv (its snapshot name), None for none."""
    name = snapshot_name(conv_snapshot)
    if name == "encoder/conv1":
        return "encoder/bn1"
    if name.endswith("up_sample"):
        return "descriptor/bn"
    if name.endswith("identity_conv"):
        return name.replace("identity_conv", "identity_bn")
    if name.endswith("conv1"):
        return name[:-5] + "bn1"
    return name[:-5] + "bn2"


def reference_steps(cfg, init, data, host_batches, trainer_seed, device, q) -> dict:
    """The reference's three steps from the same parameters, batches and
    draws: each step's loss, step 1's clipped gradient and the parameters
    after step 3."""
    images, points, counts = data
    params = {k: v.detach().clone() for k, v in init.items()}
    ts = TrainStep(cfg, params, q)
    losses, grad = [], None
    for j, idx in enumerate(host_batches):
        x = torch.from_numpy(images[idx]).to(device)
        pts = torch.from_numpy(points[idx]).to(device)
        valid = torch.arange(pts.shape[1], device=device)[None] < torch.from_numpy(
            counts[idx]).to(device)[:, None]
        losses.append(ts.step(x, pts, valid, step_generator(device, trainer_seed, 0, j)))
        if j == 0:
            grad = {k: v.clone() for k, v in ts.grads.items()}
    return {"loss": losses, "grad": grad,
            "params": {k: v.detach().clone() for k, v in params.items()}}
