"""The model forward alone: the port's `prep_images` and a model's
``forward`` on batches of u8 frames resident on the card, outputs left on
the card.  The configuration names the port's model class (``model``) and
the plain reference forward it is checked against (``reference``), each
as ``module.name``; the model's parameters are its family's convolutions
(`counts.convs.family_convs`), ``<conv>.weight`` and ``<conv>.bias``.

The loop keeps ``in_flight`` calls queued: before it queues a call it waits
for the call that many before, so the device always has the next batch and
the host never runs far ahead.  The window ends in a synchronise; a frame
counts once its call has finished.  Weights are drawn on the device from
the seed, in one call, and handed to the program and to the reference
alike.
"""

from __future__ import annotations

import gc
import importlib
import time
from collections import deque

import numpy as np
import torch

from port_bench.harness import scenes
from port_bench.harness.reservoir import Reservoir
from port_bench.counts.convs import family_convs


def seeded_weights(cfg: dict, seed: int, device) -> dict:
    """``{name: (weight OIHW float32, bias)}`` for every convolution of
    the configuration, drawn in one call on ``device``: LeCun-normal
    kernels and normal biases of ``init.bias_std``."""
    convs = family_convs(cfg, 8, 8)
    shapes = [((c.cout, c.cin, c.k, c.k), (c.cout,)) for c in convs]
    total = sum(np.prod(w) + b[0] for w, b in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(int(total), generator=gen, device=device)
    out, at = {}, 0
    for c, (ws, bs) in zip(convs, shapes):
        nw = int(np.prod(ws))
        w = flat[at:at + nw].view(ws) * (c.cin * c.k * c.k) ** -0.5
        b = flat[at + nw:at + nw + bs[0]] * cfg["init"]["bias_std"]
        out[c.name] = (w, b)
        at += nw + bs[0]
    return out


def named(path: str):
    """The object ``module.name`` that a configuration names."""
    module, name = path.rsplit(".", 1)
    return getattr(importlib.import_module(module), name)


class Driver:
    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, device):
        self.cfg, self.tr, self.limits = config, traffic, limits
        self.seed, self.device = seed, device

    def setup(self) -> None:
        from feature_point_cnn_tpu_torch.config import SuperPointConfig
        from feature_point_cnn_tpu_torch.inference.wrapper import prep_images

        c, t = self.cfg, self.tr
        t0 = time.time()
        self.weights = seeded_weights(c, self.seed, self.device)
        sp = SuperPointConfig(cell=c["cell"], image_channels=c["image_channels"],
                              descriptor_dim=c["descriptor_dim"],
                              compute_dtype=c["compute_dtype"])
        model = named(c["model"])(sp, generator=torch.Generator().manual_seed(0))
        model.load_state_dict({f"{k}.{part}": v for k, (w, b) in self.weights.items()
                               for part, v in (("weight", w), ("bias", b))})
        self.model = model.to(self.device).eval()
        self.prep = prep_images
        t1 = time.time()
        self.frames_host = scenes.shifted_frames(self.seed, t["scenes"], t["shifts"],
                                                 t["height"], t["width"])
        self.batches = scenes.batches(self.seed, len(self.frames_host), t["batch"],
                                      t["batches_in_rotation"])
        self.inputs = [torch.from_numpy(np.ascontiguousarray(self.frames_host[b])
                                        ).to(self.device) for b in self.batches]
        t2 = time.time()
        for i in range(t["warmup_calls"]):
            self._call(self.inputs[i % len(self.inputs)])
        self._sync()
        self.parts.update(program=t1 - t0, inputs=t2 - t1, warmup=time.time() - t2)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def _call(self, x):
        return self.model(self.prep(x, self.cfg["image_channels"]))

    def window(self, seconds: float) -> dict:
        rng = np.random.default_rng([self.seed, 2])
        self.sample = Reservoir(self.tr["checked_calls"], rng)
        on_card = self.device.type == "cuda"
        queued = deque()
        calls, rotation = 0, len(self.inputs)
        self._sync()
        t0 = time.perf_counter()
        while True:
            if len(queued) >= self.tr["in_flight"] and on_card:
                queued.popleft().synchronize()
            r = calls % rotation
            out = self._call(self.inputs[r])
            self.sample.offer(lambda: (r, out))
            if on_card:
                ev = torch.cuda.Event()
                ev.record()
                queued.append(ev)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        window_s = time.perf_counter() - t0
        frames = calls * self.tr["batch"]
        return {"attempted": frames, "frames": frames, "calls": calls,
                "window_s": window_s, "e2e": {"forward_frames_per_s": frames / window_s}}

    def check(self) -> dict:
        from port_bench.reference import compare
        from port_bench.reference.precision import QUANT, float32_mode

        kept = [(r, [o.float().cpu().numpy() for o in out])
                for r, out in self.sample.sample()]
        del self.model, self.inputs, self.sample
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        float32_mode()
        worst, maps = {}, named(self.cfg["reference"])
        for r, (prob, desc, logits) in kept:
            want = maps(self.cfg, self.weights, self.frames_host[self.batches[r]],
                        self.device, QUANT["float32"])
            got = compare.maps({"prob": prob, "desc": desc, "logits": logits}, want)
            worst = {k: max(v, worst.get(k, 0.0)) for k, v in got.items()}
        out = {k: (v, self.limits[k]) for k, v in worst.items()}
        out["failed"] = 0 if all(v <= lim for v, lim in out.values()) else len(kept)
        return out
