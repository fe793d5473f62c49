"""The serving frame with the SuperGlue matcher: `SuperPointFrontend.frame`
of the port on magicleap's VGG SuperPoint, each frame matched against one
keyframe by SuperGlue, in a closed loop of one client.

Each call hands a batch of u8 gray frames to ``frame`` as a host tensor,
with the keyframe fed back from the call before (its frame 0's keypoints
and scores, f16 descriptors and count; the chain runs on from the warm-up,
so every call of a window has one), and copies all five outputs to host
memory before the next call.  The frames are a pool of seeded scenes
seen through a few horizontal shifts, as in the ResNet frame cells.  The
window's dict also holds the pairs SuperGlue matched in it (the
``superglue.pairs`` counter's gain), which ``mfu.match`` reads.

Weights are drawn on the device from the seed, in one call each for the
VGG SuperPoint (`forward.seeded_weights`) and SuperGlue
(`seeded_superglue`), and handed to the program and the reference alike.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from port_bench.drivers.forward import seeded_weights
from port_bench.harness import scenes
from port_bench.harness.reservoir import Reservoir


def superglue_config(cfg: dict):
    """The port's `SuperGlueConfig` of a configuration's ``superglue``
    section."""
    from feature_point_cnn_tpu_torch.config import SuperGlueConfig

    s = cfg["superglue"]
    return SuperGlueConfig(
        descriptor_dim=s["descriptor_dim"], keypoint_encoder=tuple(s["keypoint_encoder"]),
        gnn_layers=tuple(s["GNN_layers"]), num_heads=s["num_heads"],
        sinkhorn_iterations=s["sinkhorn_iterations"], match_threshold=s["match_threshold"],
        bn_eps=s["bn_eps"], compute_dtype=s["compute_dtype"])


def seeded_superglue(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """SuperGlue's state dict under the published names, drawn in one call
    on ``device`` from ``seed``: LeCun-normal 1x1 kernels, normal biases of
    ``init.bias_std``; BatchNorm scales ``1 + N(0, bn_scale_std)``, biases
    and running means normal, running variances log-normal (positive);
    ``bin_score`` as published (1).  The gains of ``init`` scale the query
    and key projections (``qk_gain``), the value projection and the merge
    (``value_gain``), each GNN MLP's last layer and its bias
    (``branch_gain``) and ``final_proj`` (``final_gain``): the
    configuration file says why."""
    from feature_point_cnn_tpu_torch.models.superglue import SuperGlue

    init = cfg["superglue"]["init"]
    shapes = {k: v.shape for k, v in SuperGlue(superglue_config(cfg)).state_dict().items()}
    sizes = {k: int(np.prod(s)) for k, s in shapes.items()
             if not k.endswith("num_batches_tracked") and k != "bin_score"}
    state = np.random.SeedSequence([seed, 17]).generate_state(1)[0]
    gen = torch.Generator(device=device).manual_seed(int(state))
    flat = torch.randn(sum(sizes.values()), generator=gen, device=device)
    out, at = {}, 0
    bn = {k.rsplit(".", 1)[0] for k in shapes if k.endswith("running_var")}
    for k, n in sizes.items():
        z = flat[at:at + n].view(shapes[k])
        at += n
        layer, part = k.rsplit(".", 1)
        if layer in bn:
            out[k] = {"weight": 1 + init["bn_scale_std"] * z, "bias": init["bn_std"] * z,
                      "running_mean": init["bn_std"] * z,
                      "running_var": torch.exp(init["bn_log_var_std"] * z)}[part]
        elif part == "weight":
            out[k] = z * shapes[k][1] ** -0.5
        else:
            out[k] = z * init["bias_std"]
        out[k] = out[k] * _gain(k, init)
    out["bin_score"] = torch.tensor(init["bin_score"], device=device)
    for k in shapes:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long, device=device)
    return out


def detector_weights(cfg: dict, seed: int, device) -> dict:
    """The VGG SuperPoint's ``{name: (weight, bias)}``: `seeded_weights`'
    draw, each kernel less its mean and the biases zero where
    ``init.zero_mean`` says so."""
    out = seeded_weights(cfg, seed, device)
    if cfg["init"].get("zero_mean"):
        out = {k: (w - w.mean((1, 2, 3), keepdim=True), torch.zeros_like(b))
               for k, (w, b) in out.items()}
    return out


def _gain(name: str, init: dict) -> float:
    if name.endswith((".attn.proj.0.weight", ".attn.proj.1.weight")):
        return init["qk_gain"]
    if name.endswith((".attn.proj.2.weight", ".attn.merge.weight")):
        return init["value_gain"]
    if ".mlp.3." in name:
        return init["branch_gain"]
    if name == "final_proj.weight":
        return init["final_gain"]
    return 1.0


class Driver:
    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, device):
        self.cfg, self.tr, self.limits = config, traffic, limits
        self.seed, self.device = seed, device

    def setup(self) -> None:
        from feature_point_cnn_tpu_torch.config import SuperPointConfig
        from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend

        c, t = self.cfg, self.tr
        t0 = time.time()
        sp = SuperPointConfig(
            backbone="vgg", matcher="superglue", superglue=superglue_config(c),
            cell=c["cell"], nms_dist=c["nms_dist"], confidence_thresh=c["confidence_thresh"],
            border_remove=c["border_remove"], max_keypoints=c["max_keypoints"],
            image_channels=c["image_channels"], descriptor_dim=c["descriptor_dim"],
            compute_dtype=c["compute_dtype"])
        self.n = min(c["top_n"], c["max_keypoints"])
        self.weights = detector_weights(c, self.seed, self.device)
        self.sg_weights = seeded_superglue(c, self.seed, self.device)
        self.fe = SuperPointFrontend(sp, device=self.device)
        self.fe.model.load_state_dict({f"{k}.{part}": v for k, (w, b) in self.weights.items()
                                       for part, v in (("weight", w), ("bias", b))})
        self.fe.matcher.load_state_dict(self.sg_weights)
        t1 = time.time()
        self.frames = scenes.shifted_frames(self.seed, t["scenes"], t["shifts"],
                                            t["height"], t["width"])
        self.batches = scenes.batches(self.seed, len(self.frames), t["batch"],
                                      t["batches_in_rotation"])
        self.host = [torch.from_numpy(np.ascontiguousarray(self.frames[b]))
                     for b in self.batches]
        t2 = time.time()
        # the keyframe chain runs on from the warm-up through every window,
        # so each call of a window has a keyframe
        self.key, self.prev = self._empty_key(), None
        for i in range(t["warmup_calls"]):
            self.prev, self.key = self._call(self.host[i % len(self.host)], self.key)
        self._sync()
        self.parts.update(program=t1 - t0, inputs=t2 - t1, warmup=time.time() - t2)

    def _empty_key(self):
        d = self.cfg["descriptor_dim"]
        return (torch.zeros((self.n, d), dtype=torch.float16, device=self.device),
                torch.zeros((), dtype=torch.int32, device=self.device),
                torch.zeros((self.n, 3), dtype=torch.float32, device=self.device))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _call(self, x, key):
        """One frame call: the five outputs in host memory, and the next
        keyframe (frame 0's descriptors, count and keypoints)."""
        out = self.fe.frame(x, key[0], key[1], top_n=self.n, key_kp=key[2])
        host = [o.cpu() for o in out]
        return host, (out[3][0], out[0][0], out[1][0])

    def window(self, seconds: float) -> dict:
        from feature_point_cnn_tpu_torch.utils import profiling

        rng = np.random.default_rng([self.seed, 2])
        self.sample = Reservoir(self.tr["checked_calls"], rng)
        key, prev = self.key, self.prev       # prev: the call before's host outputs
        calls, rotation = 0, len(self.host)
        pairs0 = profiling.counters()["superglue.pairs"]
        self._sync()
        t0 = time.perf_counter()
        while True:
            r = calls % rotation
            host, key = self._call(self.host[r], key)
            self.sample.offer(lambda: (r, host, prev))
            prev = host
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        window_s = time.perf_counter() - t0
        self.key, self.prev = key, prev
        frames = calls * self.tr["batch"]
        return {"attempted": frames, "frames": frames, "calls": calls, "window_s": window_s,
                "pairs": profiling.counters()["superglue.pairs"] - pairs0,
                "e2e": {"frames_per_s": frames / window_s}}

    def check(self) -> dict:
        """The sampled calls against the plain reference, once the program
        is freed: detect and describe from the u8 frames, the matcher on
        the program's own keypoints and descriptors."""
        from port_bench.reference import compare
        from port_bench.reference import superglue_frame as ref
        from port_bench.reference.precision import QUANT, float32_mode

        del self.fe
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        float32_mode()
        c, t = self.cfg, self.tr
        sg_cfg = {**c["superglue"], "descriptor_dim": c["descriptor_dim"]}
        size = (t["height"], t["width"])
        per_frame = per_pair = None
        for r, host, prev in self.sample.sample():
            num, kp, index, desc, score = (o.numpy() for o in host)
            want = ref.extract(c, self.weights, self.frames[self.batches[r]], self.device,
                               QUANT["float32"])
            part = ref.detect_frames({"num_valid": num, "kp": kp, "desc": desc}, want,
                                     t["width"])
            per_frame = part if per_frame is None else {k: per_frame[k] + part[k] for k in part}
            key = {"num": 0, "kp": kp[0, :0], "desc": desc[0, :0]} if prev is None else {
                "num": prev[0][0].item(), "kp": prev[1][0].numpy(), "desc": prev[3][0].numpy()}
            pairs = ref.match_pairs(self.sg_weights, sg_cfg,
                                    {"num_valid": num, "kp": kp, "desc": desc}, key, size,
                                    self.device)
            part = ref.matcher_pairs(index, score, num, pairs)
            per_pair = part if per_pair is None else {k: per_pair[k] + part[k] for k in part}
        numbers = {**ref.detect_numbers(per_frame), **ref.matcher_numbers(per_pair)}
        out = {k: (v, self.limits[k]) for k, v in numbers.items()}
        # frames over a detect limit, and pairs over the assignment's
        out["failed"] = compare.frames_failed(per_frame, self.limits) + sum(
            e is not None and e > self.limits["assign_err"] for e in per_pair["assign_err"])
        return out
