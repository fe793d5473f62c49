"""The serving frame: `SuperPointFrontend.frame` of the port, the packed
frame program, in a closed loop of one client.

Each call hands a batch of u8 gray frames to ``frame`` as a host tensor,
with the keyframe fed back from the call before (its frame 0's
descriptors and count), and copies all four outputs to host memory before
the next call.  A frame's latency is its call's, from the hand-over to its
outputs in host memory.  The frames are a pool of seeded scenes, each seen
through a few horizontal shifts, so frames of a batch match the keyframe
where they share its scene.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path

import numpy as np
import torch

from port_bench.harness import scenes
from port_bench.harness.reservoir import Reservoir

ROOT = Path(__file__).resolve().parents[2]


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
            cell=c["cell"], nms_dist=c["nms_dist"], confidence_thresh=c["confidence_thresh"],
            nn_thresh=c["nn_thresh"], border_remove=c["border_remove"],
            max_keypoints=c["max_keypoints"], image_channels=c["image_channels"],
            descriptor_dim=c["descriptor_dim"], compute_dtype=c["compute_dtype"])
        self.n = min(c["top_n"], c["max_keypoints"])
        self.fe = SuperPointFrontend(sp, weights_path=str(ROOT / c["weights"]),
                                     device=self.device)
        t1 = time.time()
        self.frames = scenes.shifted_frames(self.seed, t["scenes"], t["shifts"],
                                            t["height"], t["width"])
        self.batches = scenes.batches(self.seed, len(self.frames), t["batch"],
                                      t["batches_in_rotation"])
        self.host = [torch.from_numpy(np.ascontiguousarray(self.frames[b]))
                     for b in self.batches]
        t2 = time.time()
        for i in range(t["warmup_calls"]):
            self._call(self.host[i % len(self.host)], *self._empty_key())
        self._sync()
        self.parts.update(program=t1 - t0, inputs=t2 - t1, warmup=time.time() - t2)

    def _empty_key(self):
        d = self.cfg["descriptor_dim"]
        return (torch.zeros((self.n, d), dtype=torch.float16, device=self.device),
                torch.zeros((), dtype=torch.int32, device=self.device))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _call(self, x, key_desc, key_num):
        """One frame call: outputs in host memory, and the next keyframe."""
        out = self.fe.frame(x, key_desc, key_num, top_n=self.n)
        host = [o.cpu() for o in out]
        return host, (out[3][0], out[0][0])

    def window(self, seconds: float) -> dict:
        rng = np.random.default_rng([self.seed, 2])
        self.sample = Reservoir(self.tr["checked_calls"], rng)
        key = self._empty_key()
        prev = None           # the call before: (its frame 0's pool index, kp rows)
        lat = []
        calls, rotation = 0, len(self.host)
        self._sync()
        t0 = time.perf_counter()
        while True:
            r = calls % rotation
            s = time.perf_counter()
            host, key = self._call(self.host[r], *key)
            e = time.perf_counter()
            lat.append(e - s)
            self.sample.offer(lambda: (r, host, prev))
            n0 = int(host[0][0])
            prev = (int(self.batches[r][0]), host[1][0, :n0, :2].numpy())
            calls += 1
            if e - t0 >= seconds:
                break
        self._sync()
        window_s = time.perf_counter() - t0
        frames = calls * self.tr["batch"]
        return {"attempted": frames, "frames": frames, "calls": calls,
                "window_s": window_s,
                "e2e": {"frames_per_s": frames / window_s,
                        "frame_ms_p95": float(np.percentile(lat, 95)) * 1e3}}

    def check(self) -> dict:
        """The sampled calls against the plain reference, once the program
        is freed."""
        from port_bench.reference import compare
        from port_bench.reference.frame import ResNetFrame, serve
        from port_bench.reference.models import load_resnet_npz
        from port_bench.reference.precision import float32_mode

        del self.fe
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        float32_mode()
        ref = ResNetFrame(self.cfg, load_resnet_npz(str(ROOT / self.cfg["weights"]),
                                                    self.device), self.device)
        per_frame = None
        for r, host, prev in self.sample.sample():
            prog = {"num_valid": host[0].numpy(), "kp": host[1].numpy(),
                    "match": host[2].numpy().astype(np.int64),
                    "desc": host[3].numpy()}
            b = len(prog["num_valid"])
            key_img = None if prev is None else self.frames[prev[0]]
            prog["key_kp"] = [None if prev is None else prev[1]] * b
            want = serve(ref, self.frames[self.batches[r]], [key_img] * b)
            part = compare.frames(prog, want, self.tr["width"])
            per_frame = part if per_frame is None else {
                k: per_frame[k] + part[k] for k in part}
        numbers = compare.frame_numbers(per_frame)
        out = {k: (v, self.limits[k]) for k, v in numbers.items()}
        out["failed"] = compare.frames_failed(per_frame, self.limits)
        return out
