"""Joint SuperPoint training: `Trainer.train_steps` of the port's
``superpoint`` phase on a `DeviceBatchLoader`, k steps a call (on the card,
replays of the captured step).

Set-up builds one trainer, draws its parameters on the device from the
seed (the same tensors go to the reference), and drives its first three
steps through the window's own call: one call of step 1, read back for the
optimizer's first moment, then one call of steps 2-3, read back for the
parameters.  The window then calls ``train_steps`` with ``k`` batches a
call, at most two calls in flight, step ``i`` drawing from ``(seed, 0,
i)``.  The split is seeded polygon scenes with their corners, held in
memory and uploaded once; epochs repeat over it.
"""

from __future__ import annotations

import gc
import tempfile
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import torch

from port_bench.harness import scenes
from port_bench.harness.core import log


def log_numbers(numbers: dict) -> None:
    """Every number the comparison gives, the compared ones among them."""
    log("[train check] " + " ".join(f"{k}={v!r}" for k, v in numbers.items()))


def port_name(snapshot: str) -> str:
    """A parameter's snapshot-style name (the reference's) as the port's
    ``state_dict`` names it."""
    parts = []
    for part in snapshot.split("/"):
        if part.startswith("block"):
            parts.append(part[5:])
        elif part == "identity_conv":
            parts.append("identity_downsample.0")
        elif part == "identity_bn":
            parts.append("identity_downsample.1")
        else:
            parts.append(part)
    name = ".".join(parts)
    for old, new in ((".kernel", ".weight"), (".scale", ".weight")):
        if name.endswith(old):
            return name[: -len(old)] + new
    return name


class Driver:
    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, device):
        self.cfg, self.tr, self.limits = config, traffic, limits
        self.seed, self.device = seed, device
        # the trainer's seed: its step seeds (seed * 1e6 + epoch) * 1e6 +
        # index stay within 64 bits
        self.trainer_seed = seed % (1 << 20)

    def setup(self) -> None:
        from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
        from feature_point_cnn_tpu_torch.data.device_store import DeviceBatchLoader
        from feature_point_cnn_tpu_torch.train.trainer import Trainer

        from port_bench.reference.train import resnet_params

        c, t, opt = self.cfg, self.tr, self.cfg["optimizer"]
        h, w, b = t["height"], t["width"], t["batch"]
        t0 = time.time()
        images, points, counts = scenes.scene_split(self.seed, t["scenes"], h, w,
                                                    c["max_points"])
        self.data = (images, points, counts)
        ds = SimpleNamespace(index=np.arange(len(images)), images=images,
                             points=points, counts=counts)
        sp = SuperPointConfig(
            cell=c["cell"], image_channels=c["image_channels"],
            descriptor_dim=c["descriptor_dim"], compute_dtype=c["compute_dtype"],
            lambda_d=c["lambda_d"], positive_margin=c["positive_margin"],
            negative_margin=c["negative_margin"], train_image_size=(h, w),
            batch_size=b, train_steps_per_call=t["steps_per_call"],
            learning_rate=opt["learning_rate"], lr_schedule="constant",
            adam_beta1=opt["beta1"], adam_beta2=opt["beta2"], adam_eps=opt["eps"],
            weight_decay=opt["weight_decay"], grad_clip_norm=opt["clip_norm"],
            max_points=c["max_points"])
        t1 = time.time()
        self.tmp = tempfile.TemporaryDirectory(prefix="port_bench_train_")
        loader = DeviceBatchLoader(ds, b, c["max_points"], device=self.device,
                                   seed=self.seed % (1 << 31), shuffle=True)
        self.trainer = Trainer(sp, "superpoint", loader, None, self.tmp.name,
                               homo_config=HomographyConfig(**c["homography"]),
                               seed=self.trainer_seed, device=self.device,
                               write_statistics=False, log_every=1 << 30)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.init = resnet_params(c, self.device, gen)
        model = self.trainer.state.model
        missing, unexpected = model.load_state_dict(
            {port_name(k): v for k, v in self.init.items()}, strict=False)
        if unexpected or any(not k.endswith(("running_mean", "running_var",
                                             "num_batches_tracked")) for k in missing):
            raise RuntimeError(f"parameter names: missing {missing}, unexpected {unexpected}")
        self.batches = [i for e in range(t["epochs_in_rotation"])
                        for i in loader.epoch_index_arrays(e)]
        self.host_batches = [i.cpu().numpy() for i in self.batches[:3]]

        t2 = time.time()
        # steps 1-3 through the window's call (the first captures the step)
        opt_state = self.trainer.state.optimizer
        first = self.trainer.train_steps(self.batches[:1], 0, 0)
        b1 = opt["beta1"]
        self.prog_grad = {n: (m / (1.0 - b1)).detach().clone()
                          for n, m in zip(opt_state.names, opt_state.mu)}
        rest = self.trainer.train_steps(self.batches[1:3], 0, 1)
        self.prog_params = {n: p.detach().clone() for n, p in
                            model.named_parameters()}
        self.prog_loss = [float(first["loss"][0]), *map(float, rest["loss"])]
        self.step = 3
        self._sync()
        self.parts.update(inputs=t1 - t0, program=t2 - t1, warmup=time.time() - t2)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        k, on_card = self.tr["steps_per_call"], self.device.type == "cuda"
        queued = deque()
        calls, n = 0, len(self.batches)
        self._sync()
        t0 = time.perf_counter()
        while True:
            if len(queued) >= 2 and on_card:
                queued.popleft().synchronize()
            idxs = [self.batches[(self.step + j) % n] for j in range(k)]
            self.trainer.train_steps(idxs, 0, self.step)
            self.step += k
            if on_card:
                ev = torch.cuda.Event()
                ev.record()
                queued.append(ev)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        window_s = time.perf_counter() - t0
        steps = calls * k
        images = steps * self.tr["batch"]
        return {"attempted": steps, "steps": steps, "calls": calls, "window_s": window_s,
                "e2e": {"train_images_per_s": images / window_s}}

    def check(self) -> dict:
        from port_bench.reference import compare
        from port_bench.reference.precision import QUANT, float32_mode
        from port_bench.reference.train import reference_steps

        del self.trainer
        gc.collect()
        self.tmp.cleanup()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        float32_mode()
        ref = reference_steps(self.cfg, self.init, self.data, self.host_batches,
                              self.trainer_seed, self.device, QUANT["float32"])
        names = {port_name(k): k for k in self.init}
        prog = {"loss": self.prog_loss,
                "grad": {names[n]: g for n, g in self.prog_grad.items()},
                "params": {names[n]: p for n, p in self.prog_params.items()}}
        numbers = compare.train(prog, ref, self.init)
        log_numbers(numbers)
        out = {k: (numbers[k], lim) for k, lim in self.limits.items()}
        out["failed"] = sum(v > lim for v, lim in out.values())
        return out
