"""Data-parallel joint SuperPoint training over the cards of one host:
`Trainer.train_steps` of the port's ``superpoint`` phase on a data mesh of
``ranks`` processes, one card each, NCCL between them, k steps a call (on
the card, replays of the captured step with its gradient all-reduce
inside the graph).

This process is rank 0 and reports; set-up starts the other ranks as
processes of this file (``python port_bench/drivers/train_dp4.py <job
JSON>``), which follow rank 0's calls: before each call rank 0 broadcasts
the steps it takes (0 ends nothing, -1 ends the job), so every rank runs
the same steps.  The global batch is ``ranks x batch`` images, each rank
gathering its rows from its own copy of the split (`DeviceBatchLoader`,
replicated); BatchNorm's statistics, the loss's divisors and the gradient
are the global batch's (`train/steps.py`, `models/blocks.py`).  A step's
images count once, globally, in ``train_images_per_s``.

Set-up draws the parameters from the seed on every rank and drives steps
1-3 as `train_steps.Driver` does; the check repeats them with the plain
reference (`reference/train.py`) at the global batch, and logs the largest
gap between any rank's parameters and rank 0's after them.
"""

from __future__ import annotations

import gc
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from port_bench.drivers.train_steps import log_numbers, port_name  # noqa: E402
from port_bench.harness import scenes  # noqa: E402
from port_bench.harness.core import log  # noqa: E402

# a rank that waits this long on a collective gives up
TIMEOUT_S = 300
# the other ranks' processes end this soon after the job does
EXIT_S = 60


class Rank:
    """One rank's trainer on its card, with steps 1-3 taken."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device):
        self.cfg, self.tr, self.seed, self.device = cfg, tr, seed, device
        self.trainer_seed = seed % (1 << 20)

    def setup(self) -> dict:
        from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
        from feature_point_cnn_tpu_torch.data.device_store import DeviceBatchLoader
        from feature_point_cnn_tpu_torch.train.trainer import Trainer

        from port_bench.reference.train import resnet_params

        c, t, opt = self.cfg, self.tr, self.cfg["optimizer"]
        h, w = t["height"], t["width"]
        b = t["batch"] * t["ranks"]
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
        self.tmp = tempfile.TemporaryDirectory(prefix="port_bench_dp_")
        self.loader = DeviceBatchLoader(ds, b, c["max_points"], device=self.device,
                                        seed=self.seed % (1 << 31), shuffle=True)
        if self.loader.mesh.size != t["ranks"]:
            raise RuntimeError(f"a mesh of {self.loader.mesh.size} ranks, not {t['ranks']}")
        self.trainer = Trainer(sp, "superpoint", self.loader, None, self.tmp.name,
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
                        for i in self.loader.epoch_index_arrays(e)]
        t2 = time.time()
        # steps 1-3 through the window's call (the first captures the step)
        opt_state = self.trainer.state.optimizer
        first = self.trainer.train_steps(self.batches[:1], 0, 0)
        b1 = opt["beta1"]
        self.prog_grad = {n: (m / (1.0 - b1)).detach().clone()
                          for n, m in zip(opt_state.names, opt_state.mu)}
        rest = self.trainer.train_steps(self.batches[1:3], 0, 1)
        self.prog_params = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.prog_loss = [float(first["loss"][0]), *map(float, rest["loss"])]
        self.step = 3
        self.sync()
        return {"inputs": t1 - t0, "program": t2 - t1, "warmup": time.time() - t2}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, k: int) -> None:
        n = len(self.batches)
        idxs = [self.batches[(self.step + j) % n] for j in range(k)]
        self.trainer.train_steps(idxs, 0, self.step)
        self.step += k

    def param_gap(self) -> float:
        """The largest gap between this rank's parameters after steps 1-3
        and rank 0's, on rank 0 (a max over the ranks)."""
        import torch.distributed as dist

        flat = torch.cat([p.reshape(-1).float() for p in self.prog_params.values()])
        zero = flat.clone()
        dist.broadcast(zero, 0)
        gap = (flat - zero).abs().max().reshape(1)
        dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        return float(gap)

    def close(self) -> None:
        """Free the trainer and its graphs (before the job's teardown)."""
        self.sync()
        del self.trainer, self.loader
        gc.collect()
        self.tmp.cleanup()


def _command(value: int, device) -> int:
    """Rank 0's ``value`` on every rank."""
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.broadcast(t, 0)
    return int(t.item())


def _init(job: dict, rank: int, device) -> None:
    import datetime

    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{job['port']}",
                            world_size=job["traffic"]["ranks"], rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _device(kind: str, rank: int):
    return torch.device(f"cuda:{rank}") if kind == "cuda" else torch.device("cpu")


def follow(job: dict) -> None:
    """A rank other than 0: set up, then take the steps rank 0 broadcasts
    until it says -1."""
    import torch.distributed as dist

    device = _device(job["device"], job["rank"])
    _init(job, job["rank"], device)
    member = Rank(job["config"], job["traffic"], job["seed"], device)
    member.setup()
    member.param_gap()
    while True:
        k = _command(0, device)
        if k < 0:
            break
        if k:
            member.call(k)
        else:
            member.sync()
    member.close()
    dist.destroy_process_group()


class Driver:
    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, device):
        self.cfg, self.tr, self.limits = config, traffic, limits
        self.seed, self.device = seed, device
        self.workers = []

    def setup(self) -> None:
        ranks = self.tr["ranks"]
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        job = {"config": self.cfg, "traffic": self.tr, "seed": self.seed,
               "device": self.device.type, "port": port}
        here = Path(__file__).resolve()
        for r in range(1, ranks):
            self.workers.append(subprocess.Popen(
                [sys.executable, str(here), json.dumps({**job, "rank": r})], cwd=str(ROOT)))
        self.rank = Rank(self.cfg, self.tr, self.seed, _device(self.device.type, 0))
        _init(job, 0, self.rank.device)
        self.parts.update(self.rank.setup())
        self.param_gap = self.rank.param_gap()

    def window(self, seconds: float) -> dict:
        k, on_card = self.tr["steps_per_call"], self.device.type == "cuda"
        dev = self.rank.device
        queued = deque()
        calls = 0
        self.rank.sync()
        t0 = time.perf_counter()
        while True:
            if len(queued) >= 2 and on_card:
                queued.popleft().synchronize()
            _command(k, dev)
            self.rank.call(k)
            if on_card:
                ev = torch.cuda.Event()
                ev.record()
                queued.append(ev)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _command(0, dev)
        self.rank.sync()
        window_s = time.perf_counter() - t0
        steps = calls * k
        images = steps * self.tr["batch"] * self.tr["ranks"]
        return {"attempted": steps, "steps": steps, "calls": calls, "window_s": window_s,
                "e2e": {"train_images_per_s": images / window_s}}

    def _end_job(self) -> None:
        """Every rank leaves the job together (NCCL's teardown waits for
        the others), then the other ranks' processes end."""
        import torch.distributed as dist

        _command(-1, self.rank.device)
        self.rank.close()
        dist.destroy_process_group()
        workers, self.workers = self.workers, []
        try:
            codes = [p.wait(timeout=EXIT_S) for p in workers]
        except subprocess.TimeoutExpired:
            for p in workers:
                p.kill()
            raise
        if any(codes):
            raise RuntimeError(f"the other ranks ended with exit codes {codes}")

    def check(self) -> dict:
        from port_bench.reference import compare
        from port_bench.reference.precision import QUANT, float32_mode
        from port_bench.reference.train import reference_steps

        r = self.rank
        b = self.tr["batch"] * self.tr["ranks"]
        n = len(r.loader)
        # the global batches of steps 1-3: every rank's rows, epochs in turn
        host_batches = list(np.concatenate([r.loader._epoch_order(e)[:n * b].reshape(n, b)
                                            for e in range(3)])[:3])
        prog = {"loss": r.prog_loss, "grad": r.prog_grad, "params": r.prog_params}
        init, data, seed = r.init, r.data, r.trainer_seed
        self._end_job()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        float32_mode()
        ref = reference_steps(self.cfg, init, data, host_batches, seed, self.device,
                              QUANT["float32"])
        names = {port_name(k): k for k in init}
        prog = {"loss": prog["loss"],
                "grad": {names[k]: g for k, g in prog["grad"].items()},
                "params": {names[k]: p for k, p in prog["params"].items()}}
        numbers = compare.train(prog, ref, init)
        numbers["rank_param_gap"] = self.param_gap
        log_numbers(numbers)
        out = {k: (numbers[k], lim) for k, lim in self.limits.items()}
        out["failed"] = sum(v > lim for v, lim in out.values())
        return out

    def __del__(self):
        for p in self.workers:
            p.kill()


if __name__ == "__main__":
    follow(json.loads(sys.argv[1]))
