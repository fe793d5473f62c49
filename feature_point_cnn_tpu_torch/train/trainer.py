"""Training loop: epochs, checkpoint/resume, metrics and summaries
(`feature_point_cnn_tpu/train/trainer.py`).

One device a rank.  Without a process group that is one process; under
one (``torchrun``, `parallel/distributed.py`) the trainer runs on a data
mesh of the ranks (`parallel/mesh.py::make_mesh` for the loader's batch
size, at most ``n_devices`` ranks): each rank takes its rows of every
global batch, the steps reduce over the mesh (`train/steps.py`), the state
is broadcast from rank 0 at start and after a resume, and rank 0 alone
writes checkpoints, ``metrics.jsonl``, summaries and the snapshot while
the others wait at a barrier.  A rank outside the mesh says so and trains
nothing.

With a `DeviceBatchLoader` the batch gather runs inside the step, from a
``(B,)`` index on the device, as the JAX package's fused step does, and
``config.train_steps_per_call = k`` runs k optimizer steps a host call with
their metrics stacked ``(k, ...)`` (`_train_epoch_scanned`,
`trainer.py:306-390`).  On the card those k steps are replays of a CUDA
graph of ONE whole step (gather, labels, augmentation, forward, loss with
the descriptor-loss kernels, backward, update), each replay after the
step's generator is reseeded with ``(seed, epoch, index)``: a graph of k
steps would replay one seed with running Philox offsets, while one graph a
step draws exactly what an eager step of the same index draws.  On the CPU
the same call runs the k steps eagerly.  A failed capture raises; nothing
falls back to eager steps.  A tail of fewer than k steps runs single eager
steps, as in JAX.  On a mesh the graph holds the step's collectives, which
NCCL can be captured with and gloo cannot: k > 1 under gloo with more than
one rank raises.

Summaries (`utils/summary.py`): train and test scalars, a model table, BN-
free parameter histograms and a keypoint-overlay image through the serving
extract (the decode and NMS kernels on the card); a summary that fails
never stops training.  ``FPC_PROFILE_DIR`` traces steps 5-15 of epoch 0.
The tracer's spans (`utils/profiling.py`): ``train.call`` a `train_steps`
call, ``train.capture`` the graph's capture in it, ``train.step`` an eager
step of an epoch; the counter ``train.steps`` counts the optimizer steps.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
from feature_point_cnn_tpu_torch.data.device_store import DeviceBatchLoader
from feature_point_cnn_tpu_torch.device import resolve_device
from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
from feature_point_cnn_tpu_torch.parallel import collectives
from feature_point_cnn_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate_state,
    shard_batch,
)
from feature_point_cnn_tpu_torch.train import steps as S
from feature_point_cnn_tpu_torch.train.optimizer import make_optimizer
from feature_point_cnn_tpu_torch.utils import checkpoint as ckpt
from feature_point_cnn_tpu_torch.utils import profiling
from feature_point_cnn_tpu_torch.utils.summary import MetricWriter
from feature_point_cnn_tpu_torch.utils.weights import load_variables, save_weights

Metrics = Dict[str, torch.Tensor]


def _on_mesh(method):
    """Run a `Trainer` method with the trainer's mesh as the data group
    (`parallel/collectives.py::data_group`), so its steps reduce over that
    mesh whatever other meshes exist."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with collectives.data_group(self.mesh.group):
            return method(self, *args, **kwargs)
    return run


class Trainer:
    """Phase-agnostic trainer; ``phase`` is ``"magicpoint"`` or
    ``"superpoint"``.  ``train_loader``: a `BatchLoader` (host batches) or
    a `DeviceBatchLoader` (the gather fused into the step).  ``device=None``
    means ``cuda``; ``n_devices`` caps the ranks of the data mesh."""

    def __init__(
        self,
        config: SuperPointConfig,
        phase: str,
        train_loader,
        test_loader,
        checkpoint_dir: str,
        magicpoint_checkpoint_dir: Optional[str] = None,
        homo_config: HomographyConfig = HomographyConfig(),
        seed: int = 0,
        device=None,
        write_statistics: bool = True,
        log_every: int = 50,
        snapshot_path: Optional[str] = None,
        n_devices: Optional[int] = None,
    ):
        if phase not in ("magicpoint", "superpoint"):
            raise ValueError(f"unknown phase {phase!r}")
        self.mesh = make_mesh(n_devices, axis=config.data_axis,
                              batch_size=train_loader.batch_size)
        self.chief = self.mesh.rank == 0
        backend = (str(dist.get_backend(self.mesh.group))
                   if self.mesh.group is not None else None)
        if config.train_steps_per_call > 1 and self.mesh.size > 1 and backend != "nccl":
            raise ValueError(
                f"train_steps_per_call={config.train_steps_per_call} captures "
                f"the step's collectives in a CUDA graph, which needs NCCL; "
                f"this job's backend is {backend}")
        self.config = config
        self.phase = phase
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.homo_config = homo_config
        self.seed = seed
        self.device = resolve_device(device)
        self.log_every = log_every
        self.snapshot_path = snapshot_path
        self.gen = torch.Generator(device=self.device)
        self._fused_loader = isinstance(train_loader, DeviceBatchLoader)
        if self._fused_loader and train_loader.device != self.device:
            raise ValueError(f"the loader's split is on {train_loader.device}, "
                             f"the trainer runs on {self.device}")
        if self._fused_loader and (train_loader.mesh.size, train_loader.mesh.rank) != (
                self.mesh.size, self.mesh.rank):
            raise ValueError(f"the loader's mesh {train_loader.mesh} is not the "
                             f"trainer's {self.mesh}")

        model = SuperPoint(
            config, generator=torch.Generator().manual_seed(seed * 1_000_003 + 17),
            float32_params=True,
        ).to(self.device, memory_format=torch.channels_last)
        frozen = "descriptor" if phase == "magicpoint" else None
        optimizer = make_optimizer(
            config, model.named_parameters(), frozen_subtree=frozen,
            total_steps=len(train_loader) * config.epochs,
        )
        self.state = S.create_train_state(model, optimizer)

        # resume / phase hand-off
        self.manager = ckpt.checkpoint_manager(checkpoint_dir)
        self.start_epoch = 0
        epoch, saved = ckpt.restore_latest(self.manager, self.device)
        if epoch is not None:
            model.load_state_dict(saved["model"])
            self.state.step = int(saved["step"])
            try:
                optimizer.load_state_dict(saved["optimizer"])
            except KeyError as e:
                # a checkpoint of another optimizer layout (frozen vs full):
                # keep the parameters and statistics, restart the optimizer,
                # as `feature_point_cnn_tpu/train/trainer.py:88-104` does
                print(f"[trainer] WARNING: optimizer state does not fit "
                      f"({e}); restored the model only, fresh optimizer")
            self.start_epoch = epoch + 1
            print(f"[trainer] resumed epoch {epoch} from {checkpoint_dir}")
        elif phase == "superpoint" and magicpoint_checkpoint_dir:
            if str(magicpoint_checkpoint_dir).endswith(".npz"):
                mp_epoch, mp_sd = 0, load_variables(
                    magicpoint_checkpoint_dir, device=self.device)
            else:
                mp_epoch, mp = ckpt.restore_latest(
                    ckpt.checkpoint_manager(magicpoint_checkpoint_dir), self.device)
                mp_sd = None if mp is None else mp["model"]
            if mp_epoch is not None:
                model.load_state_dict(ckpt.graft_pretrained(model.state_dict(), mp_sd))
                print(f"[trainer] grafted MagicPoint weights (epoch {mp_epoch}) "
                      f"from {magicpoint_checkpoint_dir}; descriptor head fresh")
            else:
                print("[trainer] WARNING: no MagicPoint checkpoint found")
        if self.mesh.member:
            # every rank starts from rank 0's state and counters
            counters = torch.tensor([self.start_epoch, self.state.step],
                                    dtype=torch.int64, device=self.device)
            replicate_state([self._state_tensors(), counters], self.mesh)
            self.start_epoch, self.state.step = (int(v) for v in counters.tolist())

        self.writer = MetricWriter(
            f"{checkpoint_dir}/runs" if write_statistics and self.chief else None)
        self._graph_written = False
        self._graph: Optional[torch.cuda.CUDAGraph] = None

    # ------------------------------------------------------------------
    # steps

    def _seed(self, tag: int, index: int) -> torch.Generator:
        """The step's generator: a function of (seed, tag, index) only, so a
        resumed run draws what an uninterrupted one would."""
        return self.gen.manual_seed(
            (self.seed * 1_000_003 + tag) * 1_000_003 + index)

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device, non_blocking=True) for k, v in batch.items()}

    def _train_step(self, batch, gen):
        if self.phase == "magicpoint":
            return S.magicpoint_train_step(self.state, batch, gen, config=self.config)
        return S.superpoint_train_step(
            self.state, batch, gen, config=self.config, homo_config=self.homo_config)

    def _eval_step(self, batch, gen):
        if self.phase == "magicpoint":
            return S.magicpoint_eval_step(self.state, batch, gen, config=self.config)
        return S.superpoint_eval_step(
            self.state, batch, gen, config=self.config, homo_config=self.homo_config)

    def _fused_step(self, idx: torch.Tensor, gen: torch.Generator) -> Metrics:
        """Gather the batch of ``idx`` on the device, then one train step."""
        L = self.train_loader
        batch = L.gather_fn()(L.images, L.points, L.counts, idx)
        return self._train_step(batch, gen)[1]

    def _state_tensors(self) -> List[torch.Tensor]:
        """Everything a step changes in place: parameters, BatchNorm
        statistics, the optimizer's moments and count."""
        opt = self.state.optimizer
        return [*self.state.model.parameters(), *self.state.model.buffers(),
                *opt.mu, *opt.nu, opt.count]

    def _capture(self) -> None:
        """Capture one fused step in a CUDA graph.  Two eager warm-up steps
        on a side stream first (cuBLAS/cuDNN set-up, the kernels' libraries,
        every cached device constant), then the state is put back as it was,
        so the warm-up leaves no trace."""
        if self.config.grad_accum_steps > 1:
            raise ValueError("a CUDA graph of the step cannot hold gradient "
                             "accumulation (its update depends on a host "
                             "counter); use train_steps_per_call=1")
        # this rank's rows of the global batch: the loader's index arrays
        self._static_idx = torch.arange(self.train_loader.local_batch_size,
                                        dtype=torch.int32, device=self.device)
        tensors = self._state_tensors()
        saved = [t.detach().clone() for t in tensors]
        step0 = self.state.step
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._fused_step(self._static_idx, self._seed(0, 0))
        torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        del saved
        self.state.model.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        # the replays draw from the generator's state at replay time
        graph.register_generator_state(self.gen)
        self._seed(0, 0)
        before = profiling.counters()
        with torch.cuda.graph(graph):
            metrics = self._fused_step(self._static_idx, self.gen)
            self._static_names = list(metrics)
            self._static_metrics = torch.stack(
                [metrics[k].to(torch.float32) for k in self._static_names])
        # the capture ran nothing: what it counted is credited at each replay
        self._replay_counts = profiling.counted_since(before)
        profiling.credit(self._replay_counts, -1)
        self.state.step = step0
        self._graph = graph

    @_on_mesh
    def train_steps(self, idxs: List[torch.Tensor], epoch: int,
                    first: int) -> Metrics:
        """``len(idxs)`` optimizer steps in one host call (the fused loader
        only): step ``first + j`` gathers ``idxs[j]`` and draws from
        ``(seed, epoch, first + j)``.  On the card they are replays of the
        captured step; on the CPU eager steps.  Returns the metrics stacked
        ``(len(idxs),)``, still on the device."""
        if not self._fused_loader:
            raise ValueError("train_steps needs a DeviceBatchLoader")
        with profiling.span("train.call"):
            profiling.count("train.steps", len(idxs))
            if self.device.type != "cuda":
                out = [self._fused_step(idx, self._seed(epoch, first + j))
                       for j, idx in enumerate(idxs)]
                return {k: torch.stack([m[k] for m in out]) for k in out[0]}
            if self._graph is None:
                with profiling.span("train.capture"):
                    self._capture()
            rows = torch.empty((len(idxs), len(self._static_names)),
                               dtype=torch.float32, device=self.device)
            for j, idx in enumerate(idxs):
                self._static_idx.copy_(idx)
                self._seed(epoch, first + j)
                self._graph.replay()
                rows[j].copy_(self._static_metrics)
            profiling.credit(self._replay_counts, len(idxs))
            self.state.step += len(idxs)
            return {k: rows[:, i] for i, k in enumerate(self._static_names)}

    # ------------------------------------------------------------------
    # summaries

    def _write_model_table(self) -> None:
        """The model table at train start, in place of the JAX trainer's
        module table and StableHLO text: each module with its parameter
        shapes and counts, then the module tree."""
        self._graph_written = True
        model = self.state.model
        rows = [f"{'module':60s} {'type':16s} {'parameters':>10s}  shapes"]
        for name, mod in model.named_modules():
            params = list(mod.named_parameters(recurse=False))
            if not params:
                continue
            n = sum(p.numel() for _, p in params)
            shapes = ", ".join(f"{k} {tuple(p.shape)}" for k, p in params)
            rows.append(f"{name:60s} {type(mod).__name__:16s} {n:10d}  {shapes}")
        total = sum(p.numel() for p in model.parameters())
        rows.append(f"total parameters {total}")
        self.writer.text(f"model/{self.phase}_table",
                         "\n".join(rows) + "\n\n" + str(model))

    def _write_param_histograms(self, step: int) -> None:
        """Parameter histograms, BatchNorm excluded."""
        model = self.state.model
        bn = {id(p) for m in model.modules() if isinstance(m, nn.BatchNorm2d)
              for p in m.parameters()}
        for name, p in model.named_parameters():
            if id(p) not in bn:
                self.writer.histogram(f"params/{name}",
                                      p.detach().float().cpu().numpy(), step)

    @torch.no_grad()
    def _write_image_summary(self, batch, step: int) -> None:
        """Keypoint overlay of the first item: the model's keypoints through
        the serving extract (decode and NMS kernels on the card) in red, the
        labels in green."""
        from feature_point_cnn_tpu_torch.inference.wrapper import extract_fn
        from feature_point_cnn_tpu_torch.ops.detection import extract_keypoints
        from feature_point_cnn_tpu_torch.ops.labels import (
            make_points_labels_batch, make_prob_map_from_labels)
        from feature_point_cnn_tpu_torch.utils.summary import keypoint_overlay

        cfg = self.config
        img = S._prep_images(batch["image"][:1], cfg).to(torch.float32)
        model = self.state.model.eval()
        try:
            kp, _ = extract_fn(model, img, cfg)
        finally:
            model.train()

        def yx(k):
            v = k.valid[0]
            return torch.stack([k.y[0][v], k.x[0][v]], -1).cpu().numpy()

        labels = make_points_labels_batch(
            batch["points"][:1], batch["points_valid"][:1], self._seed(999, step),
            img.shape[1], img.shape[2], cfg.cell)
        true_prob = make_prob_map_from_labels(labels, cfg.cell)
        tkp = extract_keypoints(true_prob, cfg.replace(confidence_thresh=0.5))
        vis = keypoint_overlay(img[0].cpu().numpy(), yx(kp), yx(tkp))
        self.writer.image(f"detector/{self.phase}", vis, step)

    def _log(self, metrics: Metrics, epoch: int, steps_done: int, t0: float,
             logged: list, summary_batch) -> None:
        """Read the metrics (a device sync) at a logging point: scalars and
        the printed line, on rank 0 alone.  ``summary_batch() -> batch or
        None``: a batch asks for the image summary and the histograms too
        (every ``4 * log_every`` steps)."""
        if not self.chief:
            return
        m = {k: float(v) for k, v in metrics.items()}
        m["lr"] = float(self.state.optimizer.learning_rate())
        logged.append(m)
        step = self.state.step
        for k, v in m.items():
            self.writer.scalar(f"train/{k}", v, step)
        batch = summary_batch()
        if batch is not None:
            try:  # summaries must never stop training
                self._write_image_summary(batch, step)
                self._write_param_histograms(step)
            except Exception as e:
                print(f"[trainer] summary failed: {e}")
        rate = steps_done * self.train_loader.batch_size / (time.time() - t0)
        print(f"[{self.phase}] epoch {epoch} step {steps_done}/"
              f"{len(self.train_loader)} loss {m['loss']:.4f} ({rate:.1f} img/s)")

    # ------------------------------------------------------------------
    # loops

    @_on_mesh
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        logged: list = []
        t0 = time.time()
        if not self._graph_written and self.writer._dir is not None:
            try:
                self._write_model_table()
            except Exception as e:
                self._graph_written = True
                print(f"[trainer] model-table summary failed: {e}")
        window = profiling.StepTraceWindow(
            os.environ.get("FPC_PROFILE_DIR", "") if epoch == 0 else "")
        try:
            if self._fused_loader:
                self._train_epoch_fused(epoch, t0, logged, window)
            else:
                for i, item in enumerate(self.train_loader.epoch(epoch)):
                    window.tick(i)
                    batch = self._to_device(shard_batch(item, self.mesh))
                    with profiling.span("train.step"):
                        profiling.count("train.steps")
                        _, metrics = self._train_step(batch, self._seed(epoch, i))
                    if (i + 1) % self.log_every == 0 or i == 0:
                        self._log(metrics, epoch, i + 1, t0, logged,
                                  lambda: batch
                                  if (i + 1) % (4 * self.log_every) == 0 else None)
        finally:
            window.close()
        if not logged:
            return {}
        return {k: float(np.mean([m[k] for m in logged])) for k in logged[0]}

    def _train_epoch_fused(self, epoch: int, t0: float, logged: list,
                           window: profiling.StepTraceWindow) -> None:
        """The epoch at ``train_steps_per_call`` granularity: whole calls of
        k steps, then the tail as single steps.  Logs the last step of a
        call that crosses a logging point."""
        k = self.config.train_steps_per_call
        idxs = list(self.train_loader.epoch_index_arrays(epoch))
        done = 0
        while done < len(idxs):
            window.tick(done)
            n = k if len(idxs) - done >= k else 1
            chunk = idxs[done:done + n]
            if n == 1:
                with profiling.span("train.step"):
                    profiling.count("train.steps")
                    metrics = self._fused_step(chunk[0], self._seed(epoch, done))
            else:
                metrics = {key: v[-1] for key, v in
                           self.train_steps(chunk, epoch, done).items()}
            done += n
            if done % self.log_every < n or done == n:
                last = chunk[-1]
                self._log(metrics, epoch, done, t0, logged,
                          lambda: self.train_loader.materialize(last)
                          if done % (4 * self.log_every) < n else None)

    @_on_mesh
    def evaluate(self, epoch: int) -> Dict[str, float]:
        if self.test_loader is None:
            return {}
        sums: Dict[str, float] = {}
        n = 0
        # the cap on eval items applies to the SuperPoint phase only
        max_batches = 0
        if self.config.eval_max_items and self.phase == "superpoint":
            max_batches = -(-self.config.eval_max_items // self.config.batch_size)
        for i, batch in enumerate(self.test_loader.epoch(0)):
            if max_batches and i >= max_batches:
                break
            if not isinstance(self.test_loader, DeviceBatchLoader):
                batch = self._to_device(shard_batch(batch, self.mesh))
            metrics = self._eval_step(batch, self._seed(10_000 + epoch, i))
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        out = {k: v / max(n, 1) for k, v in sums.items()}
        for k, v in out.items():
            self.writer.scalar(f"test/{k}", v, epoch)
        return out

    def save(self, epoch: int) -> None:
        """Rank 0 writes; every other rank of the mesh waits for it."""
        if self.chief:
            ckpt.save_state(self.manager, epoch, {
                "model": self.state.model.state_dict(),
                "optimizer": self.state.optimizer.state_dict(),
                "step": self.state.step,
            })
            if self.snapshot_path:
                # a portable single-file snapshot refreshed every epoch
                save_weights(self.snapshot_path, self.state.model.state_dict())
        if self.mesh.group is not None:
            dist.barrier(group=self.mesh.group)

    def train(self, epochs: Optional[int] = None) -> None:
        """Train up to ``epochs`` TOTAL epochs (counting restored ones):
        re-running the same command after an interruption converges on the
        same total."""
        if not self.mesh.member:
            return
        epochs = epochs or self.config.epochs
        end = max(self.start_epoch, epochs)
        if end == self.start_epoch:
            print(f"[trainer] nothing to do: resumed epoch "
                  f"{self.start_epoch - 1} >= target {epochs}")
        for epoch in range(self.start_epoch, end):
            print(f"=== {self.phase} epoch {epoch} ===")
            self.train_epoch(epoch)
            test = self.evaluate(epoch)
            if test and self.chief:
                print(f"[{self.phase}] epoch {epoch} test "
                      + " ".join(f"{k}={v:.4f}" for k, v in test.items()))
            self.save(epoch)
        self.writer.close()
