"""Training loop: epochs, checkpoint/resume, metrics
(`feature_point_cnn_tpu/train/trainer.py`).

One process, one device.  Not ported yet: the device mesh, the
device-resident loader with its fused and scanned dispatch, the metric
writer's summaries and the profiling windows.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
from feature_point_cnn_tpu_torch.data.datasets import BatchLoader
from feature_point_cnn_tpu_torch.device import resolve_device
from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
from feature_point_cnn_tpu_torch.train import steps as S
from feature_point_cnn_tpu_torch.train.optimizer import make_optimizer
from feature_point_cnn_tpu_torch.utils import checkpoint as ckpt
from feature_point_cnn_tpu_torch.utils.weights import load_variables, save_weights


class Trainer:
    """Phase-agnostic trainer; ``phase`` is ``"magicpoint"`` or
    ``"superpoint"``.  ``device=None`` means ``cuda``."""

    def __init__(
        self,
        config: SuperPointConfig,
        phase: str,
        train_loader: BatchLoader,
        test_loader: Optional[BatchLoader],
        checkpoint_dir: str,
        magicpoint_checkpoint_dir: Optional[str] = None,
        homo_config: HomographyConfig = HomographyConfig(),
        seed: int = 0,
        device=None,
        log_every: int = 50,
        snapshot_path: Optional[str] = None,
    ):
        if phase not in ("magicpoint", "superpoint"):
            raise ValueError(f"unknown phase {phase!r}")
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

    # ------------------------------------------------------------------

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

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        logged = []
        t0 = time.time()
        for i, item in enumerate(self.train_loader.epoch(epoch)):
            _, metrics = self._train_step(self._to_device(item), self._seed(epoch, i))
            # fetch metrics (a device sync) only at logging points
            if (i + 1) % self.log_every == 0 or i == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["lr"] = float(self.state.optimizer.learning_rate())
                logged.append(m)
                rate = (i + 1) * self.train_loader.batch_size / (time.time() - t0)
                print(f"[{self.phase}] epoch {epoch} step {i + 1}/"
                      f"{len(self.train_loader)} loss {m['loss']:.4f} "
                      f"({rate:.1f} img/s)")
        if not logged:
            return {}
        return {k: float(np.mean([m[k] for m in logged])) for k in logged[0]}

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
            metrics = self._eval_step(self._to_device(batch),
                                      self._seed(10_000 + epoch, i))
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in sums.items()}

    def save(self, epoch: int) -> None:
        ckpt.save_state(self.manager, epoch, {
            "model": self.state.model.state_dict(),
            "optimizer": self.state.optimizer.state_dict(),
            "step": self.state.step,
        })
        if self.snapshot_path:
            # a portable single-file snapshot refreshed every epoch
            save_weights(self.snapshot_path, self.state.model.state_dict())

    def train(self, epochs: Optional[int] = None) -> None:
        """Train up to ``epochs`` TOTAL epochs (counting restored ones):
        re-running the same command after an interruption converges on the
        same total."""
        epochs = epochs or self.config.epochs
        end = max(self.start_epoch, epochs)
        if end == self.start_epoch:
            print(f"[trainer] nothing to do: resumed epoch "
                  f"{self.start_epoch - 1} >= target {epochs}")
        for epoch in range(self.start_epoch, end):
            print(f"=== {self.phase} epoch {epoch} ===")
            self.train_epoch(epoch)
            test = self.evaluate(epoch)
            if test:
                print(f"[{self.phase}] epoch {epoch} test "
                      + " ".join(f"{k}={v:.4f}" for k, v in test.items()))
            self.save(epoch)
