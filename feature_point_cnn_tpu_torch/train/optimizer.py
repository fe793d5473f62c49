"""Optimizer: AdamW with the reference's weight-decay exemptions, global-norm
clipping, skipped non-finite steps, a frozen subtree and gradient
accumulation (`feature_point_cnn_tpu/train/optimizer.py`).

The JAX side builds this from optax pieces; here it is one class, written
by hand so that it matches that chain step for step:

* the schedule is read at the count of updates made **before** this one, so
  the first warm-up step has learning rate 0;
* clipping scales by ``clip / norm`` only when ``norm >= clip``
  (`clip_by_global_norm`; no epsilon in the denominator);
* a step whose gradients hold inf or NaN changes nothing: neither the
  parameters, nor the moments, nor the count (`apply_if_finite`);
* parameters of the frozen subtree never move, and their gradients take no
  part in the norm or in the finite check (`multi_transform`);
* ``grad_accum_steps = k`` averages the gradients of k calls and updates on
  the k-th (`MultiSteps`).

Weight decay skips parameters whose name holds ``bn``, ``bias`` or
``identity``; on the port's parameter names that picks the same tensors as
the JAX rule does on the Flax tree (including the 1x1 convolution
``identity_downsample.0.weight``, exempt there too as ``identity_conv``).

`Optimizer.step` never reads a value back from the device: the skip is
arithmetic (``where`` on 0-d tensors), so the training loop stays
asynchronous.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from feature_point_cnn_tpu_torch.config import SuperPointConfig

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def decay_mask(names: Iterable[str]) -> Dict[str, bool]:
    """True where weight decay applies (the reference's `include` rule)."""
    return {
        n: not any(t in n.lower() for t in ("bn", "bias", "identity"))
        for n in names
    }


def make_schedule(config: SuperPointConfig, total_steps: Optional[int] = None) -> Schedule:
    """The learning rate as a float (``"constant"``, or no ``total_steps``)
    or as a function of the 0-d update count: linear warm-up from 0, then a
    cosine to ``lr_final_ratio * learning_rate`` at ``total_steps``."""
    if config.lr_schedule == "constant" or not total_steps:
        return config.learning_rate
    if config.lr_schedule != "warmup_cosine":
        raise ValueError(f"unknown lr_schedule {config.lr_schedule!r}")
    warmup = min(config.warmup_steps, max(total_steps // 10, 1))
    peak, alpha = config.learning_rate, config.lr_final_ratio
    decay = float(total_steps - warmup)
    if not decay > 0:
        raise ValueError(f"warmup_cosine needs total_steps > warmup, got "
                         f"{total_steps} <= {warmup}")

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = count.to(torch.float32)
        warm = peak * (count / warmup).clamp(0.0, 1.0)
        t = (count - warmup).clamp(0.0, decay)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * t / decay))
        return torch.where(count < warmup, warm,
                           peak * ((1.0 - alpha) * cosine + alpha))

    return schedule


class Optimizer:
    """AdamW over named parameters; see the module note for the rules."""

    def __init__(
        self,
        config: SuperPointConfig,
        named_params: Iterable[Tuple[str, torch.nn.Parameter]],
        frozen_subtree: Optional[str] = None,
        total_steps: Optional[int] = None,
    ):
        named = [(n, p) for n, p in named_params
                 if frozen_subtree is None or n.split(".")[0] != frozen_subtree]
        self.names = [n for n, _ in named]
        self.params: List[torch.nn.Parameter] = [p for _, p in named]
        mask = decay_mask(self.names)
        self.decayed = [p for n, p in named if mask[n]]
        self.config = config
        self.schedule = make_schedule(config, total_steps)
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        # device constants made here, so a CUDA graph of the step copies
        # nothing from the host
        self._b1 = torch.tensor(config.adam_beta1, device=dev)
        self._b2 = torch.tensor(config.adam_beta2, device=dev)
        self._lr = (None if callable(self.schedule) else
                    torch.tensor(self.schedule, dtype=torch.float32, device=dev))
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.accum_k = max(int(config.grad_accum_steps), 1)
        self.mini_step = 0
        self.accum: Optional[List[torch.Tensor]] = None

    def learning_rate(self) -> torch.Tensor:
        """The rate the next update will use."""
        if self._lr is None:
            return self.schedule(self.count)
        return self._lr

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None) -> None:
        """One call of the chain on ``grads`` (default: each parameter's
        ``.grad``; a missing one counts as zero)."""
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        if self.accum_k > 1:
            # running mean over the mini-steps, as MultiSteps keeps it
            if self.accum is None:
                self.accum = [torch.zeros_like(p) for p in self.params]
            diff = torch._foreach_sub(grads, self.accum)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.accum, diff)
            self.mini_step += 1
            if self.mini_step < self.accum_k:
                return
            grads, self.mini_step = self.accum, 0
            self.accum = None
        self._update(grads)

    def _update(self, grads: List[torch.Tensor]) -> None:
        cfg = self.config
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        finite = torch.isfinite(norm)
        # an inf or NaN anywhere makes the norm non-finite (an overflow of
        # the sum of squares would too, at |g| ~ 1e19)
        safe = [torch.where(finite, g, 0.0) for g in grads]
        if cfg.grad_clip_norm > 0:
            c = cfg.grad_clip_norm
            scale = torch.where(finite & (norm >= c), c / norm, 1.0)
            torch._foreach_mul_(safe, scale)

        def coef(x: float, skipped: float) -> torch.Tensor:
            return torch.where(finite, x, skipped)

        torch._foreach_mul_(self.mu, coef(b1, 1.0))
        torch._foreach_add_(self.mu, torch._foreach_mul(safe, coef(1.0 - b1, 0.0)))
        sq = torch._foreach_mul(safe, safe)
        torch._foreach_mul_(sq, coef(1.0 - b2, 0.0))
        torch._foreach_mul_(self.nu, coef(b2, 1.0))
        torch._foreach_add_(self.nu, sq)

        lr = torch.where(finite, self.learning_rate(), 0.0)
        t = (self.count + 1).to(torch.float32)
        bc1 = 1.0 - torch.pow(self._b1, t)
        bc2 = 1.0 - torch.pow(self._b2, t)
        denom = torch._foreach_mul(self.nu, 1.0 / bc2)
        if denom[0].is_cuda:
            torch._foreach_sqrt_(denom)
        else:
            # on the CPU the root is 1 / rsqrt: the CPU's sqrt kernel calls
            # MKL's vdSqrt, whose first call in a process, made by two
            # threads at once under load, has returned one thread's half of
            # a tensor 3e-11 off, so that two data-parallel ranks stepped one
            # parameter apart (`probe_rank_split.py --record`)
            torch._foreach_rsqrt_(denom)
            torch._foreach_reciprocal_(denom)
        torch._foreach_add_(denom, cfg.adam_eps)
        upd = torch._foreach_mul(self.mu, 1.0 / bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -lr)
        if cfg.weight_decay and self.decayed:
            # decay reads the parameters before this update, as optax does
            torch._foreach_add_(
                self.decayed,
                torch._foreach_mul(self.decayed, -lr * cfg.weight_decay),
            )
        torch._foreach_add_(self.params, upd)
        self.count += finite.to(self.count.dtype)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu)),
                "mini_step": self.mini_step,
                "accum": None if self.accum is None
                else dict(zip(self.names, self.accum))}

    def load_state_dict(self, state: dict) -> None:
        """Raises KeyError when ``state`` was made for another parameter set
        (for instance with another frozen subtree)."""
        if set(state["mu"]) != set(self.names):
            raise KeyError("optimizer state holds other parameters than this "
                           "optimizer")
        self.count.copy_(state["count"])
        for n, m, v in zip(self.names, self.mu, self.nu):
            m.copy_(state["mu"][n])
            v.copy_(state["nu"][n])
        self.mini_step = int(state["mini_step"])
        self.accum = None if state["accum"] is None else [
            state["accum"][n].to(m.device).clone()
            for n, m in zip(self.names, self.mu)]


def make_optimizer(
    config: SuperPointConfig,
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    frozen_subtree: Optional[str] = None,
    total_steps: Optional[int] = None,
) -> Optimizer:
    """AdamW with the decay mask; optionally freezes a top-level subtree
    (``"descriptor"`` during the MagicPoint phase) and accumulates over
    ``grad_accum_steps`` calls.  ``named_params``: ``model.named_parameters()``."""
    return Optimizer(config, named_params, frozen_subtree, total_steps)
