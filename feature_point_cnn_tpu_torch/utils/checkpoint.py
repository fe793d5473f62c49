"""Step-indexed checkpoints with `torch.save`
(`feature_point_cnn_tpu/utils/checkpoint.py`, which uses orbax).

A checkpoint is one file ``<dir>/ckpt_<step>.pt`` holding a plain dict (the
trainer stores ``{"model", "optimizer", "step"}``), written to a temporary
name and renamed; the newest ``max_to_keep`` are kept.  The MagicPoint ->
SuperPoint hand-off is a partial graft of a ``state_dict``.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> Path:
        return self.directory / f"ckpt_{step}.pt"


def checkpoint_manager(directory: str, max_to_keep: int = 5) -> CheckpointManager:
    return CheckpointManager(directory, max_to_keep)


def save_state(manager: CheckpointManager, step: int, state: Mapping[str, Any]) -> None:
    tmp = manager.path(step).with_suffix(".tmp")
    torch.save(dict(state), tmp)
    os.replace(tmp, manager.path(step))
    for old in manager.all_steps()[:-manager.max_to_keep]:
        manager.path(old).unlink()


def restore_latest(
    manager: CheckpointManager, map_location="cpu"
) -> Tuple[Optional[int], Optional[Dict[str, Any]]]:
    """``(step, state)`` of the newest checkpoint, or ``(None, None)`` when
    there is none."""
    step = manager.latest_step()
    if step is None:
        return None, None
    return step, torch.load(manager.path(step), map_location=map_location,
                            weights_only=True)


def graft_pretrained(
    state_dict: Mapping[str, torch.Tensor],
    pretrained: Mapping[str, torch.Tensor],
    subtrees=("encoder", "detector"),
) -> Dict[str, torch.Tensor]:
    """Copy ``subtrees`` (parameters and BatchNorm statistics) from a
    pretrained (MagicPoint) ``state_dict`` into a fresh one, leaving the
    rest (the descriptor head) at its fresh init."""
    out = dict(state_dict)
    for k in out:
        if k.split(".")[0] in subtrees:
            out[k] = pretrained[k]
    return out
