"""On-device evaluation metrics (`feature_point_cnn_tpu/utils/metrics.py`)."""

from __future__ import annotations

import torch


def samplewise_f1(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``logits (B, ..., C)``, ``targets (B, ...)`` int -> scalar F1.

    Micro F1 per sample (== accuracy for single-label multiclass), averaged
    over the batch.
    """
    correct = (logits.argmax(dim=-1) == targets).to(torch.float32)
    return correct.reshape(correct.shape[0], -1).mean(dim=-1).mean()
