"""Metric writer of the trainer (`feature_point_cnn_tpu/utils/summary.py`).

Scalars, parameter histograms, rendered keypoint images and text.  It
always writes ``metrics.jsonl`` (one JSON object a scalar), the text
files and the images (binary PPM); it also writes TensorBoard events through
``torch.utils.tensorboard`` where that imports.  Nothing here is imported
at module import time but numpy.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import numpy as np


def _safe(tag: str) -> str:
    """A tag as a file name."""
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in tag)


class MetricWriter:
    def __init__(self, log_dir: Optional[str]):
        self._tb = None
        self._jsonl = None
        self._dir = log_dir
        if log_dir is None:
            return
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)
        except ImportError:   # no tensorboard here: the files alone
            pass
        self._jsonl = open(Path(log_dir) / "metrics.jsonl", "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._jsonl is not None:
            self._jsonl.write(
                json.dumps({"t": time.time(), "step": step, tag: value}) + "\n"
            )
            self._jsonl.flush()

    def image(self, tag: str, image_hwc: np.ndarray, step: int) -> None:
        """An ``(H, W, 3)`` uint8 image: a binary PPM next to metrics.jsonl
        (``<tag>_<step>.ppm``) and a TensorBoard image."""
        if self._dir is not None:
            rgb = np.ascontiguousarray(image_hwc, np.uint8)
            h, w = rgb.shape[:2]
            (Path(self._dir) / f"{_safe(tag)}_{step}.ppm").write_bytes(
                f"P6\n{w} {h}\n255\n".encode() + rgb.tobytes())
        if self._tb is not None:
            self._tb.add_image(tag, image_hwc.transpose(2, 0, 1), step)

    def histogram(self, tag: str, values: np.ndarray, step: int) -> None:
        if self._tb is not None:
            self._tb.add_histogram(tag, values, step)

    def text(self, tag: str, text: str, step: int = 0) -> None:
        """Large text artifact (the model table).  Written as a plain file
        next to metrics.jsonl (full content) and, truncated, as a
        TensorBoard text summary."""
        if self._dir is not None:
            (Path(self._dir) / f"{_safe(tag)}.txt").write_text(text)
        if self._tb is not None:
            limit = 65536
            body = text if len(text) <= limit else (
                text[:limit] + f"\n... [{len(text) - limit} bytes truncated; "
                f"full text next to metrics.jsonl]"
            )
            self._tb.add_text(tag, f"```\n{body}\n```", step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()


def keypoint_overlay(
    image_hwc: np.ndarray,
    pred_points_yx: np.ndarray,
    true_points_yx: np.ndarray,
) -> np.ndarray:
    """Render predictions (red, r=3) and labels (green, r=1) over the image,
    the training image summary.  Needs ``cv2``."""
    import cv2

    vis = (np.clip(image_hwc, 0, 1) * 255).astype(np.uint8).copy()
    if vis.shape[-1] == 1:
        vis = np.repeat(vis, 3, axis=-1)
    for y, x in pred_points_yx:
        cv2.circle(vis, (int(round(x)), int(round(y))), 3, (255, 0, 0), -1, lineType=16)
    for y, x in true_points_yx:
        cv2.circle(vis, (int(round(x)), int(round(y))), 1, (0, 255, 0), -1, lineType=16)
    return vis
