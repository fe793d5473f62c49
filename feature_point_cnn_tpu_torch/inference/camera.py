"""Frame sources for the live demo: webcam (threaded), video file, or a
synthetic drifting checkerboard for headless runs
(`feature_point_cnn_tpu/inference/camera.py:17-83`).

`Camera` needs ``cv2``, imported inside its methods; `SyntheticCamera` is
numpy only.  Frames are ``(H, W, 3)`` float32 RGB in [0, 1].
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

import numpy as np


class Camera:
    """Threaded webcam or video capture, converted from OpenCV's BGR to
    RGB (the network trains on RGB)."""

    def __init__(self, source=0):
        import cv2

        self.cap = cv2.VideoCapture(source)
        if not self.cap.isOpened():
            raise RuntimeError(f"failed to open capture source {source!r}")
        self.status = False
        self.frame: Optional[np.ndarray] = None
        self._stop = False
        # finite sources (video files) are read synchronously a get_frame: a
        # free-running grab thread would race to the end before the consumer
        # sees a frame; live sources keep the always-newest thread
        self._is_stream = self.cap.get(cv2.CAP_PROP_FRAME_COUNT) <= 0
        self.thread = None
        if self._is_stream:
            self.thread = threading.Thread(target=self._update, daemon=True)
            self.thread.start()

    def _update(self):
        while not self._stop and self.cap.isOpened():
            self.status, self.frame = self.cap.read()

    def get_frame(self) -> Tuple[Optional[np.ndarray], bool]:
        import cv2

        if not self._is_stream:
            self.status, self.frame = self.cap.read()
        if not self.status or self.frame is None:
            return None, False
        rgb = cv2.cvtColor(self.frame, cv2.COLOR_BGR2RGB)
        return rgb.astype(np.float32) / 255.0, True

    def close(self):
        self._stop = True
        if self.thread is not None:
            self.thread.join(timeout=1.0)
        self.cap.release()


class SyntheticCamera:
    """Headless stand-in: a checkerboard drifting with the wall clock, so
    the demo loop runs with no hardware."""

    def __init__(self, size: Tuple[int, int] = (480, 640), speed: float = 0.5):
        self.size = size
        self.speed = speed
        self.t0 = time.time()
        h, w = size
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        self._yy, self._xx = yy, xx

    def get_frame(self) -> Tuple[np.ndarray, bool]:
        t = (time.time() - self.t0) * self.speed
        dx, dy = 40 * np.sin(t), 25 * np.cos(0.7 * t)
        board = (
            (((self._xx + dx) // 40).astype(int) + ((self._yy + dy) // 40).astype(int))
            % 2
        )
        frame = (0.25 + 0.55 * board).astype(np.float32)
        return np.repeat(frame[..., None], 3, axis=-1), True

    def close(self):
        pass
