"""Host-side npz datasets + prefetching batch loader, numpy only
(`feature_point_cnn_tpu/data/datasets.py`).

Reads the on-disk contract ``{image: (C, H, W) float32 | uint8, points: (3,
N) [x, y, conf]}`` and yields **fixed-shape** numpy batches: images NHWC
(gray repeated to 3 channels), ragged point lists padded to ``max_points``
with a validity mask, in the internal ``(y, x)`` convention.  Label encoding
and homographic augmentation run on the device inside the train step.

`BatchLoader` takes any dataset with ``__len__`` and ``read(index) ->
(image, points)`` (or a batched ``read_batch(indices, max_points)``).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np


def read_npz_item(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """One item -> ``(image (H, W, 3) float32 in [0,1], points (N, 2) (y, x))``."""
    data = np.load(path)
    image = data["image"]
    if image.ndim < 2:
        raise ValueError(f"{path}: image has {image.ndim} dimensions")
    if image.ndim == 2:
        image = image[None]
    if image.shape[0] == 1:
        image = np.repeat(image, 3, axis=0)
    if image.dtype == np.uint8:
        image = image.astype(np.float32) / 255.0
    image = np.transpose(image, (1, 2, 0)).astype(np.float32)  # CHW -> HWC

    points = data["points"][:2].T.astype(np.float32)           # (N, 2) (x, y)
    return image, points[:, ::-1].copy()                       # -> (y, x)


class NpzPointDataset:
    """Map-style dataset over ``<path>/<split>/*.npz`` with seeded shuffling."""

    def __init__(self, path: str, split: str, seed: int = 0, size: int = 0):
        self.data_path = Path(path) / split
        items = sorted(str(p) for p in self.data_path.glob("*.npz"))
        if not items:
            raise FileNotFoundError(f"no .npz items under {self.data_path}")
        np.random.default_rng(seed).shuffle(items)
        self.items: List[str] = items[:size] if size else items

    def __len__(self) -> int:
        return len(self.items)

    def read(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        return read_npz_item(self.items[index])


def _assemble_batch(
    samples: List[Tuple[np.ndarray, np.ndarray]], max_points: int
) -> Dict[str, np.ndarray]:
    images = np.stack([s[0] for s in samples])
    b = len(samples)
    points = np.zeros((b, max_points, 2), np.float32)
    valid = np.zeros((b, max_points), bool)
    for i, (_, pts) in enumerate(samples):
        n = min(len(pts), max_points)
        points[i, :n] = pts[:n]
        valid[i, :n] = True
    return {"image": images, "points": points, "points_valid": valid}


class BatchLoader:
    """Epoch iterator over fixed-shape batches with background prefetch.

    ``drop_last`` is always true: one static batch shape.  Reshuffles every
    epoch from ``seed + epoch``.
    """

    def __init__(self, dataset, batch_size: int, max_points: int, seed: int = 0,
                 shuffle: bool = True, prefetch: int = 2, num_threads: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_points = max_points
        self.seed = seed
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.num_threads = num_threads

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def epoch(self, epoch_index: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch_index).shuffle(order)
        batch_indices = [
            order[i * self.batch_size:(i + 1) * self.batch_size]
            for i in range(len(self))
        ]
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        fast = getattr(self.dataset, "read_batch", None)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                if fast is not None:
                    for idxs in batch_indices:
                        if not put(fast(idxs, self.max_points)):
                            return
                else:
                    with ThreadPoolExecutor(self.num_threads) as pool:
                        for idxs in batch_indices:
                            samples = list(
                                pool.map(self.dataset.read, (int(i) for i in idxs))
                            )
                            if not put(_assemble_batch(samples, self.max_points)):
                                return
                put(None)
            except BaseException as e:  # surface reader crashes to the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()      # an abandoned epoch must not leave the worker blocked
            t.join()
