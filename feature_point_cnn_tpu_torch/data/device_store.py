"""Device-resident dataset: upload a packed split once, gather batches on
the device (`feature_point_cnn_tpu/data/device_store.py`).

A packed split (`data/packed.py`) is uploaded once as uint8 images,
float32 points and int32 counts.  Each batch is then an index gather on the
device from a ``(B,)`` int32 index tensor, so a step ships no images over
the host link; float conversion, the gray repeat, label encoding and
augmentation already run inside the step (`train/steps.py`).  `Trainer`
fuses the gather into its step (`gather_fn`), and its CUDA graph of the
step reads the index from a fixed buffer.

Two placements over a data mesh (`parallel/mesh.py`) of d ranks, as in
the JAX loader; each rank's index tensors pick its ``B / d`` rows of the
global batch of ``batch_size``:

* ``"replicated"``: every rank holds the whole split; the epoch order is
  ``np.random.default_rng(seed + epoch)`` shuffling ``arange(N)``, and rank
  r takes rows ``[r B/d, (r+1) B/d)`` of each global batch.
* ``"sharded"``: the tail is dropped so that d divides the item count, and
  rank r holds items ``[r N/d, (r+1) N/d)`` of the sorted index; each epoch
  draws d local permutations in rank order from one ``default_rng(seed +
  epoch)``, and each batch takes ``B / d`` rows of every rank's permutation.
  A rank gathers from its own slice, with no collective.

Either way the same seed gives the JAX package's batches
(``_epoch_order``, `feature_point_cnn_tpu/data/device_store.py:159-179`).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from feature_point_cnn_tpu_torch.device import resolve_device
from feature_point_cnn_tpu_torch.parallel.mesh import DataMesh, make_mesh

Batch = Dict[str, torch.Tensor]


def dataset_nbytes(ds) -> int:
    """Host-side size of a packed dataset's arrays."""
    return int(
        ds.images.dtype.itemsize * np.prod(ds.images.shape)
        + ds.points.dtype.itemsize * np.prod(ds.points.shape)
        + ds.counts.dtype.itemsize * np.prod(ds.counts.shape)
    )


def _gather(images: torch.Tensor, points: torch.Tensor, counts: torch.Tensor,
            batch_idx: torch.Tensor) -> Batch:
    """One batch: ``image (B, H, W, C)`` uint8, ``points (B, P, 2)``,
    ``points_valid (B, P)`` bool, from a ``(B,)`` index on the device."""
    cnt = counts.index_select(0, batch_idx)
    slots = torch.arange(points.shape[1], device=points.device)
    return {
        "image": images.index_select(0, batch_idx),
        "points": points.index_select(0, batch_idx),
        "points_valid": slots[None, :] < cnt[:, None],
    }


class DeviceBatchLoader:
    """Drop-in replacement for ``datasets.BatchLoader`` backed by
    device-resident tensors (``packed.PackedPointDataset`` source only).
    ``device=None`` means ``cuda``; ``mesh=None`` is `make_mesh` for the
    batch size (this process alone without a process group)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        max_points: int,
        device=None,
        seed: int = 0,
        shuffle: bool = True,
        items_placement: str = "replicated",
        mesh: Optional[DataMesh] = None,
    ):
        if items_placement not in ("replicated", "sharded"):
            raise ValueError(f"unknown items_placement {items_placement!r}")
        self.mesh = mesh if mesh is not None else make_mesh(batch_size=batch_size)
        d = self.mesh.size
        if batch_size % d:
            raise ValueError(f"batch {batch_size} does not split over {d} ranks")
        self.batch_size = batch_size
        self.local_batch_size = batch_size // d
        self.max_points = max_points
        self.seed = seed
        self.shuffle = shuffle
        self.items_placement = items_placement
        self.device = resolve_device(device)

        # the dataset's (size-capped, seed-permuted) item view, sorted, once;
        # sharded: the tail dropped to a multiple of d, this rank's slice kept
        idx = np.sort(np.asarray(dataset.index))
        self.n_items = len(idx)
        if items_placement == "sharded":
            self.n_items = len(idx) - len(idx) % d
            per = self.n_items // d
            r = self.mesh.rank
            idx = idx[r * per:(r + 1) * per] if self.mesh.member else idx[:0]
        k = min(dataset.points.shape[1], max_points)
        points = np.zeros((len(idx), max_points, 2), np.float32)
        points[:, :k] = dataset.points[idx, :k]
        counts = np.minimum(np.asarray(dataset.counts[idx]), max_points)
        self.images = torch.from_numpy(
            np.ascontiguousarray(dataset.images[idx])).to(self.device)
        self.points = torch.from_numpy(points).to(self.device)
        self.counts = torch.from_numpy(counts.astype(np.int32)).to(self.device)

    def __len__(self) -> int:
        return self.n_items // self.batch_size

    def _epoch_order(self, epoch_index: int) -> np.ndarray:
        """Replicated: the global permutation ``(N,)``.  Sharded: every
        rank's local permutation, as ``(n_batches, d, B/d)`` local rows."""
        rng = np.random.default_rng(self.seed + epoch_index)
        if self.items_placement == "replicated":
            order = np.arange(self.n_items)
            if self.shuffle:
                rng.shuffle(order)
            return order
        d, bl = self.mesh.size, self.local_batch_size
        n_local = self.n_items // d
        orders = np.stack([rng.permutation(n_local) if self.shuffle
                           else np.arange(n_local) for _ in range(d)])
        return np.stack([orders[:, i * bl:(i + 1) * bl] for i in range(len(self))])

    def epoch_index_arrays(self, epoch_index: int = 0) -> Iterator[torch.Tensor]:
        """This rank's ``(B / d,)`` int32 index tensors into its own tensors,
        one a global batch, uploaded in one copy; for callers that fuse the
        gather into their own step."""
        n, b, bl = len(self), self.batch_size, self.local_batch_size
        order = self._epoch_order(epoch_index)
        if self.items_placement == "replicated":
            r = self.mesh.rank
            order = order[: n * b].reshape(n, b)[:, r * bl:(r + 1) * bl]
        else:
            order = order[:, self.mesh.rank]
        order = torch.from_numpy(np.ascontiguousarray(order, np.int32)).to(self.device)
        yield from order

    def epoch(self, epoch_index: int = 0) -> Iterator[Batch]:
        for batch_idx in self.epoch_index_arrays(epoch_index):
            yield self.materialize(batch_idx)

    def gather_fn(self) -> Callable[..., Batch]:
        """The gather ``(images, points, counts, batch_idx) -> batch``."""
        return _gather

    def materialize(self, batch_idx: torch.Tensor) -> Batch:
        """This rank's rows of one batch, as device tensors."""
        return _gather(self.images, self.points, self.counts, batch_idx)


# auto-selection threshold: leave the bulk of device memory to the step
MAX_RESIDENT_BYTES = 6 << 30


def make_loader(
    dataset,
    batch_size: int,
    max_points: int,
    seed: int = 0,
    shuffle: bool = True,
    device_resident: str = "auto",
    device=None,
):
    """The device-resident loader (the split replicated) when the source is
    packed and fits; the host prefetching loader otherwise (the JAX
    package's choice)."""
    from feature_point_cnn_tpu_torch.data.datasets import BatchLoader
    from feature_point_cnn_tpu_torch.data.packed import PackedPointDataset

    want = device_resident == "on" or (
        device_resident == "auto"
        and isinstance(dataset, PackedPointDataset)
        and dataset_nbytes(dataset) <= MAX_RESIDENT_BYTES
    )
    if want and isinstance(dataset, PackedPointDataset):
        return DeviceBatchLoader(dataset, batch_size, max_points, device=device,
                                 seed=seed, shuffle=shuffle)
    return BatchLoader(dataset, batch_size, max_points, seed=seed, shuffle=shuffle)
