"""The data and width meshes (`feature_point_cnn_tpu/parallel/mesh.py`).

A `DataMesh` is a 1-D mesh over ranks ``0 .. size - 1`` of the job, one
device a rank.  Batches are split over it by rows and parameters are
replicated; the modules that reduce over the batch sum over its group
(`parallel/collectives.py`; the trainer makes the mesh's group the data
group for its steps), which is what XLA's inserted reductions do on the
JAX side.  Without a process group the mesh is this process alone.

`make_mesh` keeps JAX's rule: the largest rank count that divides the
batch.  A rank that the rule leaves out says so, holds ``rank = -1`` and
takes no part in the mesh's collectives (they run over a subgroup of the
mesh's ranks).

The spatial half (`:64-85`): `make_spatial_mesh` is the same mesh on a
``width`` axis, and `shard_images_spatial` gives each rank its block of
columns of one image, the ``rank``-th of ``size`` equal blocks.  JAX's rule
holds: the width must divide by the mesh size times the 8-px cell, so that
cell boundaries fall on shard boundaries.  Where a width does not split,
GSPMD quietly computes the image replicated; here the split raises instead.
Run the model's forward on the block under
``parallel.spatial.width_group(mesh.group)``: its convolutions and pools
then exchange their halos with the ranks that hold them.
`SuperPointFrontend.extract_spatial` does so for a whole extract, and the
steps of `train/steps.py` for a train or eval step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from feature_point_cnn_tpu_torch.parallel import collectives

CELL = 8    # the model's total stride: cell boundaries fall on shard boundaries


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """``size`` ranks on one ``axis``; ``rank`` is this process's place in
    the mesh, -1 outside it.  ``group`` is the process group of its ranks
    (``None`` without a job)."""

    size: int
    rank: int
    axis: str = "data"
    group: Optional[Any] = None

    @property
    def member(self) -> bool:
        return self.rank >= 0


@functools.lru_cache(maxsize=None)
def _subgroup(n: int):
    """The process group of ranks ``0 .. n - 1``.  `dist.new_group` is
    collective over the whole job, and every rank makes the same meshes in
    the same order, so each is made once and in step."""
    return dist.new_group(list(range(n)))


def mesh_size(world: int, n_devices: Optional[int] = None,
              batch_size: Optional[int] = None) -> int:
    """JAX's rule: at most ``n_devices`` of ``world`` ranks, and with
    ``batch_size`` the largest such count that divides it."""
    n = world if n_devices is None else min(n_devices, world)
    if batch_size is not None:
        while n > 1 and batch_size % n != 0:
            n -= 1
    return n


def make_mesh(
    n_devices: Optional[int] = None,
    axis: str = "data",
    batch_size: Optional[int] = None,
) -> DataMesh:
    """The data mesh over the job's ranks, of `mesh_size` ranks (a batch of
    4 in a job of 8 ranks uses 4), carrying its process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return DataMesh(1, 0, axis)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = mesh_size(world, n_devices, batch_size)
    group = dist.group.WORLD if n == world else _subgroup(n)
    if rank >= n:
        print(f"[mesh] rank {rank} is outside the {axis} mesh of ranks 0-{n - 1}"
              f"{f' (batch {batch_size})' if batch_size else ''}: it takes no "
              f"part in the mesh's collectives")
        return DataMesh(n, -1, axis, group)
    return DataMesh(n, rank, axis, group)


def batch_sharding(mesh: DataMesh, n_rows: int) -> slice:
    """This rank's rows of a global batch of ``n_rows``: the ``rank``-th of
    ``mesh.size`` equal contiguous blocks."""
    if n_rows % mesh.size:
        raise ValueError(f"a batch of {n_rows} does not split over "
                         f"{mesh.size} ranks")
    if not mesh.member:
        raise ValueError("this rank is outside the data mesh")
    per = n_rows // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch: Dict[str, Any], mesh: DataMesh) -> Dict[str, Any]:
    """This rank's rows of a global host batch (every rank holds the same
    global batch, as one host does in JAX)."""
    rows = batch_sharding(mesh, len(next(iter(batch.values()))))
    return {k: v[rows] for k, v in batch.items()}


def make_spatial_mesh(n_devices: Optional[int] = None, axis: str = "width") -> DataMesh:
    """The mesh over which one image is split along W: `make_mesh`'s rule on
    a ``width`` axis."""
    return make_mesh(n_devices, axis=axis)


def spatial_sharding(mesh: DataMesh, width: int) -> slice:
    """This rank's columns of an image ``width`` wide: the ``rank``-th of
    ``mesh.size`` equal contiguous blocks.  JAX's rule: "Widths must divide
    by the mesh size x the total stride (cell)"."""
    if width % (mesh.size * CELL):
        raise ValueError(f"a width of {width} does not split over {mesh.size} ranks: "
                         f"widths must divide by the mesh size x the total stride "
                         f"(cell), {mesh.size} x {CELL}")
    if not mesh.member:
        raise ValueError("this rank is outside the width mesh")
    per = width // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_images_spatial(images: Any, mesh: DataMesh) -> Any:
    """This rank's ``(B, H, W / d, C)`` block of a global ``(B, H, W, C)``
    batch (numpy or a tensor, on the host or the device), as a compact copy
    that holds no full-width storage."""
    block = images[:, :, spatial_sharding(mesh, images.shape[2])]
    if isinstance(block, torch.Tensor):
        return block.clone(memory_format=torch.contiguous_format)
    return np.ascontiguousarray(block)


def _tensors(state: Any) -> List[torch.Tensor]:
    if isinstance(state, torch.nn.Module):
        return [*state.parameters(), *state.buffers()]
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [t for v in state.values() for t in _tensors(v)]
    if isinstance(state, (list, tuple)):
        return [t for v in state for t in _tensors(v)]
    return []


def replicate_state(state: Any, mesh: DataMesh) -> Any:
    """Broadcast every tensor of ``state`` (a module, a tensor, or dicts and
    sequences of them) from the mesh's rank 0, in place; returns
    ``state``."""
    if mesh.group is not None and mesh.member:
        collectives.broadcast_(_tensors(state), g=mesh.group)
    return state
