"""Multi-process launch layer on `torch.distributed`
(`feature_point_cnn_tpu/parallel/distributed.py`).

On each rank of a job:

    from feature_point_cnn_tpu_torch.parallel import distributed
    distributed.initialize()            # no-op outside a launched job
    mesh = distributed.global_mesh()    # every rank of the job

``torchrun --nproc-per-node=N -m feature_point_cnn_tpu_torch.main train
...`` sets the variables `initialize` reads.  The backend is NCCL when the
ranks run on CUDA and gloo on the CPU.  ``backend="gloo"`` with CUDA tensors
is an explicit choice, for ranks that share one card: gloo carries CUDA
tensors for ``all_reduce`` and ``broadcast``, the only collectives the port
calls.  Nothing switches the backend on its own.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from feature_point_cnn_tpu_torch.device import resolve_device
from feature_point_cnn_tpu_torch.parallel import collectives
from feature_point_cnn_tpu_torch.parallel.mesh import (
    DataMesh,
    make_mesh,
    replicate_state,
)

# the variables torchrun sets on every rank: together they mean "this process
# is one rank of a job" (JAX: the coordinator variables, `:31-35`)
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Start this rank's default process group; returns whether it did.

    A no-op (``False``) unless torchrun's variables (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``) are all set or the arguments name a
    job: ``coordinator_address`` ``host:port`` of rank 0, ``num_processes``
    and ``process_id``.  ``device`` (``None``: ``cuda``) picks the default
    backend, NCCL for CUDA and gloo for the CPU; on CUDA the rank runs on
    ``cuda:{LOCAL_RANK}`` (``LOCAL_RANK`` unset: card 0)."""
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and not all(v in os.environ for v in LAUNCH_VARS):
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("an explicit job needs coordinator_address, "
                             "num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(axis: str = "data") -> DataMesh:
    """The data mesh over every rank of the job."""
    return make_mesh(axis=axis)


def process_shard(n_items: int) -> slice:
    """This rank's contiguous shard of ``n_items``: ``n_items // count``
    each, the remainder to the last rank (JAX `:67-73`)."""
    pid, n = process_index(), process_count()
    per = n_items // n
    start = pid * per
    end = start + per if pid < n - 1 else n_items
    return slice(start, end)


def make_global_batch(batch: Dict[str, Any], mesh: DataMesh,
                      device=None) -> Dict[str, torch.Tensor]:
    """Each rank's LOCAL rows, ``global_batch / mesh.size`` of them, as this
    rank's part of one global batch: the data-parallel modules reduce over
    the mesh, so the rows stay where they are.  Checks that every rank of
    the mesh fed the same number of rows."""
    dev = resolve_device(device)
    out = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                              else v).to(dev) for k, v in batch.items()}
    rows = next(iter(out.values())).shape[0]
    total = collectives.all_sum_(torch.tensor([rows], dtype=torch.int64, device=dev),
                                 mesh.group)
    if int(total) != rows * mesh.size:
        raise ValueError(f"ranks fed unequal batches: {rows} rows here, "
                         f"{int(total)} over {mesh.size} ranks")
    return out


def replicate_global(tree: Any, mesh: DataMesh) -> Any:
    """Every tensor of ``tree`` set to rank 0's values on every rank of the
    mesh, by a broadcast: identical values guaranteed, not assumed."""
    return replicate_state(tree, mesh)
