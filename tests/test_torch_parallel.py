"""PyTorch port: the parallel layer's pure parts against the JAX package,
in this process and with no process group: the mesh size rule, the data
shards, `initialize`'s no-op, and the item-sharded loader's batches
against JAX's `DeviceBatchLoader(items_placement="sharded")` on a 2-device
mesh of the virtual CPUs.  The two-rank job is
`tests/test_torch_distributed.py`.  Everything here is held exactly."""

import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.data import device_store as jax_device_store
from feature_point_cnn_tpu.parallel import mesh as jax_mesh

from feature_point_cnn_tpu_torch.data import device_store
from feature_point_cnn_tpu_torch.parallel import collectives, distributed
from feature_point_cnn_tpu_torch.parallel import mesh as M


@pytest.mark.parametrize("n_devices,batch_size", [
    (None, 6), (None, 8), (None, 7), (None, None), (4, 6), (3, 9), (5, 10), (1, 4),
])
def test_make_mesh_divisor_rule_matches_jax(n_devices, batch_size):
    """`tests/test_parallel.py:14`'s rule: the largest count of at most
    ``n_devices`` of the 8 devices that divides the batch."""
    want = jax_mesh.make_mesh(n_devices, batch_size=batch_size).devices.size
    assert M.mesh_size(8, n_devices, batch_size) == want


def test_mesh_without_a_process_group_is_this_process():
    mesh = M.make_mesh(batch_size=6)
    assert (mesh.size, mesh.rank, mesh.group, mesh.member) == (1, 0, None, True)
    assert collectives.group() is None and collectives.shard() == (0, 1)
    x = torch.arange(6.0, requires_grad=True)
    assert collectives.all_sum(x) is x and collectives.all_sum_(x) is x
    assert collectives.gather_rows(x) is x
    batch = {"image": np.arange(12).reshape(6, 2)}
    np.testing.assert_array_equal(M.shard_batch(batch, mesh)["image"], batch["image"])


@pytest.mark.parametrize("rank,want", [(0, slice(0, 3)), (1, slice(3, 6))])
def test_batch_sharding_takes_the_ranks_block(rank, want):
    assert M.batch_sharding(M.DataMesh(2, rank), 6) == want
    with pytest.raises(ValueError, match="does not split"):
        M.batch_sharding(M.DataMesh(4, rank), 6)
    with pytest.raises(ValueError, match="outside"):
        M.batch_sharding(M.DataMesh(2, -1), 6)


@pytest.mark.parametrize("n_items,count,want", [
    (10, 2, [(0, 5), (5, 10)]),
    (11, 3, [(0, 3), (3, 6), (6, 11)]),
    (7, 1, [(0, 7)]),
])
def test_process_shard_slices(monkeypatch, n_items, count, want):
    """JAX's arithmetic (`parallel/distributed.py:67-73`): equal shares, the
    remainder to the last rank, no overlap."""
    got = []
    for pid in range(count):
        monkeypatch.setattr(distributed, "process_index", lambda pid=pid: pid)
        monkeypatch.setattr(distributed, "process_count", lambda: count)
        s = distributed.process_shard(n_items)
        got.append((s.start, s.stop))
    assert got == want


def test_initialize_is_a_no_op_outside_a_launched_job(monkeypatch):
    """Without torchrun's variables (all three of RANK, WORLD_SIZE,
    MASTER_ADDR) or explicit arguments nothing starts, on any device."""
    for var in distributed.LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert distributed.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert distributed.process_index() == 0 and distributed.process_count() == 1
    with pytest.raises(ValueError, match="process_id"):
        distributed.initialize("localhost:1", num_processes=2, device="cpu")
    assert not torch.distributed.is_initialized()


class _Items:
    """A packed split's arrays, as both loaders read them."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, 8, 16, 1), dtype=np.uint8)
        self.points = rng.random((n, 6, 2)).astype(np.float32) * 8
        self.counts = rng.integers(0, 7, n).astype(np.int32)
        self.index = rng.permutation(n)


@pytest.mark.parametrize("shuffle", [True, False])
def test_sharded_loader_order_and_batches_match_jax_on_two_devices(shuffle):
    """11 items over 2 ranks (the tail item dropped), global batch 4: each
    rank's local rows equal JAX's ``_epoch_order`` (its rank's column), and
    the ranks' batches, stacked in rank order, equal JAX's global batch."""
    ds = _Items(11, 0)
    want = jax_device_store.DeviceBatchLoader(
        ds, 4, 5, mesh=jax_mesh.make_mesh(2), seed=3, shuffle=shuffle,
        items_placement="sharded")
    ranks = [device_store.DeviceBatchLoader(
        ds, 4, 5, device="cpu", seed=3, shuffle=shuffle, items_placement="sharded",
        mesh=M.DataMesh(2, r)) for r in range(2)]
    assert [len(r) for r in ranks] == [len(want)] * 2 == [2, 2]
    assert [r.images.shape[0] for r in ranks] == [5, 5]
    for epoch in (0, 1):
        order = want._epoch_order(epoch)
        for r, loader in enumerate(ranks):
            np.testing.assert_array_equal(loader._epoch_order(epoch), order)
            got = np.stack([i.numpy() for i in loader.epoch_index_arrays(epoch)])
            np.testing.assert_array_equal(got, order[:, r])
        for jb, *tb in zip(want.epoch(epoch), *(r.epoch(epoch) for r in ranks)):
            for k in jb:
                np.testing.assert_array_equal(
                    np.concatenate([b[k].numpy() for b in tb]), np.asarray(jb[k]),
                    err_msg=k)


def test_replicated_loader_gives_each_rank_its_rows():
    """The replicated placement over 2 ranks: each rank holds the whole
    split and gathers its half of the one-process batch."""
    ds = _Items(9, 1)
    whole = device_store.DeviceBatchLoader(ds, 4, 5, device="cpu", seed=2)
    ranks = [device_store.DeviceBatchLoader(ds, 4, 5, device="cpu", seed=2,
                                            mesh=M.DataMesh(2, r)) for r in range(2)]
    for wb, *tb in zip(whole.epoch(1), *(r.epoch(1) for r in ranks)):
        for k in wb:
            assert torch.equal(torch.cat([b[k] for b in tb]), wb[k]), k
