"""PyTorch port: the training data path against the JAX package, on the
CPU: the synthetic-shape generator, dataset generation, the real-photo
corpus, packed splits, the device-resident loader and its choice, and the
evaluation harness on the synthetic source.

Tolerances: everything drawn from a `numpy.random.Generator` or read from
disk is held EXACTLY (images, points, files, packed arrays, batches, epoch
orders); the harness's aggregates on synthetic scenes within 1e-3 with the
released float32 weights on both sides and the same homographies, as
`tests/test_torch_eval.py` holds them (RANSAC's estimate aside: its draws
cannot repeat `jax.random`'s).  Dataset generation runs its tasks in
threads here (both packages' ``ProcessPoolExecutor`` patched to a thread
pool) so the test process never forks.
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.config import HomographyConfig as JaxHomographyConfig
from feature_point_cnn_tpu.data import device_store as jax_device_store
from feature_point_cnn_tpu.data import generate as jax_generate
from feature_point_cnn_tpu.data import packed as jax_packed
from feature_point_cnn_tpu.data import real_corpus as jax_real_corpus
from feature_point_cnn_tpu.data import synthetic_shapes as jax_shapes
from feature_point_cnn_tpu.data.datasets import BatchLoader as JaxBatchLoader
from feature_point_cnn_tpu.eval import benchmark as jax_benchmark
from feature_point_cnn_tpu.geometry.homography import sample_homography as jax_sample_homography
from tests.test_torch_eval import MILD, _assert_aggregates_close, _frontends

from feature_point_cnn_tpu_torch.config import HomographyConfig
from feature_point_cnn_tpu_torch.data import device_store, generate, packed, real_corpus
from feature_point_cnn_tpu_torch.data import synthetic_shapes as shapes
from feature_point_cnn_tpu_torch.data.datasets import BatchLoader, NpzPointDataset
from feature_point_cnn_tpu_torch.eval import benchmark

SMALL = dict(image_size=(192, 256), out_size=(48, 64))


@pytest.mark.parametrize("primitive", shapes.PRIMITIVES)
def test_shape_generator_is_bit_equal_to_jax(primitive):
    assert shapes.PRIMITIVES == jax_shapes.PRIMITIVES
    for seed in (0, 1, 2):
        got_gen = shapes.SyntheticShapeGenerator(np.random.default_rng(seed), **SMALL)
        want_gen = jax_shapes.SyntheticShapeGenerator(np.random.default_rng(seed), **SMALL)
        for _ in range(2):   # the second draw continues the same stream
            got, want = got_gen.sample(primitive), want_gen.sample(primitive)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got_gen.rng.random(4), want_gen.rng.random(4))


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


def test_generate_dataset_writes_jax_tree(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_generate, "ProcessPoolExecutor", ThreadPoolExecutor)
    monkeypatch.setattr(generate, "ProcessPoolExecutor", ThreadPoolExecutor)
    jax_generate.generate_dataset(str(tmp_path / "jax"), 2, 1, seed=3, workers=4)
    generate.main([str(tmp_path / "port"), "--train-size", "2", "--test-size", "1",
                   "--seed", "3", "--workers", "4"])
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert list(got) == list(want) and len(got) == 27
    for name in want:
        with np.load(want[name]) as w, np.load(got[name]) as g:
            assert w.files == g.files
            for k in w.files:
                np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError):
        generate.generate_dataset(str(tmp_path / "x"), -1, 0)


@pytest.fixture(scope="module")
def npz_tree(tmp_path_factory):
    """A small tree in the on-disk contract, written by the port's
    generator: 10 train items, 4 test items at 48x64."""
    root = tmp_path_factory.mktemp("npz")
    gen = shapes.SyntheticShapeGenerator(np.random.default_rng(0), **SMALL)
    for split, n in (("train", 10), ("test", 4)):
        (root / split).mkdir()
        for i in range(n):
            prim = shapes.PRIMITIVES[i % len(shapes.PRIMITIVES)]
            image, points = gen.sample(prim)
            np.savez_compressed(root / split / f"{prim}_{i}.npz", image=image,
                                points=points)
    return root


@pytest.fixture(scope="module")
def packed_pair(npz_tree, tmp_path_factory):
    """The tree packed by each package."""
    out = tmp_path_factory.mktemp("packed")
    jax_packed.pack_dataset(str(npz_tree), str(out / "jax"))
    packed.main([str(npz_tree), str(out / "port")])
    return out / "jax", out / "port"


def test_pack_dataset_writes_jax_arrays(packed_pair):
    jroot, troot = packed_pair
    for split in ("train", "test"):
        assert packed.is_packed(str(troot), split)
        assert (troot / split / "meta.json").read_text() == (
            jroot / split / "meta.json").read_text()
        for name in ("images", "points", "counts"):
            w = np.load(jroot / split / f"{name}.npy")
            g = np.load(troot / split / f"{name}.npy")
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,size", [(0, 0), (5, 0), (2, 6)])
def test_packed_dataset_index_size_and_reads_equal_jax(packed_pair, seed, size):
    jroot, troot = packed_pair
    want = jax_packed.PackedPointDataset(str(jroot), "train", seed=seed, size=size)
    got = packed.PackedPointDataset(str(troot), "train", seed=seed, size=size)
    assert len(got) == len(want) == (size or 10)
    np.testing.assert_array_equal(got.index, want.index)
    for i in range(len(got)):
        for a, b in zip(got.read(i), want.read(i)):
            np.testing.assert_array_equal(a, b)
    gb, wb = got.read_batch([3, 0, 1], 8), want.read_batch([3, 0, 1], 8)
    for k in wb:
        np.testing.assert_array_equal(gb[k], wb[k])


def test_open_dataset_falls_back_to_npz(npz_tree, packed_pair):
    assert isinstance(packed.open_dataset(str(packed_pair[1]), "train"),
                      packed.PackedPointDataset)
    ds = packed.open_dataset(str(npz_tree), "train", seed=1, size=4)
    assert isinstance(ds, NpzPointDataset) and len(ds) == 4


@pytest.mark.parametrize("epoch", [0, 1, 3])
def test_device_loader_batches_equal_jax(packed_pair, epoch):
    jroot, troot = packed_pair
    want_ds = jax_packed.PackedPointDataset(str(jroot), "train", seed=1, size=8)
    got_ds = packed.PackedPointDataset(str(troot), "train", seed=1, size=8)
    want = jax_device_store.DeviceBatchLoader(want_ds, 2, 16, seed=4)
    got = device_store.DeviceBatchLoader(got_ds, 2, 16, device="cpu", seed=4)
    assert len(got) == len(want) == 4
    wb, gb = list(want.epoch(epoch)), list(got.epoch(epoch))
    for w, g in zip(wb, gb):
        assert g["image"].dtype == torch.uint8 and g["image"].shape == (2, 48, 64, 1)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    for wi, gi in zip(want.epoch_index_arrays(epoch), got.epoch_index_arrays(epoch)):
        assert gi.dtype == torch.int32
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        b = got.gather_fn()(got.images, got.points, got.counts, gi)
        assert all(torch.equal(b[k], got.materialize(gi)[k]) for k in b)


def test_device_loader_batches_equal_the_packed_arrays(packed_pair):
    """Each gathered batch is the packed split's rows in the seed's order."""
    ds = packed.PackedPointDataset(str(packed_pair[1]), "train")
    loader = device_store.DeviceBatchLoader(ds, 2, 32, device="cpu", seed=0)
    rows = np.sort(ds.index)
    order = np.arange(len(rows))
    np.random.default_rng(0 + 2).shuffle(order)
    for i, b in enumerate(loader.epoch(2)):
        take = rows[order[2 * i:2 * i + 2]]
        np.testing.assert_array_equal(b["image"].numpy(), ds.images[take])
        np.testing.assert_array_equal(b["points_valid"].sum(-1).numpy(),
                                      np.minimum(ds.counts[take], 32))


def test_make_loader_chooses_as_jax(npz_tree, packed_pair):
    jroot, troot = packed_pair
    pairs = [
        (jax_packed.PackedPointDataset(str(jroot), "train"),
         packed.PackedPointDataset(str(troot), "train")),
        (jax_packed.open_dataset(str(npz_tree), "train"),
         packed.open_dataset(str(npz_tree), "train")),
    ]
    for jds, tds in pairs:
        for mode in ("auto", "on", "off"):
            want = jax_device_store.make_loader(jds, 2, 16, device_resident=mode)
            got = device_store.make_loader(tds, 2, 16, device_resident=mode, device="cpu")
            assert isinstance(want, JaxBatchLoader) == isinstance(got, BatchLoader)
            assert (isinstance(want, jax_device_store.DeviceBatchLoader)
                    == isinstance(got, device_store.DeviceBatchLoader))
    assert device_store.MAX_RESIDENT_BYTES == jax_device_store.MAX_RESIDENT_BYTES
    assert device_store.dataset_nbytes(pairs[0][1]) == jax_device_store.dataset_nbytes(
        pairs[0][0])


def test_item_sharded_placement_names_the_parallel_slice(packed_pair):
    """Named for the raise this test held while the item-sharded placement
    was missing.  It now checks the ported placement: over the mesh of this
    process alone its one permutation of the whole split gives the
    replicated placement's batches; an unknown placement raises.  Its order
    over two ranks is held to JAX's in `tests/test_torch_parallel.py`."""
    ds = packed.PackedPointDataset(str(packed_pair[1]), "train")
    sharded = device_store.DeviceBatchLoader(ds, 2, 16, device="cpu",
                                             items_placement="sharded")
    replicated = device_store.DeviceBatchLoader(ds, 2, 16, device="cpu")
    assert len(sharded) == len(replicated) > 0
    for a, b in zip(sharded.epoch(1), replicated.epoch(1)):
        assert all(torch.equal(a[k], b[k]) for k in b)
    with pytest.raises(ValueError, match="items_placement"):
        device_store.DeviceBatchLoader(ds, 2, 16, device="cpu", items_placement="ring")


def test_real_corpus_equals_jax_on_the_installed_photos(tmp_path):
    got_src = real_corpus.collect_source_images()
    want_src = jax_real_corpus.collect_source_images()
    assert len(got_src) == len(want_src) >= 2
    assert all(np.array_equal(g, w) for g, w in zip(got_src, want_src))
    jax_real_corpus.build_corpus(str(tmp_path / "jax"), 3, 2, (48, 64), seed=2)
    real_corpus.main([str(tmp_path / "port"), "--train-size", "3", "--test-size", "2",
                      "--height", "48", "--width", "64", "--seed", "2"])
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert list(got) == list(want) and len(got) == 6
    for name in want:
        assert got[name].read_bytes() == want[name].read_bytes(), name


def test_evaluate_pairs_on_the_synthetic_source_gives_jax_aggregates(monkeypatch):
    h, w, n = 64, 96, 3
    want_imgs = list(jax_benchmark.synthetic_images(n, (h, w), seed=1))
    got_imgs = list(benchmark.synthetic_images(n, (h, w), seed=1))
    for a, b in zip(got_imgs, want_imgs):
        np.testing.assert_array_equal(a, b)
    cfg = JaxHomographyConfig(**MILD)
    sample = jax.jit(lambda key: jax_sample_homography(key, (h, w), cfg))
    hs = [np.asarray(sample(jax.random.PRNGKey(20 + i))) for i in range(n)]
    jit, tit = iter(hs), iter(hs)
    monkeypatch.setattr(jax_benchmark, "sample_homography",
                        lambda key, shape, c: jnp.asarray(next(jit)))
    monkeypatch.setattr(benchmark, "sample_homography",
                        lambda gen, shape, c: torch.from_numpy(next(tit).copy()))
    jfe, tfe = _frontends()
    want = jax_benchmark.evaluate_pairs(jfe, want_imgs, cfg)
    got = benchmark.evaluate_pairs(tfe, got_imgs, HomographyConfig(**MILD))
    assert got["pairs"] == n
    _assert_aggregates_close(got, want)
