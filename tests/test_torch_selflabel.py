"""PyTorch port parity: self-labeling by homography adaptation against the
JAX package, on the CPU.

Random draws cannot repeat `jax.random`'s, so both sides get the same
warps: the JAX sampler is patched (``monkeypatch``) to return a fixed table
(shared warps for one key; for per-item raw ``uint32[2]`` keys, the row the
key's second word names), and the port's deterministic core
`_adapt_with_homographies` takes the same table.  Every JAX function runs
under a fresh ``jax.jit``, so no cached trace keeps an unpatched sampler.

Tolerances: elementwise ``prob_fn``s agree to atol 1e-5 (the same float32
arithmetic in another order); with the model (float32 on both sides, the
same random weights) prob maps to atol 1e-5 + rtol 1e-4, the oneDNN
tolerance of the serving tests; keypoints from the same aggregated map,
the batch-composition invariance, the BMP reader and the shard union
exactly; ``ratio_preserving_crop`` within 1 LSB of ``cv2`` (OpenCV's
``INTER_LINEAR`` on uint8 uses 11-bit fixed-point weights).
"""

import functools
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.config import HomographyConfig as JaxHomographyConfig
from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
from feature_point_cnn_tpu.data.datasets import read_npz_item as jax_read_npz_item
from feature_point_cnn_tpu.geometry.homography import (
    sample_homography_batch as jax_sample_homography_batch,
)
from feature_point_cnn_tpu.inference.wrapper import SuperPointFrontend as JaxFrontend
from feature_point_cnn_tpu.selflabel import adaptation as jax_adaptation
from feature_point_cnn_tpu.utils.image import (
    ratio_preserving_crop as jax_ratio_preserving_crop,
)

from chip_smoke import polygon_scene, write_bmp
from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
from feature_point_cnn_tpu_torch.data.datasets import read_npz_item
from feature_point_cnn_tpu_torch.inference import wrapper as torch_wrapper
from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
from feature_point_cnn_tpu_torch.ops.detection import decode_prob_map
from feature_point_cnn_tpu_torch.selflabel import adaptation as torch_adaptation
from feature_point_cnn_tpu_torch.selflabel.adaptation import (
    _adapt_with_homographies,
    _is_per_item_keys,
    homography_adaptation,
)
from feature_point_cnn_tpu_torch.selflabel.coco import (
    item_generator,
    load_and_crop,
    preprocess_folder,
)
from feature_point_cnn_tpu_torch.utils.image import (
    ratio_preserving_crop,
    read_bmp,
    read_rgb,
)
from feature_point_cnn_tpu_torch.utils.weights import jax_variables_from_state_dict

H, W, B, N = 48, 64, 2, 3
KW = dict(train_image_size=(H, W), descriptor_dim=32, compute_dtype="float32",
          max_keypoints=64)
HOMO = dict(num=N, valid_border_margin=4)


@functools.lru_cache(maxsize=None)
def _warp_tables():
    """Shared ``(N, 8)`` and per-item ``(B, N, 8)`` warps from the JAX
    sampler's own family."""
    cfg = JaxHomographyConfig(**HOMO)
    sample = jax.jit(lambda k: jax_sample_homography_batch(k, N, (H, W), cfg))
    shared = sample(jax.random.PRNGKey(1))
    per_item = jax.vmap(sample)(jax.random.split(jax.random.PRNGKey(2), B))
    return np.asarray(shared), np.asarray(per_item)


def _patch_jax_sampler(monkeypatch, per_item: bool):
    """The JAX sampler returns the fixed table; returns the key that selects
    it and the port's ``hs`` (``(N, 8)`` or ``(N, B, 8)``)."""
    shared, table = _warp_tables()
    if per_item:
        monkeypatch.setattr(jax_adaptation, "sample_homography_batch",
                            lambda key, n, shape, cfg: jnp.asarray(table)[key[1]])
        keys = jnp.stack([jnp.zeros(B, jnp.uint32), jnp.arange(B, dtype=jnp.uint32)], -1)
        return keys, torch.from_numpy(table.copy()).transpose(0, 1)
    monkeypatch.setattr(jax_adaptation, "sample_homography_batch",
                        lambda key, n, shape, cfg: jnp.asarray(shared))
    return jax.random.PRNGKey(0), torch.from_numpy(shared.copy())


def _images(b=B, seed=0):
    rng = np.random.default_rng(seed)
    gray = np.stack([polygon_scene(rng, H, W, n_polygons=8) for _ in range(b)])
    return np.repeat(gray[..., None], 3, axis=-1)


def _jax_prob_fn(x):
    return jnp.mean(x, axis=-1) * 0.5 + 0.1 * x[..., 0] * x[..., 1]


def _torch_prob_fn(x):
    return x.mean(-1) * 0.5 + 0.1 * x[..., 0] * x[..., 1]


@pytest.mark.parametrize("per_item", [False, True], ids=["shared", "per_item"])
@pytest.mark.parametrize("aggregation", ["sum", "max"])
def test_core_matches_jax_with_elementwise_prob_fn(monkeypatch, aggregation, per_item):
    key, hs = _patch_jax_sampler(monkeypatch, per_item)
    assert jax_adaptation._is_per_item_keys(key) == per_item
    jcfg = JaxHomographyConfig(aggregation=aggregation, **HOMO)
    imgs = _images()
    adapt = jax.jit(jax_adaptation.homography_adaptation, static_argnums=(2, 3))
    want = np.asarray(adapt(key, jnp.asarray(imgs), _jax_prob_fn, jcfg))
    got = _adapt_with_homographies(
        torch.from_numpy(imgs), hs, _torch_prob_fn,
        HomographyConfig(aggregation=aggregation, **HOMO)).numpy()
    assert got.shape == (B, H, W)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (want > 0).mean() > 0.5


def _frontends():
    """A fresh JAX frontend (its own jit cache) and the port's, with the
    same random float32 weights: the port's seeded LeCun-normal draw,
    carried to the JAX layout."""
    tfe = SuperPointFrontend(SuperPointConfig(**KW), seed=3, device="cpu")
    variables = jax_variables_from_state_dict(tfe.model.state_dict())
    jfe = JaxFrontend(JaxConfig(**KW), variables=jax.tree_util.tree_map(jnp.asarray, variables))
    return jfe, tfe


@pytest.mark.parametrize("per_item", [False, True], ids=["shared", "per_item"])
@pytest.mark.parametrize("aggregation", ["sum", "max"])
def test_adaptation_fn_matches_jax_with_the_model(monkeypatch, aggregation, per_item):
    """The frontend's `adaptation_fn` on given warps: on the CPU its
    probability map is the decode kernel's plain version at threshold 0,
    which is the raw decoded map itself."""
    key, hs = _patch_jax_sampler(monkeypatch, per_item)
    monkeypatch.setattr(torch_adaptation, "sample_warps", lambda *a: hs)
    jfe, tfe = _frontends()
    jcfg = JaxHomographyConfig(aggregation=aggregation, **HOMO)
    imgs = _images(seed=1)
    want = np.asarray(jfe._adapt(jfe.variables, jnp.asarray(imgs), key, homo_config=jcfg))
    x = torch.from_numpy(imgs)
    with torch.inference_mode():
        got = torch_wrapper.adaptation_fn(
            tfe.model, x, None, tfe.config,
            HomographyConfig(aggregation=aggregation, **HOMO)).numpy()
        prob = torch_wrapper.adaptation_prob_fn(tfe.model, tfe.config)(x)
        raw = decode_prob_map(tfe.model.features(x, enable_descriptor=False)[0],
                              tfe.config.cell)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    assert torch.equal(prob, raw)


def test_per_item_generators_make_labels_independent_of_batch_composition():
    """Each image's result is a function of its own generator alone, bit
    for bit, under split and interleaved groupings."""
    imgs = torch.from_numpy(_images(6, seed=2))
    cfg = HomographyConfig(**HOMO)

    def run(idx):
        return homography_adaptation([item_generator(7, i) for i in idx], imgs[idx],
                                     _torch_prob_fn, cfg)

    full = run(list(range(6)))
    split = torch.cat([run([0, 1, 2, 3]), run([4, 5])])
    assert torch.equal(full, split)
    mix = torch.zeros_like(full)
    mix[0::2], mix[1::2] = run([0, 2, 4]), run([1, 3, 5])
    assert torch.equal(full, mix)
    # per-item generators really differ from the shared semantics
    assert _is_per_item_keys([item_generator(7, 0)])
    assert not _is_per_item_keys(item_generator(7, 0))
    shared = homography_adaptation(item_generator(7, 0), imgs, _torch_prob_fn, cfg)
    assert not torch.equal(full, shared)


def test_run_with_homography_adaptation_points_equal_jax_on_its_map(monkeypatch):
    """Given JAX's aggregated map, the port's NMS + top-K give exactly the
    JAX frontend's ``(3, N)`` point arrays."""
    key, _ = _patch_jax_sampler(monkeypatch, per_item=True)
    jfe, tfe = _frontends()
    jcfg = JaxHomographyConfig(**HOMO)
    imgs = _images(seed=4)
    jmap = np.asarray(jfe._adapt(jfe.variables, jnp.asarray(imgs), key, homo_config=jcfg))
    want = jfe.run_with_homography_adaptation(imgs, jcfg, key)
    monkeypatch.setattr(torch_wrapper, "adaptation_fn",
                        lambda *a, **k: torch.from_numpy(jmap))
    got = tfe.run_with_homography_adaptation(imgs, HomographyConfig(**HOMO),
                                             [item_generator(0, i) for i in range(B)])
    assert len(got) == B
    for g, w in zip(got, want):
        assert g.shape[0] == 3 and g.shape[1] > 0
        np.testing.assert_array_equal(g, np.asarray(w))


def test_run_with_homography_adaptation_returns_points_on_the_cpu():
    _, tfe = _frontends()
    pts = tfe.run_with_homography_adaptation(
        _images(seed=5), HomographyConfig(**HOMO), torch.Generator().manual_seed(0))
    for p in pts:
        assert p.shape[0] == 3 and p.shape[1] > 0 and np.isfinite(p).all()
        assert (p[0] >= 0).all() and (p[0] < W).all() and (p[1] < H).all()


@pytest.mark.parametrize("src_hw", [(60, 80), (61, 97), (37, 29), (48, 64)])
def test_ratio_preserving_crop_matches_cv2(src_hw):
    rng = np.random.default_rng(sum(src_hw))
    u8 = cv2.GaussianBlur(rng.integers(0, 256, src_hw + (3,), dtype=np.uint8), (3, 3), 1)
    got = ratio_preserving_crop(u8, (H, W))
    want = jax_ratio_preserving_crop(u8, (H, W))
    assert got.dtype == np.uint8 and got.shape == want.shape == (H, W, 3)
    assert np.abs(got.astype(int) - want).max() <= 1
    f32 = u8.astype(np.float32) / 255.0
    np.testing.assert_allclose(ratio_preserving_crop(f32, (H, W)),
                               jax_ratio_preserving_crop(f32, (H, W)), atol=1e-4)


@pytest.mark.parametrize("width", [1, 2, 3, 5, 64])
def test_bmp_reader_matches_cv2(tmp_path, width):
    rng = np.random.default_rng(width)
    img = rng.integers(0, 256, (7, width, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "a.bmp"), img)              # BGR on disk
    np.testing.assert_array_equal(read_bmp(tmp_path / "a.bmp"), img[..., ::-1])
    # the numpy writer of the smoke gives the file cv2 reads back
    write_bmp(tmp_path / "b.bmp", img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "b.bmp")), img[..., ::-1])


def test_formats_without_a_numpy_reader_name_the_file_when_cv2_is_missing(
        tmp_path, monkeypatch):
    path = tmp_path / "photo.png"
    cv2.imwrite(str(path), np.zeros((4, 4, 3), np.uint8))
    assert read_rgb(path).shape == (4, 4, 3)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="photo.png"):
        read_rgb(path)
    with pytest.raises(ImportError, match="photo.png"):
        load_and_crop(str(path), (H, W))


@pytest.fixture(scope="module")
def bmp_folder(tmp_path_factory):
    """Seven BMP scenes written by cv2, of two sizes."""
    d = tmp_path_factory.mktemp("bmps")
    rng = np.random.default_rng(8)
    for i in range(7):
        h, w = (60, 80) if i % 2 else (72, 88)
        g = (polygon_scene(rng, h, w, n_polygons=8) * 255).round().astype(np.uint8)
        rgb = np.stack([g, np.roll(g, 1, 0), g[:, ::-1]], -1)
        cv2.imwrite(str(d / f"img_{i:02d}.bmp"), rgb[..., ::-1])
    return d


def _read_items(d):
    return {p.name: dict(np.load(p)) for p in sorted(d.glob("*.npz"))}


def test_preprocess_folder_shards_resume_and_item_format(bmp_folder, tmp_path, capsys):
    _, tfe = _frontends()
    homo = HomographyConfig(**HOMO)
    single = tmp_path / "single"
    assert preprocess_folder(tfe, str(bmp_folder), str(single), homo,
                             batch_size=2, seed=5) == 7
    items = _read_items(single)
    assert len(items) == 7
    for name, item in items.items():
        assert item["image"].shape == (3, H, W) and item["image"].dtype == np.float32
        assert item["points"].shape[0] == 3 and item["points"].shape[1] > 0
        want = load_and_crop(str(bmp_folder / name.replace(".npz", ".bmp")), (H, W))
        np.testing.assert_array_equal(item["image"], want.transpose(2, 0, 1))
        for read in (read_npz_item, jax_read_npz_item):
            image, pts = read(str(single / name))
            assert image.shape == (H, W, 3)
            np.testing.assert_array_equal(pts, item["points"][1::-1].T)

    # shards 0/2 and 1/2 at the same batch size give the single run's labels
    sharded = tmp_path / "sharded"
    n = [preprocess_folder(tfe, str(bmp_folder), str(sharded), homo, batch_size=2,
                           seed=5, shard_index=k, num_shards=2) for k in (0, 1)]
    assert n == [4, 3]
    shard_items = _read_items(sharded)
    assert shard_items.keys() == items.keys()
    for name in items:
        for f in ("image", "points"):
            np.testing.assert_array_equal(shard_items[name][f], items[name][f])

    # resume: written items stay untouched, the rest are labelled as before
    for name in ("img_01.npz", "img_04.npz"):
        os.remove(sharded / name)
    before = {p.name: (p.stat().st_mtime_ns, p.read_bytes()) for p in sharded.glob("*.npz")}
    assert preprocess_folder(tfe, str(bmp_folder), str(sharded), homo,
                             batch_size=2, seed=5) == 2
    assert "resume: 5/7" in capsys.readouterr().out
    for p in sharded.glob("*.npz"):
        if p.name in before:
            assert (p.stat().st_mtime_ns, p.read_bytes()) == before[p.name]
    resumed = _read_items(sharded)
    for name in items:
        np.testing.assert_array_equal(resumed[name]["points"], items[name]["points"])
