"""PyTorch port parity: two-view geometry and the evaluation harness
against the JAX package, on the CPU.

RANSAC's draws cannot repeat `jax.random`'s, so each package's estimate is
held to the truth (corner error < 0.05 px on exact correspondences) rather
than to the other's; everything else is compared directly.  Tolerances:
the weighted DLT to rtol 1e-4 (float32 normal equations, ``eigh`` in
another library); `sim2_from_homography` and `hpatches_flat_homography` to
1e-6; repeatability and matching metrics exactly on the same keypoints,
except ``homography_error`` (RANSAC) and cv2's corner error to 1e-4 px
(each side warps the true corners in float32); the harnesses' aggregates within
1e-3 with the released float32 weights on both sides and the same
homographies (the JAX sampler and the port's patched to one list); image
reads exactly equal to ``cv2``, ``load_image`` within 1/255 (``INTER_AREA``
sums in float32 inside OpenCV).  JAX's RANSAC runs under ``jax.jit`` here
only to keep the tests short.
"""

import functools
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.config import HomographyConfig as JaxHomographyConfig
from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
from feature_point_cnn_tpu.eval import benchmark as jax_benchmark
from feature_point_cnn_tpu.eval import hpatches as jax_hpatches
from feature_point_cnn_tpu.eval import metrics as jax_metrics
from feature_point_cnn_tpu.geometry.homography import sample_homography as jax_sample_homography
from feature_point_cnn_tpu.inference.wrapper import SuperPointFrontend as JaxFrontend
from feature_point_cnn_tpu.ops.detection import Keypoints as JaxKeypoints
from feature_point_cnn_tpu.slam import twoview as jax_twoview
from tests.test_torch_model import released_jax_variables

from chip_smoke import exact_correspondences, polygon_scene, write_ppm
from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
from feature_point_cnn_tpu_torch.eval import benchmark
from feature_point_cnn_tpu_torch.eval import hpatches
from feature_point_cnn_tpu_torch.eval.metrics import matching_metrics, repeatability
from feature_point_cnn_tpu_torch.geometry.homography import warp_points
from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
from feature_point_cnn_tpu_torch.ops.detection import Keypoints
from feature_point_cnn_tpu_torch.slam import twoview
from feature_point_cnn_tpu_torch.utils.image import read_gray, read_pnm
from feature_point_cnn_tpu_torch.utils.weights import released_path

CORNERS = np.array([[0, 0], [0, 319], [239, 319], [239, 0]], np.float32)
MILD = dict(patch_ratio=0.8, max_angle=np.pi / 6)
RANSAC_KEYS = ("homography_error",)


@pytest.fixture(autouse=True)
def _jitted_jax_ransac(monkeypatch):
    monkeypatch.setattr(jax_metrics, "ransac_homography", jax.jit(
        jax_twoview.ransac_homography, static_argnames=("iters", "inlier_thresh")))


def _corner_error(h_est, h_true) -> float:
    c = torch.from_numpy(CORNERS)
    est = warp_points(c, torch.as_tensor(np.asarray(h_est, np.float32)))
    return float((est - warp_points(c, torch.from_numpy(h_true))).norm(dim=-1).mean())


def test_dlt_matches_jax():
    p1, p2, _, _ = exact_correspondences(1)
    w = np.random.default_rng(1).random(len(p1)).astype(np.float32)
    src, dst = np.ascontiguousarray(p1[:, ::-1]), np.ascontiguousarray(p2[:, ::-1])
    got = twoview._dlt_homography(torch.from_numpy(src), torch.from_numpy(dst),
                                  torch.from_numpy(w)).numpy()
    want = np.asarray(jax_twoview._dlt_homography(jnp.asarray(src), jnp.asarray(dst),
                                                  jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    # batched hypotheses solve like single ones
    batch = twoview._dlt_homography(torch.from_numpy(np.stack([src, dst])),
                                    torch.from_numpy(np.stack([dst, src])),
                                    torch.from_numpy(np.stack([w, w])))
    np.testing.assert_allclose(batch[0].numpy(), got, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_recovers_exact_correspondences_in_both_packages(seed):
    p1, p2, valid, h_true = exact_correspondences(seed)
    est = twoview.ransac_homography(torch.Generator().manual_seed(seed),
                                    torch.from_numpy(p1), torch.from_numpy(p2),
                                    torch.from_numpy(valid))
    jest = jax.jit(jax_twoview.ransac_homography)(
        jax.random.PRNGKey(seed), jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid))
    assert _corner_error(est.h_flat.numpy(), h_true) < 0.05
    assert _corner_error(np.asarray(jest.h_flat), h_true) < 0.05
    # every exact correspondence is an inlier, in both
    assert int(est.num_inliers) == int(jest.num_inliers)
    assert est.inliers.shape == (len(p1),) and est.inliers.dtype == torch.bool


def test_ransac_with_three_valid_matches_keeps_its_shapes_and_no_invalid_inlier():
    p1, p2, valid, _ = exact_correspondences(3, k=16)
    valid[3:] = False
    est = twoview.ransac_homography(torch.Generator().manual_seed(0),
                                    torch.from_numpy(p1), torch.from_numpy(p2),
                                    torch.from_numpy(valid), iters=8)
    assert est.h_flat.shape == (8,) and not est.inliers[3:].any()


def test_sim2_from_homography_matches_jax():
    for h in (exact_correspondences(0)[3],
              np.array([0.9, -0.3, 5.0, 0.35, 1.1, -2.0, 1e-4, 2e-4], np.float32)):
        got = twoview.sim2_from_homography(torch.from_numpy(h)).numpy()
        want = np.asarray(jax_twoview.sim2_from_homography(jnp.asarray(h)))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def _keypoint_pair(seed, k=64, shape=(240, 320), noise=1.2):
    """Both packages' ``Keypoints`` for a view-1 set and its view-2 images
    under ``h_flat`` (some jittered, some replaced), with descriptors that
    match the corresponding points."""
    rng = np.random.default_rng(seed)
    _, _, _, h_flat = exact_correspondences(seed)
    n = k - 8
    p1 = rng.uniform([4, 4], [shape[0] - 4, shape[1] - 4], (n, 2)).astype(np.float32)
    p2 = warp_points(torch.from_numpy(p1), torch.from_numpy(h_flat)).numpy()
    p2[: n // 4] += rng.normal(0, noise, (n // 4, 2)).astype(np.float32)
    p2[-6:] = rng.uniform([0, 0], shape, (6, 2))
    d = rng.standard_normal((n, 32)).astype(np.float32)
    d1 = d / np.linalg.norm(d, axis=-1, keepdims=True)
    d2 = d1 + 0.05 * rng.standard_normal(d1.shape).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    perm = rng.permutation(n)            # view 2 lists its points in another order

    def pad(a, fill=0.0):
        return np.concatenate([a, np.full((k - n,) + a.shape[1:], fill, a.dtype)])[None]

    sets = []
    for pts, desc in ((p1, d1), (p2[perm], d2[perm])):
        y, x = pad(pts[:, 0]), pad(pts[:, 1])
        score = pad(np.linspace(0.9, 0.1, n).astype(np.float32))
        valid = pad(np.ones(n, bool), False)
        sets.append((Keypoints(*(torch.from_numpy(a) for a in (y, x, score, valid))),
                     JaxKeypoints(*(jnp.asarray(a) for a in (y, x, score, valid))),
                     pad(desc)))
    return sets, h_flat


def test_repeatability_equals_jax_on_the_same_keypoints():
    for seed in range(3):
        ((tk1, jk1, _), (tk2, jk2, _)), h = _keypoint_pair(seed)
        got = repeatability(tk1, tk2, h, (240, 320))
        want = jax_metrics.repeatability(jk1, jk2, h, (240, 320))
        assert got.keys() == want.keys()
        assert got["repeatability"] == want["repeatability"]
        assert got["num_shared"] == want["num_shared"]
        assert got["localization_error"] == pytest.approx(want["localization_error"], abs=1e-5)
        assert 0.3 < got["repeatability"] < 1.0


def test_matching_metrics_equal_jax_but_for_ransac():
    for seed in range(2):
        ((tk1, jk1, d1), (tk2, jk2, d2)), h = _keypoint_pair(seed, noise=0.0)
        got = matching_metrics(tk1, torch.from_numpy(d1), tk2, torch.from_numpy(d2),
                               h, (240, 320), nn_thresh=0.7)
        want = jax_metrics.matching_metrics(jk1, jnp.asarray(d1), jk2, jnp.asarray(d2),
                                            h, (240, 320), nn_thresh=0.7)
        assert got.keys() == want.keys()
        for key in got:
            if key not in RANSAC_KEYS:
                # the corner error's true corners are a float32 warp each side
                tol = 1e-4 if key == "homography_error_cv2" else 1e-6
                assert got[key] == pytest.approx(want[key], abs=tol), key
        assert got["homography_error"] < 0.05 and want["homography_error"] < 0.05
        assert got["homography_correct"] == want["homography_correct"] == 1.0
        assert got["num_matches"] >= 40


def test_homography_error_cv2_is_nan_without_cv2(monkeypatch):
    import sys

    ((tk1, _, d1), (tk2, _, d2)), h = _keypoint_pair(0, noise=0.0)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = matching_metrics(tk1, torch.from_numpy(d1), tk2, torch.from_numpy(d2),
                           h, (240, 320))
    assert np.isnan(got["homography_error_cv2"]) and got["homography_error"] < 0.05


@functools.lru_cache(maxsize=None)
def _frontends(k=128):
    jfe = JaxFrontend(JaxConfig(compute_dtype="float32", max_keypoints=k),
                      variables=released_jax_variables())
    tfe = SuperPointFrontend(SuperPointConfig(compute_dtype="float32", max_keypoints=k),
                             weights_path=released_path(), device="cpu")
    return jfe, tfe


def _assert_aggregates_close(got, want):
    assert got.keys() == want.keys()
    for key in got:
        if key in RANSAC_KEYS:
            continue
        if np.isnan(want[key]):
            assert np.isnan(got[key]), key
        else:
            assert got[key] == pytest.approx(want[key], abs=1e-3), key


def test_evaluate_pairs_matches_jax_on_the_same_homographies(monkeypatch):
    h, w, n = 64, 96, 3
    cfg = JaxHomographyConfig(**MILD)
    sample = jax.jit(lambda key: jax_sample_homography(key, (h, w), cfg))
    hs = [np.asarray(sample(jax.random.PRNGKey(10 + i))) for i in range(n)]
    jit, tit = iter(hs), iter(hs)
    monkeypatch.setattr(jax_benchmark, "sample_homography",
                        lambda key, shape, c: jnp.asarray(next(jit)))
    monkeypatch.setattr(benchmark, "sample_homography",
                        lambda gen, shape, c: torch.from_numpy(next(tit).copy()))
    rng = np.random.default_rng(0)
    imgs = [np.repeat(polygon_scene(rng, h, w, n_polygons=12)[..., None], 3, -1)
            for _ in range(n)]
    jfe, tfe = _frontends()
    want = jax_benchmark.evaluate_pairs(jfe, imgs, cfg)
    got = benchmark.evaluate_pairs(tfe, imgs, HomographyConfig(**MILD))
    assert got["pairs"] == n and got["num_matches"] > 0
    _assert_aggregates_close(got, want)


def test_evaluate_pairs_samples_a_homography_per_pair_from_its_seed(monkeypatch):
    _, tfe = _frontends()
    img = np.repeat(polygon_scene(np.random.default_rng(1), 64, 96)[..., None], 3, -1)
    a = benchmark.evaluate_pairs(tfe, [img, img], HomographyConfig(**MILD), seed=3)
    b = benchmark.evaluate_pairs(tfe, [img, img], HomographyConfig(**MILD), seed=3)
    assert a == b and a["pairs"] == 2.0
    # the synthetic source draws with cv2: without it, an ImportError that
    # says so before any model is built
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        benchmark.main(["--source", "synthetic", "--device", "cpu"])


def test_pnm_reader_matches_cv2(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (13, 21, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "a.ppm"), img)                 # BGR on disk
    np.testing.assert_array_equal(read_pnm(tmp_path / "a.ppm"), img[..., ::-1])
    np.testing.assert_array_equal(read_gray(tmp_path / "a.ppm"),
                                  cv2.imread(str(tmp_path / "a.ppm"), cv2.IMREAD_GRAYSCALE))
    cv2.imwrite(str(tmp_path / "g.pgm"), img[..., 0])
    np.testing.assert_array_equal(read_pnm(tmp_path / "g.pgm"), img[..., 0])
    # the smoke's numpy writer gives the file cv2 reads back
    write_ppm(tmp_path / "b.ppm", img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "b.ppm")), img[..., ::-1])
    (tmp_path / "c.ppm").write_bytes(b"P6\n# a comment\n3 2\n255\n" + bytes(range(18)))
    np.testing.assert_array_equal(read_pnm(tmp_path / "c.ppm"),
                                  cv2.imread(str(tmp_path / "c.ppm"))[..., ::-1])


@pytest.mark.parametrize("src_hw", [(480, 640), (531, 777), (240, 320), (120, 160),
                                    (200, 300)])
def test_load_image_matches_jax(tmp_path, src_hw):
    rng = np.random.default_rng(src_hw[0])
    img = cv2.GaussianBlur(rng.integers(0, 256, src_hw + (3,), dtype=np.uint8), (5, 5), 1.5)
    cv2.imwrite(str(tmp_path / "1.ppm"), img)
    got, got_hw = hpatches.load_image(tmp_path / "1.ppm", (240, 320))
    want, want_hw = jax_hpatches.load_image(tmp_path / "1.ppm", (240, 320))
    assert got_hw == want_hw == src_hw and got.shape == want.shape == (240, 320, 3)
    assert np.abs(got - want).max() <= 1.0 / 255 + 1e-7


def test_hpatches_flat_homography_matches_jax():
    rng = np.random.default_rng(0)
    h_mat = np.eye(3) + rng.normal(0, 0.05, (3, 3))
    h_mat[2, 2] = 1.0
    args = (h_mat, (480, 640), (360, 480), (240, 320))
    np.testing.assert_allclose(hpatches.hpatches_flat_homography(*args),
                               jax_hpatches.hpatches_flat_homography(*args), atol=1e-6)


@pytest.fixture()
def hpatches_fixture(tmp_path):
    """The layout of `tests/test_hpatches.py`: an identity sequence, a
    viewpoint pair of another warp, and a directory that is no sequence."""
    rng = np.random.default_rng(7)
    base = (rng.uniform(0, 1, (120, 160)) * 255).astype(np.uint8)
    base = cv2.GaussianBlur(base, (5, 5), 1.5)
    d = tmp_path / "i_fake"
    d.mkdir()
    for k in range(1, 4):
        cv2.imwrite(str(d / f"{k}.ppm"), cv2.cvtColor(base, cv2.COLOR_GRAY2BGR))
        if k > 1:
            np.savetxt(d / f"H_1_{k}", np.eye(3))
    v = tmp_path / "v_fake"
    v.mkdir()
    h_mat = np.array([[1.0, 0.02, 8.0], [-0.015, 1.0, -5.0], [1e-5, -2e-5, 1.0]])
    cv2.imwrite(str(v / "1.ppm"), cv2.cvtColor(base, cv2.COLOR_GRAY2BGR))
    warped = cv2.warpPerspective(base, h_mat, (160, 120))
    cv2.imwrite(str(v / "2.ppm"), cv2.cvtColor(warped, cv2.COLOR_GRAY2BGR))
    np.savetxt(v / "H_1_2", h_mat)
    (tmp_path / "not_a_seq").mkdir()
    return tmp_path


def test_evaluate_hpatches_matches_jax(hpatches_fixture):
    names = [n for n, _ in hpatches.iter_sequences(str(hpatches_fixture))]
    assert names == ["i_fake", "v_fake"]
    jfe, tfe = _frontends()
    got = hpatches.evaluate_hpatches(tfe, str(hpatches_fixture), shape=(120, 160))
    want = jax_hpatches.evaluate_hpatches(jfe, str(hpatches_fixture), shape=(120, 160))
    ill = got["illumination"]
    assert ill["pairs"] == 2.0 and ill["repeatability"] == pytest.approx(1.0)
    assert ill["match_precision"] == pytest.approx(1.0)
    assert ill["localization_error"] == pytest.approx(0.0, abs=1e-5)
    assert got["viewpoint"]["pairs"] == 1.0 and got["overall"]["pairs"] == 3.0
    for split in ("overall", "illumination", "viewpoint"):
        _assert_aggregates_close(got[split], want[split])
