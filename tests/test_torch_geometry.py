"""PyTorch port parity: homography algebra, warping, valid masks and the
augmentation against the JAX package, on the CPU.

The same numpy inputs go through both sides.  Tolerances: the algebra and
the point warps agree to rtol 1e-5 + atol 1e-4 px (a 3x3 inverse in float32
on both sides, by different LAPACK paths); image warps and masks are
gathers and compares on the same float32 positions and agree exactly,
except where a source position falls within float rounding of a pixel
boundary (atol 1e-5 on bilinear values, <= 0.1% of mask pixels).  Random
draws cannot equal `jax.random`'s, so the sampler is held to its invariants
and the augmentation is compared on a homography sampled by JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.config import HomographyConfig as JaxHomographyConfig
from feature_point_cnn_tpu.geometry import homography as jh
from feature_point_cnn_tpu.geometry import warp as jw

from feature_point_cnn_tpu_torch.config import HomographyConfig
from feature_point_cnn_tpu_torch.geometry import homography as th
from feature_point_cnn_tpu_torch.geometry import warp as tw

H, W = 48, 64
HOMOGS = np.array([
    [1.02, 0.01, 3.0, -0.02, 0.98, -2.0, 1e-4, -1e-4],
    [0.9, 0.1, -1.0, 0.05, 1.1, 2.0, 2e-4, 1e-4],
    [1.0, 0.0, 8.0, 0.0, 1.0, -8.0, 0.0, 0.0],
], np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_sampled(n, seed=0, config=JaxHomographyConfig()):
    return np.asarray(jh.sample_homography_batch(
        jax.random.PRNGKey(seed), n, (H, W), config))


def test_config_matches_jax_defaults():
    import dataclasses

    from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
    from feature_point_cnn_tpu_torch.config import SuperPointConfig

    jd = dataclasses.asdict(JaxHomographyConfig())
    assert dataclasses.asdict(HomographyConfig()) == jd
    assert (dataclasses.asdict(HomographyConfig.for_preprocess())
            == dataclasses.asdict(JaxHomographyConfig.for_preprocess()))
    jc, tc = dataclasses.asdict(JaxConfig()), dataclasses.asdict(SuperPointConfig())
    shared = set(jc) & set(tc)
    assert {"lambda_d", "batch_size", "warmup_steps", "microbatch_steps",
            "max_points", "photometric_augment", "train_image_size"} <= shared
    assert {k: tc[k] for k in shared} == {k: jc[k] for k in shared}
    # the serving frame's detector family and matcher (SuperGlue is the
    # port's alone), and what the port leaves out on purpose: the kernel
    # gates (the tensor's device picks) and the TPU-only fields
    assert set(tc) - set(jc) == {"backbone", "matcher", "superglue"}
    assert set(jc) - set(tc) == {
        "use_pallas_decode", "use_pallas_nms", "use_pallas_desc_loss",
        "stem_s2d", "grid_channels"}
    assert {"fold_bn", "train_steps_per_call", "data_axis"} <= shared


def test_flat_algebra_matches_jax():
    h = HOMOGS
    np.testing.assert_array_equal(th.flat2mat(_t(h)).numpy(),
                                  np.asarray(jh.flat2mat(jnp.asarray(h))))
    m = np.random.default_rng(0).standard_normal((4, 3, 3)).astype(np.float32) + 2 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(th.mat2flat(_t(m)).numpy(),
                               np.asarray(jh.mat2flat(jnp.asarray(m))), rtol=1e-6)
    np.testing.assert_allclose(
        th.invert_homography(_t(h)).numpy(),
        np.asarray(jh.invert_homography(jnp.asarray(h))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        th.compose_homographies(_t(h), _t(h[::-1].copy())).numpy(),
        np.asarray(jh.compose_homographies(jnp.asarray(h), jnp.asarray(h[::-1]))),
        rtol=1e-5, atol=1e-6)
    # compose with the inverse is the identity
    ident = th.compose_homographies(_t(h), th.invert_homography(_t(h))).numpy()
    np.testing.assert_allclose(ident, np.tile([1, 0, 0, 0, 1, 0, 0, 0], (3, 1)),
                               atol=1e-4)


@pytest.mark.parametrize("batched", [False, True], ids=["one_h", "batch_h"])
def test_warp_points_and_in_image_mask_match_jax(batched):
    pts = (np.random.default_rng(1).random((20, 2)) * [H, W] * 1.4 - 5).astype(np.float32)
    h = HOMOGS if batched else HOMOGS[0]
    want = np.asarray(jh.warp_points(jnp.asarray(pts), jnp.asarray(h)))
    got = th.warp_points(_t(pts), _t(h))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        th.points_in_image_mask(_t(want), (H, W)).numpy(),
        np.asarray(jh.points_in_image_mask(jnp.asarray(want), (H, W))))
    if batched:   # per-item point sets, as the batched augmentation uses them
        per_item = np.stack([pts, pts[::-1], pts * 0.5])
        each = th.warp_points(_t(per_item), _t(h)).numpy()
        for i in range(3):
            np.testing.assert_allclose(
                each[i], np.asarray(jh.warp_points(jnp.asarray(per_item[i]),
                                                   jnp.asarray(h[i]))),
                rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_warp_image_matches_jax(mode):
    img = np.random.default_rng(2).random((3, H, W, 3)).astype(np.float32)
    hs = np.concatenate([HOMOGS[:2], _jax_sampled(1, seed=4)])
    want = np.stack([np.asarray(jw.warp_image(jnp.asarray(img[i]),
                                              jnp.asarray(hs[i]), mode))
                     for i in range(3)])
    got = tw.warp_image(_t(img), _t(hs), mode).numpy()
    if mode == "bilinear":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert (got != want).mean() <= 1e-3
    one = tw.warp_image(_t(img[0]), _t(hs[0]), mode).numpy()
    np.testing.assert_array_equal(one, got[0])
    with pytest.raises(ValueError):
        tw.warp_image(_t(img), _t(hs), "cubic")


def test_nearest_sample_rounds_half_to_even():
    img = np.arange(12, dtype=np.float32).reshape(1, 3, 4, 1)
    yx = np.array([[[0.5, 0.5], [1.5, 2.5], [2.5, 1.5], [-0.5, 0.0], [1.0, 3.5]]],
                  np.float32)
    want = np.asarray(jw.nearest_sample(jnp.asarray(img[0]), jnp.asarray(yx[0])))
    got = tw.nearest_sample(_t(img), _t(yx)).numpy()[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], [0.0, 10.0, 10.0, 0.0, 0.0])


@pytest.mark.parametrize("radius", [0, 1, 3, 8])
def test_erode_and_ellipse_match_jax(radius):
    rng = np.random.default_rng(3)
    mask = (rng.random((2, H, W)) > 0.02).astype(np.float32)
    mask[0, 10:30, 20:50] = 1.0
    if radius:
        np.testing.assert_array_equal(th.ellipse_kernel(radius),
                                      jh.ellipse_kernel(radius))
    want = np.asarray(jh.erode(jnp.asarray(mask), radius))
    np.testing.assert_array_equal(th.erode(_t(mask), radius).numpy(), want)
    np.testing.assert_array_equal(th.erode(_t(mask[0]), radius).numpy(), want[0])


def test_compute_valid_mask_matches_jax():
    hs = np.concatenate([HOMOGS, _jax_sampled(3, seed=1)])
    for margin in (0, 8):
        want = np.stack([np.asarray(jh.compute_valid_mask((H, W), jnp.asarray(h), margin))
                         for h in hs])
        got = th.compute_valid_mask((H, W), _t(hs), margin).numpy()
        assert got.shape == (len(hs), H, W)
        assert (got != want).mean() <= 1e-3
        one = th.compute_valid_mask((H, W), _t(hs[0]), margin).numpy()
        np.testing.assert_array_equal(one, got[0])


def test_augmentation_given_jax_sampled_homography_matches_jax():
    rng = np.random.default_rng(5)
    b, p = 3, 12
    imgs = rng.random((b, H, W, 3)).astype(np.float32)
    pts = (rng.random((b, p, 2)) * [H, W]).astype(np.float32)
    valid = rng.random((b, p)) > 0.25
    cfg = JaxHomographyConfig()
    keys = jax.random.split(jax.random.PRNGKey(7), b)
    want = jax.vmap(jh.homographic_augmentation, in_axes=(0, 0, 0, 0, None))(
        keys, jnp.asarray(imgs), jnp.asarray(pts), jnp.asarray(valid), cfg)
    h_flat = np.asarray(want[4])
    got = th.homographic_augmentation_batch(
        None, _t(imgs), _t(pts), _t(valid), HomographyConfig(), h_flat=_t(h_flat))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-3)
    near_edge = np.abs(np.asarray(want[1]) - np.round(np.asarray(want[1]))).min(-1) < 1e-3
    agree = got[2].numpy() == np.asarray(want[2])
    assert (agree | near_edge).all()
    assert (got[3].numpy() != np.asarray(want[3])).mean() <= 1e-3
    np.testing.assert_array_equal(got[4].numpy(), h_flat)
    one = th.homographic_augmentation(None, _t(imgs[0]), _t(pts[0]), _t(valid[0]),
                                      HomographyConfig(), h_flat=_t(h_flat[0]))
    np.testing.assert_array_equal(one[0].numpy(), got[0][0].numpy())


@pytest.mark.parametrize("preset", ["default", "preprocess", "no_families"])
def test_sample_homography_invariants(preset):
    """The patch stays in bounds (without artifacts), h22 = 1 by
    construction, items differ, and a generator seed fixes the draw."""
    cfg = {"default": HomographyConfig(),
           "preprocess": HomographyConfig.for_preprocess(),
           "no_families": HomographyConfig(perspective=False, scaling=False,
                                           rotation=False, translation=False)}[preset]
    n = 64
    hs = th.sample_homography_batch(torch.Generator().manual_seed(3), n, (H, W), cfg,
                                    device="cpu")
    again = th.sample_homography_batch(torch.Generator().manual_seed(3), n, (H, W), cfg)
    other = th.sample_homography_batch(torch.Generator().manual_seed(4), n, (H, W), cfg)
    assert hs.shape == (n, 8) and hs.dtype == torch.float32
    assert torch.isfinite(hs).all()
    assert torch.equal(hs, again)
    one = th.sample_homography(torch.Generator().manual_seed(3), (H, W), cfg)
    assert one.shape == (8,)
    # the homography maps the output's patch corners to the input patch:
    # pts1 -> pts2 in pixels, so pts2 = H(pts1) must lie in the image
    margin = (1 - cfg.patch_ratio) / 2
    unit = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)
    pts1 = (margin + cfg.patch_ratio * unit) * [W, H]
    pts2 = tw.apply_flat_homography(hs, _t(pts1.astype(np.float32))).numpy()
    if preset == "no_families":
        np.testing.assert_allclose(hs.numpy(), np.tile([1, 0, 0, 0, 1, 0, 0, 0], (n, 1)),
                                   atol=1e-4)
        return
    assert not torch.equal(hs, other)
    assert len({tuple(np.round(h, 4)) for h in hs.numpy()}) == n   # distinct per item
    if not cfg.allow_artifacts:
        assert (pts2 >= -1e-2).all()
        assert (pts2[..., 0] <= W + 1e-2).all() and (pts2[..., 1] <= H + 1e-2).all()
    # the same family as JAX's sampler: compare the spread of the patch's
    # area ratio, a scale-free summary (loose: 64 draws a side)
    def area(q):
        x, y = q[..., 0], q[..., 1]
        return 0.5 * np.abs((x * np.roll(y, -1, -1) - np.roll(x, -1, -1) * y).sum(-1))
    jcfg = (JaxHomographyConfig() if preset == "default"
            else JaxHomographyConfig.for_preprocess())
    jhs = _jax_sampled(n, seed=11, config=jcfg)
    jpts2 = np.stack([np.asarray(jw.apply_flat_homography(jnp.asarray(h), jnp.asarray(pts1, jnp.float32)))
                      for h in jhs])
    ratio_t, ratio_j = area(pts2) / area(pts1), area(jpts2) / area(pts1)
    assert abs(ratio_t.mean() - ratio_j.mean()) < 0.1
    assert abs(ratio_t.std() - ratio_j.std()) < 0.1
