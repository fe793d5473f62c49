"""PyTorch port parity: label encoding, photometric stages and the F1
metric against the JAX package, on the CPU.

Labels are integer argmaxes of the same float32 sums given the same
tie-break noise: exactly equal.  `scale_valid_map`, `samplewise_f1` and
`make_prob_map_from_labels`: exact (0/1 arithmetic and small means).  The
photometric stages are float32 elementwise or 9-tap sums in another order:
atol 1e-6.  The JAX stages draw their own random values from a key; the
test recovers those values with the same `jax.random` calls and hands them
to the port's stages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.data import photometric as jp
from feature_point_cnn_tpu.ops import labels as jl
from feature_point_cnn_tpu.utils.metrics import samplewise_f1 as jax_f1

from feature_point_cnn_tpu_torch.data import photometric as tp
from feature_point_cnn_tpu_torch.ops import labels as tl
from feature_point_cnn_tpu_torch.utils.metrics import samplewise_f1

H, W, CELL = 48, 64, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _points(rng, b, p):
    """Points with several a cell, some outside the image, some invalid."""
    pts = (rng.random((b, p, 2)) * [H + 10, W + 10] - 5).astype(np.float32)
    pts[:, :4] = pts[:, :1] + rng.random((b, 4, 2)).astype(np.float32) * 3  # shared cells
    pts[:, 5] = [H - 0.5, W - 0.5]
    pts[:, 6] = [-0.5, 3.0]            # truncates to row 0: kept on both sides
    return pts, rng.random((b, p)) > 0.2


def _jax_labels(pts, valid, key):
    """The JAX batch encoder and the noise it drew."""
    b = pts.shape[0]
    keys = jax.random.split(key, b)
    noise = np.stack([np.asarray(jax.random.uniform(
        k, (H // CELL, W // CELL, CELL * CELL + 1), jnp.float32, 0.0, 0.1))
        for k in keys])
    want = jl.make_points_labels_batch(jnp.asarray(pts), jnp.asarray(valid), key,
                                       H, W, CELL)
    return np.asarray(want), noise


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_labels_match_jax_given_the_same_noise(seed):
    pts, valid = _points(np.random.default_rng(seed), 3, 40)
    want, noise = _jax_labels(pts, valid, jax.random.PRNGKey(seed))
    got = tl.make_points_labels_batch(_t(pts), _t(valid), None, H, W, CELL,
                                      noise=_t(noise))
    assert got.dtype == torch.int64 and got.shape == (3, H // CELL, W // CELL)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 64).sum() >= 10 and (want == 64).sum() >= 10
    one = tl.make_points_labels(_t(pts[0]), _t(valid[0]), None, H, W, CELL,
                                noise=_t(noise[0]))
    np.testing.assert_array_equal(one.numpy(), want[0])


def test_labels_from_generator_encode_the_points():
    """With generator noise: a cell with one point gets that point's class,
    a cell with none the dustbin, a cell with several one of them; the same
    seed gives the same labels."""
    pts = np.array([[[3.2, 5.9], [20.0, 40.0], [21.0, 41.0], [100.0, 3.0]]], np.float32)
    valid = np.array([[True, True, True, True]])
    lab = tl.make_points_labels_batch(_t(pts), _t(valid),
                                      torch.Generator().manual_seed(0), H, W, CELL)
    again = tl.make_points_labels_batch(_t(pts), _t(valid),
                                        torch.Generator().manual_seed(0), H, W, CELL)
    assert torch.equal(lab, again)
    assert lab[0, 0, 0] == 3 * CELL + 5
    assert lab[0, 2, 5] in (4 * CELL + 0, 5 * CELL + 1)
    assert (lab == 64).sum() == lab.numel() - 2
    prob = tl.make_prob_map_from_labels(lab, CELL)
    want = np.asarray(jl.make_prob_map_from_labels(jnp.asarray(lab.numpy()), CELL))
    np.testing.assert_array_equal(prob.numpy(), want)
    assert prob.sum() == 2 and prob[0, 3, 5] == 1


def test_space_to_depth_and_scale_valid_map_match_jax():
    rng = np.random.default_rng(3)
    x = rng.random((2, H, W)).astype(np.float32)
    np.testing.assert_array_equal(tl.space_to_depth(_t(x), CELL).numpy(),
                                  np.asarray(jl.space_to_depth(jnp.asarray(x), CELL)))
    mask = (rng.random((2, H, W)) > 0.97).astype(np.float32)
    mask[0, :16] = 0
    want = np.asarray(jl.scale_valid_map(jnp.asarray(mask), CELL))
    got = tl.scale_valid_map(_t(mask), CELL)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1


def test_samplewise_f1_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 6, 8, 65)).astype(np.float32)
    targets = rng.integers(0, 65, (3, 6, 8))
    targets[0] = logits[0].argmax(-1)
    want = float(jax_f1(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(samplewise_f1(_t(logits), _t(targets)))
    assert got == pytest.approx(want, abs=1e-7) and got > 1 / 3


def _images(seed, b=3, c=3):
    return np.random.default_rng(seed).random((b, 24, 32, c)).astype(np.float32)


def test_brightness_contrast_matches_jax():
    imgs = _images(5)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    want = np.stack([np.asarray(jp._brightness_contrast(k, jnp.asarray(im)))
                     for k, im in zip(keys, imgs)])
    br, ct = [], []
    for k in keys:                       # the draws of `_brightness_contrast`
        kb, kc = jax.random.split(k)
        br.append(float(jax.random.uniform(kb, (), minval=-0.2, maxval=0.2)))
        ct.append(1.0 + float(jax.random.uniform(kc, (), minval=-0.2, maxval=0.2)))
    got = tp.brightness_contrast(_t(imgs), torch.tensor(br), torch.tensor(ct))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_blur_matches_jax_for_each_kernel():
    imgs = _images(6)
    want, choice = [], []
    key = jax.random.PRNGKey(0)
    while len(set(choice)) < 3 or len(choice) < 3:     # until all kernels were drawn
        key, k = jax.random.split(key)
        choice.append(int(jax.random.randint(k, (), 0, 3)))
        want.append(np.asarray(jp._blur(k, jnp.asarray(imgs[len(choice) % 3]))))
    batch = np.stack([imgs[(i + 1) % 3] for i in range(len(choice))])
    got = tp.blur(_t(batch), torch.tensor(choice))
    np.testing.assert_allclose(got.numpy(), np.stack(want), atol=1e-6)


def test_noise_matches_jax():
    imgs = _images(7, b=4)
    keys = jax.random.split(jax.random.PRNGKey(9), 4)
    want = np.stack([np.asarray(jp._noise(k, jnp.asarray(im)))
                     for k, im in zip(keys, imgs)])
    mult, gauss, pick = [], [], []
    for k, im in zip(keys, imgs):        # the draws of `_noise`
        kc, km, ka = jax.random.split(k, 3)
        mult.append(np.asarray(jax.random.uniform(km, im.shape[:2] + (1,),
                                                  minval=0.9, maxval=1.1)))
        gauss.append(np.asarray(jax.random.normal(ka, im.shape)))
        pick.append(bool(jax.random.uniform(kc) < 0.5))
    assert len(set(pick)) == 2
    got = tp.noise(_t(imgs), _t(np.stack(mult)), _t(np.stack(gauss)), torch.tensor(pick))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("p", [0.0, 1.0, 1.0 / 3.0])
def test_photometric_augment_batch_contract(p):
    """In range, same shape, seeded; p = 0 is the identity (after the clip),
    p = 1 changes every item."""
    imgs = _t(_images(8, b=6))
    out = tp.photometric_augment_batch(torch.Generator().manual_seed(1), imgs, p)
    again = tp.photometric_augment_batch(torch.Generator().manual_seed(1), imgs, p)
    assert out.shape == imgs.shape and torch.equal(out, again)
    assert out.min() >= 0.0 and out.max() <= 1.0
    changed = (out != imgs).flatten(1).any(dim=1)
    if p == 0.0:
        assert not changed.any()
    if p == 1.0:
        assert changed.all()
    one = tp.photometric_augment(torch.Generator().manual_seed(1), imgs[0], p)
    assert one.shape == imgs[0].shape
