"""PyTorch port: descriptor sampling and MNN matching against the JAX
package on the CPU.  Sampling agrees to 1e-5 (float32 bilinear weights and
norms); match indices and validity are exact (argmax with the lower index
first on ties on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.ops import detection as JD
from feature_point_cnn_tpu.ops.descriptors import sample_descriptors as jax_sample
from feature_point_cnn_tpu.ops import matching as JM
from feature_point_cnn_tpu.ops.matching import mnn_match as jax_mnn

from feature_point_cnn_tpu_torch.ops.descriptors import sample_descriptors
from feature_point_cnn_tpu_torch.ops.detection import Keypoints
from feature_point_cnn_tpu_torch.ops.matching import Matches, mnn_match


def _unit(rng, shape):
    d = rng.standard_normal(shape).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("size", [(64, 96), (72, 88)])
def test_sample_descriptors_matches_jax(rng, size):
    h, w = size
    hc, wc = h // 8, w // 8
    dmap = rng.standard_normal((2, hc, wc, 32)).astype(np.float32)
    y = (rng.random((2, 50)) * (h - 1)).astype(np.float32)
    x = (rng.random((2, 50)) * (w - 1)).astype(np.float32)
    y[0, :3] = [0.0, h - 1.0, 7.0]  # edges and an integer pixel
    x[0, :3] = [0.0, w - 1.0, 8.0]
    valid = rng.random((2, 50)) > 0.2
    score = rng.random((2, 50)).astype(np.float32)
    got = sample_descriptors(torch.from_numpy(dmap), Keypoints(
        torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(score),
        torch.from_numpy(valid)), h, w).numpy()
    want = np.asarray(jax_sample(jnp.asarray(dmap), JD.Keypoints(
        jnp.asarray(y), jnp.asarray(x), jnp.asarray(score), jnp.asarray(valid)),
        h, w))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert not got[~valid].any()
    np.testing.assert_allclose(np.linalg.norm(got[valid], axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("gate", [None, 0.7, 1.2])
def test_mnn_match_matches_jax(rng, gate):
    b, ka, kb, d = 3, 40, 48, 16
    base = _unit(rng, (kb, d))
    desc_b = base
    # A: noisy copies of a permutation of B, plus distractors
    perm = rng.permutation(kb)[:ka]
    desc_a = _unit(rng, (b, ka, d)) * 0.6 + base[perm][None] * 0.8
    desc_a /= np.linalg.norm(desc_a, axis=-1, keepdims=True)
    valid_a = rng.random((b, ka)) > 0.1
    valid_b = rng.random(kb) > 0.1
    got = mnn_match(torch.from_numpy(desc_a), torch.from_numpy(valid_a),
                    torch.from_numpy(desc_b), torch.from_numpy(valid_b),
                    max_l2_dist=gate)
    want = jax.vmap(lambda da, va: jax_mnn(
        da, va, jnp.asarray(desc_b), jnp.asarray(valid_b), max_l2_dist=gate
    ))(jnp.asarray(desc_a), jnp.asarray(valid_a))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    np.testing.assert_allclose(got.similarity.numpy(), np.asarray(want.similarity),
                               atol=1e-5)
    assert got.index.dtype == torch.int32
    assert 0 < int(got.num.sum()) < b * ka


def test_mnn_match_without_cross_check_and_empty_sets(rng):
    a = _unit(rng, (10, 8))
    b = _unit(rng, (12, 8))
    va, vb = np.ones(10, bool), np.zeros(12, bool)
    got = mnn_match(torch.from_numpy(a), torch.from_numpy(va),
                    torch.from_numpy(b), torch.from_numpy(vb))
    assert not got.valid.any()  # nothing valid in B: no match, no NaN
    vb[:] = True
    got = mnn_match(torch.from_numpy(a), torch.from_numpy(va),
                    torch.from_numpy(b), torch.from_numpy(vb), cross_check=False)
    want = jax_mnn(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                   jnp.asarray(vb), cross_check=False)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    assert bool(got.valid.all())
    np.testing.assert_allclose(got.similarity.numpy(),
                               np.asarray(want.similarity), atol=1e-5)


def test_matches_l2_distance_matches_jax(rng):
    """`Matches.l2_distance`: ``sqrt(max(2 - 2 similarity, 0))``, as JAX's,
    with similarities past 1 (rounding) clamped to distance 0."""
    a, b = _unit(rng, (3, 40, 16)), _unit(rng, (48, 16))
    m = mnn_match(torch.from_numpy(a), torch.ones(3, 40, dtype=torch.bool),
                  torch.from_numpy(b), torch.ones(48, dtype=torch.bool))
    sim = torch.cat([m.similarity.reshape(-1), torch.tensor([1.0, 1.0 + 1e-6, -1.0])])
    got = Matches(index=torch.zeros_like(sim, dtype=torch.int32), similarity=sim,
                  valid=torch.ones_like(sim, dtype=torch.bool)).l2_distance()
    want = JM.Matches(jnp.zeros(sim.shape, jnp.int32), jnp.asarray(sim.numpy()),
                      jnp.ones(sim.shape, bool)).l2_distance()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert got[-3:].tolist() == [0.0, 0.0, 2.0]
