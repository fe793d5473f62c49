"""PyTorch port: keypoint decode and extraction against the JAX package on
the CPU.

Extraction is held to exact equality of y/x/score/valid, plateau ties
included (the port takes a stable descending sort where JAX takes
``lax.top_k``; both put the lower index first among equal scores).
`refine_keypoints` agrees to 1e-5 (float32 logs).  The label codec is a
reshape, so it is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
from feature_point_cnn_tpu.ops import detection as JD
from feature_point_cnn_tpu.ops import labels as JL
from tests.test_detection import _plateau_maps, _random_scores

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.ops import detection as D
from feature_point_cnn_tpu_torch.ops import labels as L


def assert_keypoints_equal(got, want):
    for field in ("y", "x", "score", "valid"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            err_msg=field,
        )


def _score_stacks(rng):
    random = np.stack([_random_scores(rng, 0.02 + 0.04 * t) for t in range(4)])
    return {"random": random, "plateaus": np.stack(_plateau_maps())}


@pytest.mark.parametrize("k", [16, 256])
def test_extract_block_max_path_exact(rng, k):
    """48x64 with nms_dist 4: the 4x4 block-max top-K path, after the NMS
    kernel's plain version (a CPU tensor)."""
    cfg = SuperPointConfig(max_keypoints=k)
    jcfg = JaxConfig(max_keypoints=k, use_pallas_nms="off")
    for name, scores in _score_stacks(rng).items():
        got = D.extract_keypoints_from_scores(torch.from_numpy(scores), cfg)
        want = JD.extract_keypoints_from_scores(jnp.asarray(scores), jcfg)
        assert_keypoints_equal(got, want)
        assert int(got.num.sum()) > 0, name


@pytest.mark.parametrize("case", ["odd_shape", "nms_iters"])
def test_extract_flat_top_k_fallback_exact(rng, case):
    """The plain top-K fallback: a map not divisible by the block, or
    truncated NMS (``nms_iters > 0``)."""
    if case == "odd_shape":
        scores = np.stack([_random_scores(rng, 0.05)[:46, :62],
                           np.full((46, 62), 0.25, np.float32)])
        cfg, jcfg = SuperPointConfig(max_keypoints=128), JaxConfig(max_keypoints=128)
    else:
        scores = np.stack([_random_scores(rng, 0.2)] + _plateau_maps())
        cfg = SuperPointConfig(max_keypoints=128, nms_iters=2)
        jcfg = JaxConfig(max_keypoints=128, nms_iters=2)
    got = D.extract_keypoints_from_scores(torch.from_numpy(scores), cfg)
    want = JD.extract_keypoints_from_scores(
        jnp.asarray(scores), jcfg.replace(use_pallas_nms="off")
    )
    assert_keypoints_equal(got, want)


def test_extract_keypoints_thresholds_prob_map(rng):
    prob = rng.random((2, 48, 64)).astype(np.float32) * 0.05
    cfg = SuperPointConfig(max_keypoints=64)
    got = D.extract_keypoints(torch.from_numpy(prob), cfg)
    want = JD.extract_keypoints(jnp.asarray(prob), JaxConfig(max_keypoints=64))
    assert_keypoints_equal(got, want)


@pytest.mark.parametrize("num_iters", [0, 1, 3])
def test_grid_nms_matches_jax(rng, num_iters):
    scores = np.stack([_random_scores(rng, 0.3)] + _plateau_maps())
    got = D.grid_nms(torch.from_numpy(scores), 4, num_iters).numpy()
    want = np.asarray(JD.grid_nms(jnp.asarray(scores), 4, num_iters))
    np.testing.assert_array_equal(got, want)


def test_refine_keypoints_matches_jax(rng):
    prob = rng.random((2, 32, 40)).astype(np.float32)
    y = rng.integers(0, 32, (2, 12)).astype(np.float32)
    x = rng.integers(0, 40, (2, 12)).astype(np.float32)
    y[0, :2], x[0, :2] = 0.0, 39.0  # border clamps
    valid = rng.random((2, 12)) > 0.3
    score = rng.random((2, 12)).astype(np.float32)
    got = D.refine_keypoints(torch.from_numpy(prob), D.Keypoints(
        torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(score),
        torch.from_numpy(valid)))
    want = JD.refine_keypoints(jnp.asarray(prob), JD.Keypoints(
        jnp.asarray(y), jnp.asarray(x), jnp.asarray(score), jnp.asarray(valid)))
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), atol=1e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-5)
    assert np.any(got.y.numpy() != y)  # the refinement did move points


def test_softmax65_and_decode_match_jax(rng):
    logits = (rng.standard_normal((2, 3, 4, 65)) * 3).astype(np.float32)
    np.testing.assert_allclose(
        D.softmax65(torch.from_numpy(logits)).numpy(),
        np.asarray(JD.softmax65(jnp.asarray(logits))), atol=1e-6)
    np.testing.assert_allclose(
        D.decode_prob_map(torch.from_numpy(logits), 8).numpy(),
        np.asarray(JD.decode_prob_map(jnp.asarray(logits), 8)), atol=1e-6)
    big = torch.full((1, 1, 1, 65), 300.0)
    assert torch.isfinite(D.softmax65(big)).all()


def test_label_codec_matches_jax(rng):
    x = rng.random((2, 16, 24)).astype(np.float32)
    s2d = L.space_to_depth(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(s2d.numpy(), np.asarray(JL.space_to_depth(jnp.asarray(x), 8)))
    np.testing.assert_array_equal(L.depth_to_space(s2d, 8).numpy(), x)
    prob = rng.random((2, 2, 3, 65)).astype(np.float32)
    np.testing.assert_array_equal(
        L.restore_prob_map(torch.from_numpy(prob), 8).numpy(),
        np.asarray(JL.restore_prob_map(jnp.asarray(prob), 8)))


def test_keypoints_to_numpy_layout():
    kp = D.Keypoints(
        y=torch.tensor([[3.0, 0.0]]), x=torch.tensor([[5.0, 0.0]]),
        score=torch.tensor([[0.5, 0.0]]), valid=torch.tensor([[True, False]]))
    np.testing.assert_array_equal(D.keypoints_to_numpy(kp), [[5.0], [3.0], [0.5]])
    assert kp.num.tolist() == [1]


def test_keypoints_xys_matches_jax(rng):
    """`Keypoints.xys`: ``(B, K, 3)`` of ``(x, y, score)``, as JAX's."""
    scores = _score_stacks(rng)["random"]
    cfg = SuperPointConfig(max_keypoints=32)
    got = D.extract_keypoints_from_scores(torch.from_numpy(scores), cfg)
    want = JD.extract_keypoints_from_scores(
        jnp.asarray(scores), JaxConfig(max_keypoints=32, use_pallas_nms="off"))
    xys = got.xys()
    assert xys.shape == (4, 32, 3) and xys.dtype == torch.float32
    np.testing.assert_array_equal(xys.numpy(), np.asarray(want.xys()))
