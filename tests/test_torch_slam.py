"""PyTorch port parity: Sim(2) algebra, the pose graph, the tracker and
trajectory metrics against the JAX package, on the CPU.

Tolerances: Sim(2) compose, inverse and edge residuals 1e-6 (float32 on
both sides); `optimize_pose_graph` on the loop graph of
`tests/test_slam.py` atol 1e-4 (float32 on both sides; the gauge prior of
weight 1e3 makes the normal matrix ill-conditioned); Umeyama and ATE 1e-9
(float64 numpy on both sides).  The three ideal-provider tracker scenarios
of `tests/test_slam.py` hold the port to JAX's own assertions with the
port's own RANSAC draws.  For value parity both packages' RANSAC draws are
pinned to one table of Gumbel scores (``pinned_ransac``): each estimate
(a frame's motion, a loop closure's) then agrees within 1e-3 px, and
inlier and match counts, keyframes and loop-closure edges exactly.  An
absolute pose chains the estimates of every keyframe before it, each a
float32 DLT solved by another library's ``eigh`` (they differ by up to
1.6e-4 px on the out-and-back run); poses and the refined trajectory are
held to 1e-3 px or 2e-4 px for each estimate chained in (``key_id + 1``),
whichever is larger; a refined pose depends on every keyframe of the
graph, so the refined trajectory gets 2e-4 px for each keyframe.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.slam import posegraph as JPG
from feature_point_cnn_tpu.slam import tracking as jax_tracking
from feature_point_cnn_tpu.slam import trajectory as jax_trajectory
from feature_point_cnn_tpu.slam import twoview as jax_twoview

from feature_point_cnn_tpu_torch.slam import posegraph as PG
from feature_point_cnn_tpu_torch.slam import tracking
from feature_point_cnn_tpu_torch.slam import trajectory
from feature_point_cnn_tpu_torch.slam import twoview

# 512 slots: the tracking entry point's default K; the first 256 columns
# are the table the smaller scenarios draw from
GUMBEL = np.concatenate([np.random.default_rng(seed).gumbel(size=(256, 256))
                         for seed in (1234, 1235)], 1).astype(np.float32)


@pytest.fixture
def pinned_ransac(monkeypatch):
    """Both packages' RANSAC draw the rows of one Gumbel table: hypothesis
    ``i`` of every call scores slot ``j`` with ``GUMBEL[i, j]``."""
    table = jnp.asarray(GUMBEL)
    fake_random = types.SimpleNamespace(
        split=lambda key, n: jnp.arange(n),
        gumbel=lambda i, shape: table[i, : shape[0]])
    monkeypatch.setattr(jax_twoview, "jax", types.SimpleNamespace(
        random=fake_random, vmap=jax.vmap, lax=jax.lax))
    monkeypatch.setattr(twoview, "_gumbel_scores", lambda gen, iters, k, dev:
                        torch.from_numpy(GUMBEL[:iters, :k]).to(dev))


def _poses(rng, n):
    return np.concatenate([rng.uniform(-3, 3, (n, 1)), rng.uniform(-0.3, 0.3, (n, 1)),
                           rng.uniform(-20, 20, (n, 2))], 1).astype(np.float32)


def test_sim2_algebra_and_edge_residuals_match_jax():
    rng = np.random.default_rng(0)
    a, b = _poses(rng, 16), _poses(rng, 16)
    for name in ("sim2_compose",):
        got = getattr(PG, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        want = np.asarray(getattr(JPG, name)(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(PG.sim2_inverse(torch.from_numpy(a)).numpy(),
                               np.asarray(JPG.sim2_inverse(jnp.asarray(a))),
                               atol=1e-5, rtol=1e-6)
    # the algebra of tests/test_slam.py::test_sim2_algebra
    ta, tb = torch.tensor([0.3, 0.1, 2.0, -1.0]), torch.tensor([-0.2, 0.05, 0.5, 0.7])
    np.testing.assert_allclose(PG.sim2_compose(PG.sim2_inverse(ta), ta).numpy(), 0.0,
                               atol=1e-6)
    np.testing.assert_allclose(
        PG.sim2_compose(PG.sim2_inverse(ta), PG.sim2_compose(ta, tb)).numpy(),
        tb.numpy(), atol=1e-6)
    poses, meas = _poses(rng, 8) * [1, 1, 0.1, 0.1], _poses(rng, 12) * [1, 1, 0.1, 0.1]
    edges = rng.integers(0, 8, (12, 2)).astype(np.int32)
    got = PG.edge_residuals(torch.from_numpy(poses.astype(np.float32)),
                            torch.from_numpy(edges),
                            torch.from_numpy(meas.astype(np.float32))).numpy()
    want = np.asarray(JPG.edge_residuals(jnp.asarray(poses, jnp.float32),
                                         jnp.asarray(edges),
                                         jnp.asarray(meas, jnp.float32)))
    np.testing.assert_allclose(got, want, atol=1e-6)


def _loop_graph(seed=0):
    """The square loop of `tests/test_slam.py::test_pose_graph_loop_closure`
    as numpy arrays: drifting odometry, one perfect loop closure."""
    rng = np.random.default_rng(seed)
    n = 21
    true_rel = np.tile(np.asarray([np.pi / 10, 0.0, 5.0, 0.0]), (n - 1, 1))
    noisy_rel = (true_rel + rng.normal(0, 0.02, true_rel.shape)).astype(np.float32)
    true_poses = PG.chain_poses(torch.from_numpy(true_rel.astype(np.float32))).numpy()
    init_poses = PG.chain_poses(torch.from_numpy(noisy_rel)).numpy()
    edges = [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]
    rel_loop = PG.sim2_compose(PG.sim2_inverse(torch.from_numpy(true_poses[0])),
                               torch.from_numpy(true_poses[-1])).numpy()
    meas = np.stack([noisy_rel[i] for i in range(n - 1)] + [rel_loop]).astype(np.float32)
    weights = np.ones(len(edges), np.float32)
    weights[-1] = 10.0
    return (true_rel, noisy_rel, true_poses, init_poses,
            np.asarray(edges, np.int32), meas, weights)


def test_chain_poses_matches_jax():
    true_rel, noisy_rel, true_poses, init_poses, *_ = _loop_graph()
    for rel, got in ((true_rel, true_poses), (noisy_rel, init_poses)):
        want = np.asarray(JPG.chain_poses(jnp.asarray(rel, jnp.float32)))
        np.testing.assert_allclose(got, want, atol=2e-5)


def test_optimize_pose_graph_on_the_loop_graph_matches_jax():
    _, _, true_poses, init_poses, edges, meas, weights = _loop_graph()
    got = PG.optimize_pose_graph(PG.PoseGraph(
        torch.from_numpy(init_poses), torch.from_numpy(edges), torch.from_numpy(meas),
        torch.from_numpy(weights)), iters=15).numpy()
    want = np.asarray(JPG.optimize_pose_graph(JPG.PoseGraph(
        jnp.asarray(init_poses), jnp.asarray(edges), jnp.asarray(meas),
        jnp.asarray(weights)), iters=15))
    np.testing.assert_allclose(got, want, atol=1e-4)
    # JAX's own assertion: the loop closure cuts the end-point gap
    err_before = np.linalg.norm(init_poses[-1, 2:] - true_poses[-1, 2:])
    err_after = np.linalg.norm(got[-1, 2:] - true_poses[-1, 2:])
    assert err_after < err_before * 0.3, (err_before, err_after)


def test_umeyama_and_ate_match_jax():
    rng = np.random.default_rng(3)
    gt = np.cumsum(rng.normal(0, 1, (30, 2)), 0)
    th = 0.4
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    est = 1.3 * gt @ rot.T + [4.0, -2.0] + rng.normal(0, 0.05, gt.shape)
    for a, b in ((est, gt), (gt, gt)):
        got, want = trajectory.umeyama_align(a, b), jax_trajectory.umeyama_align(a, b)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], atol=1e-9, rtol=1e-9)
        for align in (True, False):
            got = trajectory.absolute_trajectory_error(a, b, align=align)
            want = jax_trajectory.absolute_trajectory_error(a, b, align=align)
            assert got.keys() == want.keys()
            for k in got:
                assert got[k] == pytest.approx(want[k], abs=1e-9, rel=1e-9), k
    perfect = np.cumsum(np.ones((10, 2)), axis=0)
    assert trajectory.absolute_trajectory_error(perfect, perfect)["ate_rmse"] < 1e-9
    with pytest.raises(ValueError):
        trajectory.absolute_trajectory_error(perfect, perfect[:5])


def _world(seed, n_world=400, k=96, d=32, shape=(96, 128), noise=0.05,
           pos_noise=0.0, span=(2.0, 2.0)):
    """`tests/test_slam.py::_world_feature_extractor` as a numpy provider:
    fixed world points with unit descriptors; a frame at window offset
    ``(oy, ox)`` sees the points inside its window, with per-observation
    descriptor (and optional position) noise.  ``wrap`` turns the arrays
    into a package's `FrameFeatures`."""
    rng = np.random.default_rng(seed)
    world = rng.random((n_world, 2)) * [shape[0] * span[0], shape[1] * span[1]]
    desc = rng.standard_normal((n_world, d)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    h, w = shape

    def extract(offset, wrap):
        oy, ox = offset
        local = world - [oy, ox]
        vis = ((local[:, 0] >= 0) & (local[:, 0] < h)
               & (local[:, 1] >= 0) & (local[:, 1] < w))
        idx = np.nonzero(vis)[0][:k]
        y, x = np.zeros(k, np.float32), np.zeros(k, np.float32)
        v, dd = np.zeros(k, bool), np.zeros((k, d), np.float32)
        jitter = (pos_noise * rng.standard_normal((len(idx), 2))
                  if pos_noise else np.zeros((len(idx), 2)))
        y[: len(idx)] = local[idx, 0] + jitter[:, 0]
        x[: len(idx)] = local[idx, 1] + jitter[:, 1]
        v[: len(idx)] = True
        obs = desc[idx] + noise * rng.standard_normal((len(idx), d)).astype(np.float32)
        dd[: len(idx)] = obs / np.linalg.norm(obs, axis=1, keepdims=True)
        return wrap(y, x, v, dd)

    return extract


def _port(seed, **kw):
    ex = _world(seed, **kw)
    return lambda off: ex(off, lambda *a: tracking.FrameFeatures(
        *(torch.from_numpy(t) for t in a)))


def _jax(seed, **kw):
    ex = _world(seed, **kw)
    return lambda off: ex(off, lambda *a: jax_tracking.FrameFeatures(
        *(jnp.asarray(t) for t in a)))


TRANSLATION = [(8, 8), (8, 12), (10, 17), (13, 22), (15, 28), (18, 33), (20, 40), (24, 47)]
JUMP = [(8, 8), (10, 14), (96, 128), (94, 124)]
OUT_AND_BACK = ([(8, 8 + 50 * i) for i in range(13)]
                + [(8, 8 + 50 * i) for i in range(11, -1, -1)])
LOOP_WORLD = dict(n_world=3000, k=96, pos_noise=0.5, span=(2.0, 6.0))


def _gt(offsets):
    return np.asarray([[ox - 8, oy - 8] for oy, ox in offsets], np.float64)


def test_tracker_on_known_translation_sequence():
    tracker = tracking.Tracker(extract=_port(0), min_inliers=10, ransac_iters=128)
    results = tracker.track(TRANSLATION)
    est = np.stack([r["pose"][2:] for r in results])
    ate = trajectory.absolute_trajectory_error(est, _gt(TRANSLATION), align=False)
    assert ate["ate_rmse"] < 1.0, (est, ate)
    assert all(r["num_inliers"] >= 10 for r in results[1:])


def test_tracker_keyframe_promotion():
    tracker = tracking.Tracker(extract=_port(0), min_inliers=12, ransac_iters=64)
    results = tracker.track(JUMP)
    assert results[2]["is_keyframe"]
    assert results[3]["num_inliers"] >= 12


def test_loop_closure_posegraph_reduces_drift():
    tracker = tracking.Tracker(extract=_port(0, **LOOP_WORLD), min_inliers=55,
                               ransac_iters=128)
    results = tracker.track(OUT_AND_BACK)
    assert len(tracker.keyframes) >= 8
    gt = _gt(OUT_AND_BACK)
    est_raw = np.stack([r["pose"][2:4] for r in results])
    ate_raw = trajectory.absolute_trajectory_error(est_raw, gt, align=False)
    closures = tracking.detect_loop_closures(tracker, min_inliers=45)
    assert closures
    refined = tracking.refine_with_pose_graph(results, tracker, closures)
    ate_pg = trajectory.absolute_trajectory_error(refined[:, 2:4], gt, align=False)
    assert ate_raw["ate_rmse"] > 5.0, ate_raw
    assert ate_pg["ate_rmse"] < ate_raw["ate_rmse"] * 0.5, (ate_raw, ate_pg)


def _chained_atol(key_id: int) -> float:
    return max(1e-3, 2e-4 * (key_id + 1))


@pytest.mark.parametrize("scenario", ["translation", "promotion", "loop_closure"])
def test_tracker_equals_jax_with_pinned_ransac_draws(pinned_ransac, scenario):
    offsets, world, kw, loop = {
        "translation": (TRANSLATION, {}, dict(min_inliers=10, ransac_iters=128), None),
        "promotion": (JUMP, {}, dict(min_inliers=12, ransac_iters=64), None),
        "loop_closure": (OUT_AND_BACK, LOOP_WORLD,
                         dict(min_inliers=55, ransac_iters=128), 45),
    }[scenario]
    port = tracking.Tracker(extract=_port(0, **world), **kw)
    jax_t = jax_tracking.Tracker(extract=_jax(0, **world), **kw)
    got, want = port.track(offsets), jax_t.track(offsets)
    for f, (g, w) in enumerate(zip(got, want)):
        for key in ("num_matches", "num_inliers", "is_keyframe", "tracked", "key_id"):
            assert g[key] == w[key], (f, key, g[key], w[key])
        np.testing.assert_allclose(g["pose"], np.asarray(w["pose"]),
                                   atol=_chained_atol(g["key_id"]))
        np.testing.assert_allclose(g["rel"], np.asarray(w["rel"]), atol=1e-3)
    assert port.keyframe_frames == jax_t.keyframe_frames
    for kid, (a, b) in enumerate(zip(port.keyframe_poses, jax_t.keyframe_poses)):
        np.testing.assert_allclose(a, np.asarray(b), atol=_chained_atol(kid))
    if loop is None:
        return
    closures = tracking.detect_loop_closures(port, min_inliers=loop)
    jclosures = jax_tracking.detect_loop_closures(jax_t, min_inliers=loop)
    assert [(c["i"], c["j"], c["num_inliers"]) for c in closures] == [
        (c["i"], c["j"], c["num_inliers"]) for c in jclosures]
    for c, jc in zip(closures, jclosures):
        np.testing.assert_allclose(c["rel"], np.asarray(jc["rel"]), atol=1e-3)
    refined = tracking.refine_with_pose_graph(got, port, closures)
    jrefined = jax_tracking.refine_with_pose_graph(want, jax_t, jclosures)
    np.testing.assert_allclose(refined, jrefined,
                               atol=_chained_atol(len(port.keyframes) - 1))


def test_tracker_needs_a_provider():
    with pytest.raises(ValueError):
        tracking.Tracker()
