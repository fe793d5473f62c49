"""PyTorch port parity: Schur-complement bundle adjustment on one device
against the JAX package, on the CPU.

`synthetic_ba_problem` draws what JAX's draws from the same
``numpy.random.Generator``: poses, points, observation slots and validity
bit for bit; the observations too (both compute ``observe`` in float32 and
add the same float64 noise).  The port's Schur route is held to the port's
dense oracle (a `torch.func.jacfwd` Jacobian of the full residual) and to
JAX's `bundle_adjust` on the same problem at the tolerances of
`tests/test_bundle.py`: costs rtol 1e-4, poses and points atol 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.slam import bundle as jax_bundle

from feature_point_cnn_tpu_torch.slam import bundle


def _both(seed=0, **kw):
    port = bundle.synthetic_ba_problem(np.random.default_rng(seed), device="cpu", **kw)
    ref = jax_bundle.synthetic_ba_problem(np.random.default_rng(seed), **kw)
    return port, ref


@pytest.mark.parametrize("kw", [{}, dict(n_poses=5, n_points=40, obs_per_point=3)])
def test_synthetic_problem_equals_jax_bit_for_bit(kw):
    (problem, poses, points), (jproblem, jposes, jpoints) = _both(0, **kw)
    np.testing.assert_array_equal(poses, jposes)
    np.testing.assert_array_equal(points, jpoints)
    for got, want in zip(problem, jproblem):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_observe_roundtrip_and_matches_jax():
    x = torch.tensor([1.5, -0.5])
    np.testing.assert_allclose(bundle.observe(torch.zeros(4), x).numpy(), x.numpy(),
                               atol=1e-7)
    t = torch.tensor([0.0, 0.0, 2.0, 3.0])
    np.testing.assert_allclose(bundle.observe(t, x).numpy(), x.numpy() - [2.0, 3.0],
                               atol=1e-6)
    rng = np.random.default_rng(1)
    pose = rng.uniform(-1, 1, 4).astype(np.float32)
    pt = rng.uniform(-2, 2, 2).astype(np.float32)
    np.testing.assert_allclose(
        bundle.observe(torch.from_numpy(pose), torch.from_numpy(pt)).numpy(),
        np.asarray(jax_bundle.observe(jnp.asarray(pose), jnp.asarray(pt))), atol=1e-6)


def test_schur_matches_dense_oracle():
    problem, _, _ = bundle.synthetic_ba_problem(np.random.default_rng(0), device="cpu")
    p1, x1, c1 = bundle.bundle_adjust(problem, mesh=None, iters=5)
    p2, x2, c2 = bundle.dense_bundle_adjust_reference(problem, iters=5)
    np.testing.assert_allclose(c1.numpy(), c2.numpy(), rtol=1e-4)
    np.testing.assert_allclose(p1.numpy(), p2.numpy(), atol=2e-4)
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), atol=2e-4)


@pytest.mark.parametrize("kw,iters", [({}, 5), (dict(n_poses=4, n_points=37), 4)])
def test_bundle_adjust_matches_jax(kw, iters):
    (problem, _, _), (jproblem, _, _) = _both(0, **kw)
    p1, x1, c1 = bundle.bundle_adjust(problem, iters=iters)
    p2, x2, c2 = jax_bundle.bundle_adjust(jproblem, mesh=None, iters=iters)
    assert x1.shape == problem.points.shape
    np.testing.assert_allclose(c1.numpy(), np.asarray(c2), rtol=1e-4)
    np.testing.assert_allclose(p1.numpy(), np.asarray(p2), atol=2e-4)
    np.testing.assert_allclose(x1.numpy(), np.asarray(x2), atol=2e-4)


def test_dense_oracle_matches_jax_oracle():
    (problem, _, _), (jproblem, _, _) = _both(2, n_poses=4, n_points=20)
    p1, x1, c1 = bundle.dense_bundle_adjust_reference(problem, iters=3)
    p2, x2, c2 = jax_bundle.dense_bundle_adjust_reference(jproblem, iters=3)
    np.testing.assert_allclose(c1.numpy(), np.asarray(c2), rtol=1e-4)
    np.testing.assert_allclose(p1.numpy(), np.asarray(p2), atol=2e-4)
    np.testing.assert_allclose(x1.numpy(), np.asarray(x2), atol=2e-4)


def test_ba_recovers_ground_truth():
    problem, true_poses, true_points = bundle.synthetic_ba_problem(
        np.random.default_rng(0), n_poses=6, n_points=48, noise=1e-4, init_noise=0.05,
        device="cpu")
    poses, points, costs = bundle.bundle_adjust(problem, iters=10)
    assert float(costs[-1]) < 1e-2 * float(costs[0])
    np.testing.assert_allclose(poses.numpy(), true_poses, atol=5e-3)
    np.testing.assert_allclose(points.numpy(), true_points, atol=5e-3)


def test_ragged_landmark_count_keeps_its_shape():
    problem, _, _ = bundle.synthetic_ba_problem(np.random.default_rng(0), n_poses=4,
                                                n_points=37, device="cpu")
    p, x, c = bundle.bundle_adjust(problem, iters=4)
    assert x.shape == (37, 2) and p.shape == (4, 4) and c.shape == (4,)


def test_invalid_observations_ignored():
    problem, _, _ = bundle.synthetic_ba_problem(np.random.default_rng(0), n_poses=4,
                                                n_points=24, device="cpu")
    valid = problem.obs_valid.clone()
    valid[3] = False
    dead = problem._replace(obs_valid=valid)
    poses, points, _ = bundle.bundle_adjust(dead, iters=4)
    np.testing.assert_allclose(points[3].numpy(), problem.points[3].numpy(), atol=1e-6)
    assert torch.isfinite(poses).all()
    # and JAX agrees on the whole solution
    jp = jax_bundle.synthetic_ba_problem(np.random.default_rng(0), n_poses=4,
                                         n_points=24)[0]
    jp = jp._replace(obs_valid=jp.obs_valid.at[3].set(False))
    jposes, jpoints, _ = jax_bundle.bundle_adjust(jp, mesh=None, iters=4)
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), atol=2e-4)
    np.testing.assert_allclose(points.numpy(), np.asarray(jpoints), atol=2e-4)


def test_a_mesh_raises_naming_the_parallel_slice():
    """Named for the raise this test held while the landmark-sharded route
    was missing.  It now checks the ported route: a mesh on another axis
    than ``axis`` raises naming both, and the mesh of this process alone
    (no process group) runs the one-device iteration bit for bit.  Two
    ranks are held in `tests/test_torch_distributed.py`."""
    from feature_point_cnn_tpu_torch.parallel.mesh import DataMesh, make_mesh

    problem, _, _ = bundle.synthetic_ba_problem(np.random.default_rng(0), device="cpu")
    with pytest.raises(ValueError, match="'width'.*'data'"):
        bundle.bundle_adjust(problem, mesh=DataMesh(1, 0, "width"))
    got = bundle.bundle_adjust(problem, mesh=make_mesh(), iters=3)
    want = bundle.bundle_adjust(problem, iters=3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
