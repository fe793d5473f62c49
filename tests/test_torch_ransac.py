"""PyTorch port: RANSAC on match sets of the harsh homography family, the
port against the JAX package, on the CPU.

Each of 48 seeds draws a homography of the default (harsh) family with the
JAX sampler (patch 0.5, rotations up to +-90 degrees), K = 200 view-2
points, their images in view 1 with under 1 px of noise, and then replaces
half of the view-1 points with uniform ones: match precision 0.5, the
share the two-view harness measures under this family.  The same sets go
to JAX's ``ransac_homography`` (jitted once, key ``PRNGKey(seed)``) and to
the port's (a generator seeded ``seed``).  The two draw different minimal
samples, so the test compares the two distributions of the estimate's mean
corner error (the four corners of a 240x320 view), not values.

Rule: the port's median corner error is at most JAX's times 1.25 plus
0.25 px, and its share under 3 px is at least JAX's less 0.1.  The test
prints both distributions' median, mean and share under 3 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from feature_point_cnn_tpu.config import HomographyConfig as JaxHomographyConfig
from feature_point_cnn_tpu.geometry.homography import sample_homography as jax_sample
from feature_point_cnn_tpu.slam import twoview as jax_twoview

from feature_point_cnn_tpu_torch.geometry.homography import warp_points
from feature_point_cnn_tpu_torch.slam import twoview

SEEDS = range(48)
K, H, W = 200, 240, 320
CORNERS = torch.tensor([[0, 0], [0, W - 1], [H - 1, W - 1], [H - 1, 0]],
                       dtype=torch.float32)


def _match_set(seed: int, h_flat: np.ndarray):
    """``(pts1, pts2, valid)``, ``(y, x)``: ``pts1 = H pts2`` (view-2 points
    into view 1, the estimator's convention) with noise under 1 px, then
    half of ``pts1`` replaced by uniform points."""
    rng = np.random.default_rng(seed)
    pts2 = rng.uniform([0, 0], [H - 1, W - 1], (K, 2)).astype(np.float32)
    m = np.append(h_flat, 1.0).reshape(3, 3)
    xy = np.concatenate([pts2[:, ::-1], np.ones((K, 1))], 1) @ m.T
    pts1 = (xy[:, :2] / xy[:, 2:])[:, ::-1]
    r, a = 0.9 * np.sqrt(rng.random(K)), rng.uniform(0, 2 * np.pi, K)
    pts1 = pts1 + np.stack([r * np.sin(a), r * np.cos(a)], -1)
    bad = rng.permutation(K)[: K // 2]
    pts1[bad] = rng.uniform([0, 0], [H - 1, W - 1], (K // 2, 2))
    return pts1.astype(np.float32), pts2, np.ones(K, bool)


def _corner_error(h_est, h_true) -> float:
    """Mean distance of the four view corners carried by each homography
    (`warp_points` applies the inverse of both alike)."""
    est = warp_points(CORNERS, torch.from_numpy(np.array(h_est, np.float32)))
    true = warp_points(CORNERS, torch.from_numpy(np.array(h_true, np.float32)))
    return float((est - true).norm(dim=-1).mean())


def _stats(errors) -> dict:
    e = np.asarray(errors)
    return {"median": float(np.median(e)), "mean": float(e.mean()),
            "under_3px": float((e < 3.0).mean())}


def test_port_ransac_is_no_worse_than_jax_on_the_harsh_family():
    sample = jax.jit(lambda key: jax_sample(key, (H, W), JaxHomographyConfig()))
    jax_ransac = jax.jit(jax_twoview.ransac_homography)
    port_err, jax_err = [], []
    for seed in SEEDS:
        h = np.asarray(sample(jax.random.PRNGKey(1000 + seed)))
        pts1, pts2, valid = _match_set(seed, h)
        want = jax_ransac(jax.random.PRNGKey(seed), jnp.asarray(pts1),
                          jnp.asarray(pts2), jnp.asarray(valid))
        got = twoview.ransac_homography(
            torch.Generator().manual_seed(seed), torch.from_numpy(pts1),
            torch.from_numpy(pts2), torch.from_numpy(valid))
        jax_err.append(_corner_error(np.asarray(want.h_flat), h))
        port_err.append(_corner_error(got.h_flat.numpy(), h))
    p, j = _stats(port_err), _stats(jax_err)
    print(f"harsh family, precision 0.5, K = {K}, {len(SEEDS)} seeds: "
          f"port {p}, JAX {j}")
    assert p["median"] <= 1.25 * j["median"] + 0.25, (p, j)
    assert p["under_3px"] >= j["under_3px"] - 0.1, (p, j)
