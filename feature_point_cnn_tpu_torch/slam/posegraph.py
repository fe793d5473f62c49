"""Pose-graph optimisation over Sim(2) keyframe poses by Gauss-Newton
(`feature_point_cnn_tpu/slam/posegraph.py:23-107`).

Poses are ``(theta, log_scale, tx, ty)`` Sim(2) elements; edges carry
relative measurements in the same parameterisation (from
`slam.twoview.sim2_from_homography` or loop closures).  Each of a fixed
number of Gauss-Newton steps stacks the residuals of all edges, takes their
Jacobian with `torch.func.jacfwd`, and solves the dense ``(4N x 4N)``
normal system, as the JAX package does under `lax.scan`.  The solve reads
no status back (``solve_ex``), so a step makes no host round trip.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PoseGraph(NamedTuple):
    poses: torch.Tensor         # (N, 4) Sim(2): theta, log_scale, tx, ty
    edges_ij: torch.Tensor      # (E, 2) int node indices
    measurements: torch.Tensor  # (E, 4) relative pose i -> j
    weights: torch.Tensor       # (E,) information weight per edge


def sim2_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a ∘ b``: apply ``b`` then ``a``.  t = t_a + s_a·R(θ_a)·t_b."""
    theta = a[..., 0] + b[..., 0]
    log_s = a[..., 1] + b[..., 1]
    c, s = torch.cos(a[..., 0]), torch.sin(a[..., 0])
    scale = torch.exp(a[..., 1])
    tx = a[..., 2] + scale * (c * b[..., 2] - s * b[..., 3])
    ty = a[..., 3] + scale * (s * b[..., 2] + c * b[..., 3])
    return torch.stack([theta, log_s, tx, ty], dim=-1)


def sim2_inverse(p: torch.Tensor) -> torch.Tensor:
    theta, log_s = p[..., 0], p[..., 1]
    c, s = torch.cos(-theta), torch.sin(-theta)
    inv_scale = torch.exp(-log_s)
    tx = -inv_scale * (c * p[..., 2] - s * p[..., 3])
    ty = -inv_scale * (s * p[..., 2] + c * p[..., 3])
    return torch.stack([-theta, -log_s, tx, ty], dim=-1)


def _wrap_angle(a: torch.Tensor) -> torch.Tensor:
    return torch.atan2(torch.sin(a), torch.cos(a))


def _wrap_first(p: torch.Tensor) -> torch.Tensor:
    """``p`` with its angle column wrapped to (-pi, pi]."""
    return torch.cat([_wrap_angle(p[:, :1]), p[:, 1:]], dim=1)


def edge_residuals(poses: torch.Tensor, edges_ij: torch.Tensor,
                   measurements: torch.Tensor) -> torch.Tensor:
    """``r_e = log( m^-1 ∘ (T_i^-1 ∘ T_j) )`` per edge, ``(E, 4)``."""
    edges = edges_ij.long()
    rel = sim2_compose(sim2_inverse(poses[edges[:, 0]]), poses[edges[:, 1]])
    return _wrap_first(sim2_compose(sim2_inverse(measurements), rel))


def optimize_pose_graph(
    graph: PoseGraph,
    iters: int = 20,
    damping: float = 1e-6,
    fix_first: bool = True,
) -> torch.Tensor:
    """Gauss-Newton refinement; returns the optimised ``(N, 4)`` poses on
    the graph's device.  The first pose is gauge-fixed by a prior of weight
    1e3 when ``fix_first``."""
    n = graph.poses.shape[0]
    sqrt_w = graph.weights.sqrt()[:, None]
    first = graph.poses[0]

    def residual_vec(poses_flat: torch.Tensor) -> torch.Tensor:
        poses = poses_flat.reshape(n, 4)
        r = (edge_residuals(poses, graph.edges_ij, graph.measurements)
             * sqrt_w).reshape(-1)
        if fix_first:
            return torch.cat([r, (poses[0] - first) * 1e3])
        return r

    jacobian = torch.func.jacfwd(residual_vec)
    eye = damping * torch.eye(4 * n, dtype=graph.poses.dtype,
                              device=graph.poses.device)
    x = graph.poses.reshape(-1)
    for _ in range(iters):
        r = residual_vec(x)
        jac = jacobian(x)                                     # (R, 4N)
        delta = torch.linalg.solve_ex(jac.T @ jac + eye, jac.T @ r)[0]
        x = x - delta
    return _wrap_first(x.reshape(n, 4))


def chain_poses(relative: torch.Tensor) -> torch.Tensor:
    """Integrate relative motions ``(N-1, 4)`` into absolute poses ``(N, 4)``
    starting at identity (odometry chaining)."""
    poses = [torch.zeros(4, dtype=relative.dtype, device=relative.device)]
    for rel in relative:
        poses.append(sim2_compose(poses[-1], rel))
    return torch.stack(poses)
