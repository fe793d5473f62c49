"""Schur-complement bundle adjustment on one device
(`feature_point_cnn_tpu/slam/bundle.py:59-356`).

Keyframe poses are Sim(2) elements ``(theta, log_scale, tx, ty)`` and
landmarks 2-D world points.  An observation ``(i, l, z)`` predicts the
landmark in keyframe ``i``'s local frame, ``pred = T_i^{-1} · X_l``, with
residual ``z - pred``.  Each Gauss-Newton iteration eliminates the
landmarks (their ``Hll`` is block-diagonal, 2x2 a landmark), solves the
reduced ``4P x 4P`` camera system, and back-substitutes the landmark
updates.  Levenberg damping on both blocks; pose 0 is gauge-fixed with a
quadratic prior.  Observations are stored ``(L, M)`` with a validity mask.

The JAX package builds a dense ``(L, P, 4, 2)`` coupling array and
contracts it over the landmarks (``L·P²·32`` multiply-adds an iteration).
Here each landmark's ``M x M`` blocks ``W_m Hll^-1 W_n'`` are formed
directly and scattered into ``S`` with ``index_add_``: the same sums in
``L·M²·32`` multiply-adds, with no ``(L, P, ...)`` array.  Per-observation
Jacobians are in closed form; `dense_bundle_adjust_reference` takes its
Jacobian with `torch.func.jacfwd`, so the two routes share no derivative
code.  Solves read no status back (``solve_ex``), so an iteration makes no
host round trip.

Over a data mesh (`parallel/mesh.py`, JAX's ``mesh``) the landmarks are
padded to a multiple of the mesh with zero-observation entries (their
``Hll`` is the damping, their update is dropped) and each rank owns a
contiguous block of them with their observations.  Every landmark adds an
independent term to ``(S, bs, cost)``, so an iteration is the rank's part
of the system (`_shard_system`), ONE all-reduce of ``(S, bs, cost)``, the
pose solve on every rank (`_solve_poses`) and the rank's own
back-substitution (`_back_substitute`).  The points come back to every
rank in one exact sum at the end.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from feature_point_cnn_tpu_torch.device import resolve_device
from feature_point_cnn_tpu_torch.parallel.collectives import all_sum_, gather_rows
from feature_point_cnn_tpu_torch.slam.posegraph import sim2_inverse


class BAProblem(NamedTuple):
    """Fixed-shape bundle-adjustment problem.

    poses: ``(P, 4)`` Sim(2) initial guesses; points: ``(L, 2)`` initial
    landmark positions (world frame); obs_pose: ``(L, M)`` int keyframe
    index of each observation slot; obs_xy: ``(L, M, 2)`` measured landmark
    position in that keyframe's local frame; obs_valid: ``(L, M)`` bool.
    """

    poses: torch.Tensor
    points: torch.Tensor
    obs_pose: torch.Tensor
    obs_xy: torch.Tensor
    obs_valid: torch.Tensor

    def to(self, device) -> "BAProblem":
        return BAProblem(*(t.to(device) for t in self))


def observe(pose: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Landmark in the keyframe's local frame, ``T^{-1} · X`` (Sim(2));
    ``pose (..., 4)`` and ``point (..., 2)`` broadcast."""
    inv = sim2_inverse(pose)
    c, s = torch.cos(inv[..., 0]), torch.sin(inv[..., 0])
    scale = torch.exp(inv[..., 1])
    x = scale * (c * point[..., 0] - s * point[..., 1]) + inv[..., 2]
    y = scale * (s * point[..., 0] + c * point[..., 1]) + inv[..., 3]
    return torch.stack([x, y], dim=-1)


def _observation_terms(poses, points, obs_pose, obs_xy, obs_valid):
    """Residuals and Jacobians of every observation slot, invalid slots
    zeroed: ``r (L, M, 2)``, ``jp (L, M, 2, 4)``, ``jl (L, M, 2, 2)``.

    With ``pred = e^-σ R(-θ) (X - t)``: ``∂pred/∂θ = (pred_y, -pred_x)``,
    ``∂pred/∂σ = -pred``, ``∂pred/∂t = -A`` and ``∂pred/∂X = A`` for
    ``A = e^-σ R(-θ)``; the residual is ``z - pred``."""
    p_rows = poses[obs_pose]                                  # (L, M, 4)
    pred = observe(p_rows, points[:, None, :])                # (L, M, 2)
    theta, log_s = p_rows[..., 0], p_rows[..., 1]
    c, s = torch.cos(theta), torch.sin(theta)
    e = torch.exp(-log_s)
    a = torch.stack([torch.stack([e * c, e * s], -1),
                     torch.stack([-e * s, e * c], -1)], -2)   # (L, M, 2, 2)
    px, py = pred[..., 0], pred[..., 1]
    d_pose = torch.cat([torch.stack([py, -px], -1)[..., None],
                        -pred[..., None], -a], dim=-1)        # (L, M, 2, 4)
    w = obs_valid.to(pred.dtype)
    r = (obs_xy - pred) * w[..., None]
    jp = -d_pose * w[..., None, None]
    jl = -a * w[..., None, None]
    return r, jp, jl


def _inverse_2x2(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of ``(..., 2, 2)`` matrices."""
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    return torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)],
                       -2) * inv_det[..., None, None]


def _shard_system(poses, points, obs_pose, obs_xy, obs_valid, damping: float):
    """The landmarks' additive part of the reduced camera system: ``(S (4P,
    4P), bs (4P,), cost ())``, undamped, and ``(hll_inv, bl, hpl, idx)`` for
    their back-substitution."""
    n_poses = poses.shape[0]
    r, jp, jl = _observation_terms(poses, points, obs_pose, obs_xy, obs_valid)
    hpp = torch.einsum("lmki,lmkj->lmij", jp, jp)             # (L, M, 4, 4)
    hpl = torch.einsum("lmki,lmkj->lmij", jp, jl)             # (L, M, 4, 2)
    hll = torch.einsum("lmki,lmkj->lij", jl, jl)              # (L, 2, 2)
    bp = torch.einsum("lmki,lmk->lmi", jp, r)                 # (L, M, 4)
    bl = torch.einsum("lmki,lmk->li", jl, r)                  # (L, 2)
    eye2 = torch.eye(2, dtype=poses.dtype, device=poses.device)
    hll_inv = _inverse_2x2(hll + damping * eye2)

    # S = Hpp - sum_l W_l Hll^-1 W_l'; landmark l adds the block
    # hpl[l, m] Hll^-1 hpl[l, n]' at (pose of m, pose of n)
    whi = torch.einsum("lmij,ljk->lmik", hpl, hll_inv)        # (L, M, 4, 2)
    off = torch.einsum("lmik,lnjk->lmnij", whi, hpl)          # (L, M, M, 4, 4)
    idx = obs_pose.long()
    pair = (idx[:, :, None] * n_poses + idx[:, None, :]).reshape(-1)
    diag = idx.reshape(-1) * (n_poses + 1)
    blocks = torch.zeros((n_poses * n_poses, 4, 4), dtype=poses.dtype,
                         device=poses.device)
    blocks.index_add_(0, diag, hpp.reshape(-1, 4, 4))
    blocks.index_add_(0, pair, off.reshape(-1, 4, 4), alpha=-1.0)
    s = blocks.reshape(n_poses, n_poses, 4, 4).transpose(1, 2).reshape(
        4 * n_poses, 4 * n_poses)
    bs = torch.zeros((n_poses, 4), dtype=poses.dtype, device=poses.device)
    bs.index_add_(0, idx.reshape(-1),
                  (bp - torch.einsum("lmik,lk->lmi", whi, bl)).reshape(-1, 4))
    return s, bs.reshape(-1), (r * r).sum(), (hll_inv, bl, hpl, idx)


def _solve_poses(s, bs, damping: float, anchor_weight: float) -> torch.Tensor:
    """The damped, gauge-fixed pose step ``(P, 4)`` from the whole reduced
    system: a quadratic prior pins pose 0 at its current value (H += w·I on
    its block, b += 0), Levenberg damping on the diagonal."""
    diag_add = torch.full((s.shape[0],), damping, dtype=s.dtype, device=s.device)
    diag_add[:4] += anchor_weight
    s = s + torch.diag(diag_add)
    return torch.linalg.solve_ex(s, bs)[0].reshape(-1, 4)


def _back_substitute(hll_inv, bl, hpl, idx, dp) -> torch.Tensor:
    """The landmarks' step ``dl = Hll^-1 (bl - W' dp)``, ``(L, 2)``."""
    wtdp = torch.einsum("lmik,lmi->lk", hpl, dp[idx])         # (L, 2)
    return torch.einsum("lij,lj->li", hll_inv, bl - wtdp)


def _gn_iteration(poses, points, obs_pose, obs_xy, obs_valid, damping: float,
                  anchor_weight: float, group=None):
    """One Schur-complement Gauss-Newton iteration -> ``(poses, points,
    cost)``; with a process ``group``, over its ranks' landmark blocks."""
    s, bs, cost, local = _shard_system(poses, points, obs_pose, obs_xy,
                                       obs_valid, damping)
    if group is not None:
        n = s.numel()
        total = all_sum_(torch.cat([s.reshape(-1), bs, cost[None]]), group)
        s, bs, cost = total[:n].view(s.shape), total[n:-1], total[-1]
    # b was accumulated as +J'r; GN solves H δ = -J'r, so (dp, dl) are the
    # negated update
    dp = _solve_poses(s, bs, damping, anchor_weight)
    return poses - dp, points - _back_substitute(*local, dp), cost


def _pad_landmarks(problem: BAProblem, n_shards: int) -> BAProblem:
    """Zero-observation landmarks appended up to a multiple of
    ``n_shards``."""
    pad = (-problem.points.shape[0]) % n_shards
    if pad == 0:
        return problem
    return BAProblem(problem.poses, *(
        torch.cat([t, torch.zeros((pad,) + t.shape[1:], dtype=t.dtype,
                                  device=t.device)])
        for t in problem[1:]))


def bundle_adjust(
    problem: BAProblem,
    mesh=None,
    axis: str = "data",
    iters: int = 10,
    damping: float = 1e-4,
    anchor_weight: float = 1e4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Schur-complement Gauss-Newton bundle adjustment on the problem's
    device; with ``mesh``, a `parallel.mesh.DataMesh` on ``axis``, over its
    ranks, every rank passing the whole problem.  Returns ``(poses (P, 4),
    points (L, 2), costs (iters,))``, the cost of each iteration before its
    update, on every rank."""
    group, rows = None, slice(None)
    n_points = problem.points.shape[0]
    if mesh is not None and mesh.axis != axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    if mesh is not None and mesh.group is not None:
        if not mesh.member:
            raise ValueError("this rank is outside the data mesh")
        problem = _pad_landmarks(problem, mesh.size)
        per = problem.points.shape[0] // mesh.size
        group, rows = mesh.group, slice(mesh.rank * per, (mesh.rank + 1) * per)
    poses, points = problem.poses, problem.points[rows]
    obs = (problem.obs_pose[rows], problem.obs_xy[rows], problem.obs_valid[rows])
    costs = []
    for _ in range(iters):
        poses, points, cost = _gn_iteration(poses, points, *obs, damping,
                                            anchor_weight, group)
        costs.append(cost)
    if group is not None:
        points = gather_rows(points, group)[:n_points]
    return poses, points, torch.stack(costs)


def dense_bundle_adjust_reference(
    problem: BAProblem, iters: int = 10, damping: float = 1e-4,
    anchor_weight: float = 1e4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Oracle: the same Gauss-Newton iteration solved densely (no Schur
    elimination) through the full ``(4P + 2L)`` normal system, with the
    Jacobian from `torch.func.jacfwd`."""
    n_poses, n_points = problem.poses.shape[0], problem.points.shape[0]
    w = problem.obs_valid.to(problem.poses.dtype)[..., None]

    def full_residuals(x: torch.Tensor) -> torch.Tensor:
        poses = x[: 4 * n_poses].reshape(n_poses, 4)
        points = x[4 * n_poses:].reshape(n_points, 2)
        pred = observe(poses[problem.obs_pose.long()], points[:, None, :])
        return ((problem.obs_xy - pred) * w).reshape(-1)

    jacobian = torch.func.jacfwd(full_residuals)
    x = torch.cat([problem.poses.reshape(-1), problem.points.reshape(-1)])
    dev, dt = x.device, x.dtype
    prior = torch.zeros(x.shape[0], dtype=dt, device=dev)
    prior[:4] = anchor_weight
    costs = []
    for _ in range(iters):
        r = full_residuals(x)
        jac = jacobian(x)
        h = jac.T @ jac + torch.diag(prior + damping)
        dx = torch.linalg.solve_ex(h, jac.T @ r)[0]     # residual: z - pred
        x = x - dx
        costs.append((r * r).sum())
    return (x[: 4 * n_poses].reshape(n_poses, 4),
            x[4 * n_poses:].reshape(n_points, 2), torch.stack(costs))


def synthetic_ba_problem(
    rng: np.random.Generator,
    n_poses: int = 6,
    n_points: int = 48,
    obs_per_point: int = 4,
    noise: float = 0.01,
    init_noise: float = 0.05,
    device=None,
) -> tuple:
    """Random well-conditioned Sim(2) BA instance; returns
    ``(problem, true_poses, true_points)`` with ``problem`` on ``device``
    (default cuda) and the truth as numpy.  Draws what the JAX package's
    ``synthetic_ba_problem`` draws from the same generator, in the same
    order; the observations are computed in one batched `observe` on the
    CPU, so every device gets the same problem."""
    device = resolve_device(device)
    true_poses = np.concatenate(
        [
            rng.uniform(-0.3, 0.3, (n_poses, 1)),          # theta
            rng.uniform(-0.1, 0.1, (n_poses, 1)),          # log scale
            rng.uniform(-1.0, 1.0, (n_poses, 2)),          # t
        ],
        axis=1,
    ).astype(np.float32)
    true_poses[0] = 0.0                                    # gauge anchor
    true_points = rng.uniform(-2.0, 2.0, (n_points, 2)).astype(np.float32)

    obs_pose = np.stack(
        [rng.choice(n_poses, obs_per_point, replace=False) for _ in range(n_points)]
    ).astype(np.int32)
    z = observe(torch.from_numpy(true_poses)[obs_pose],
                torch.from_numpy(true_points)[:, None, :]).numpy()
    # the JAX loop draws 2 normals an observation, slots in row-major order
    obs_xy = (z + rng.normal(0, noise, (n_points, obs_per_point, 2))).astype(np.float32)
    obs_valid = np.ones((n_points, obs_per_point), bool)
    # ragged reality: drop a few slots
    obs_valid[rng.random((n_points, obs_per_point)) < 0.1] = False

    init_poses = (true_poses + rng.normal(0, init_noise, true_poses.shape)).astype(
        np.float32)
    init_poses[0] = true_poses[0]
    init_points = (true_points + rng.normal(0, init_noise, true_points.shape)).astype(
        np.float32)
    problem = BAProblem(
        torch.from_numpy(init_poses), torch.from_numpy(init_points),
        torch.from_numpy(obs_pose), torch.from_numpy(obs_xy),
        torch.from_numpy(obs_valid),
    ).to(device)
    return problem, true_poses, true_points
