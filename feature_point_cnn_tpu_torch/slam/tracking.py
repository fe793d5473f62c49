"""Tracking front end: keyframe-based feature tracking over a sequence
(`feature_point_cnn_tpu/slam/tracking.py:34-286`).

Per frame, features come from any provider (the `SuperPointFrontend` in
use, an ideal provider in tests) and stay on its device; the track program
matches them to the keyframe (`mnn_match`), fits a homography
(`ransac_homography`) and projects it onto Sim(2).  The host reads one
small tensor a frame (inliers, matches and the motion together), decides
keyframe promotion and chains poses.  Outputs Sim(2) odometry for
`slam.posegraph` and ATE evaluation (`slam.trajectory`).

RANSAC's draws cannot repeat `jax.random`'s.  Frame ``i`` draws from a CPU
generator seeded by ``(seed, i)`` and the keyframe pair ``(i, j)`` of the
loop-closure sweep from one seeded by ``(seed, i * n + j)`` (the indices
JAX folds into its key), so the card and the CPU draw the same samples.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

import numpy as np
import torch

from feature_point_cnn_tpu_torch.ops.matching import mnn_match
from feature_point_cnn_tpu_torch.selflabel.coco import item_generator
from feature_point_cnn_tpu_torch.slam.posegraph import (
    PoseGraph,
    optimize_pose_graph,
    sim2_compose,
    sim2_inverse,
)
from feature_point_cnn_tpu_torch.slam.twoview import (
    ransac_homography,
    sim2_from_homography,
)


class FrameFeatures(NamedTuple):
    """Fixed-K features of one frame."""

    y: torch.Tensor        # (K,)
    x: torch.Tensor        # (K,)
    valid: torch.Tensor    # (K,) bool
    desc: torch.Tensor     # (K, D) unit descriptors


class TrackEstimate(NamedTuple):
    num_matches: torch.Tensor
    num_inliers: torch.Tensor
    rel_sim2: torch.Tensor   # (4,) keyframe -> frame motion (image content)
    h_flat: torch.Tensor


def frontend_extractor(frontend) -> Callable:
    """Wrap a `SuperPointFrontend` as a FrameFeatures provider; an image is
    an ``(H, W, 3)`` array or tensor (a tensor on the frontend's device is
    not copied)."""

    def extract(image) -> FrameFeatures:
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.asarray(image, np.float32))
        kp, desc = frontend.extract(image[None])
        return FrameFeatures(kp.y[0], kp.x[0], kp.valid[0], desc[0])

    return extract


def _track_program(
    cur: FrameFeatures, key: FrameFeatures, gen: torch.Generator, *,
    ransac_iters: int, inlier_thresh: float,
) -> TrackEstimate:
    m = mnn_match(cur.desc, cur.valid, key.desc, key.valid)
    # aligned correspondences over current-frame slots
    idx = m.index.long()
    p_key = torch.stack([key.y[idx], key.x[idx]], -1)
    p_cur = torch.stack([cur.y, cur.x], -1)
    est = ransac_homography(gen, p_key, p_cur, m.valid, iters=ransac_iters,
                            inlier_thresh=inlier_thresh)
    # est.h_flat maps current-frame points into the keyframe (p_key ≈ H·p_cur)
    return TrackEstimate(m.num, est.num_inliers,
                         sim2_from_homography(est.h_flat), est.h_flat)


def _read(est: TrackEstimate):
    """The estimate's one host read: ``(num_inliers, num_matches, rel)``."""
    head = torch.cat([torch.stack([est.num_inliers, est.num_matches]).float(),
                      est.rel_sim2.float()]).cpu().numpy()
    return int(head[0]), int(head[1]), head[2:].copy()


def _compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """`sim2_compose` of two host poses, float32."""
    return sim2_compose(torch.from_numpy(np.asarray(a, np.float32)),
                        torch.from_numpy(np.asarray(b, np.float32))).numpy()


class Tracker:
    """Sequential tracker with automatic keyframe promotion.

    ``extract``: callable ``image -> FrameFeatures``; defaults to the given
    frontend's.  When RANSAC inliers fall below ``min_inliers`` the current
    frame becomes the new keyframe; a pose is trusted only with at least
    ``trust_min_inliers`` inliers (clamped to [4, ``min_inliers``]), else
    the last trusted pose is held.
    """

    def __init__(
        self,
        frontend=None,
        extract: Optional[Callable] = None,
        min_inliers: int = 30,
        ransac_iters: int = 128,
        inlier_thresh: float = 3.0,
        seed: int = 0,
        trust_min_inliers: int = 15,
    ):
        if frontend is None and extract is None:
            raise ValueError("Tracker needs a frontend or an extract callable")
        self.extract = extract or frontend_extractor(frontend)
        self.min_inliers = min_inliers
        # the trust floor is decoupled from the promotion threshold
        # (`tracking.py:255-264` of the JAX package): a floor above the
        # threshold would freeze the pose, never trusted and never re-keyed
        self.trust_min_inliers = max(4, min(trust_min_inliers, min_inliers))
        self.seed = seed
        self._program = functools.partial(
            _track_program, ransac_iters=ransac_iters, inlier_thresh=inlier_thresh)
        self._keyframe: Optional[FrameFeatures] = None
        self._key_pose = np.zeros(4, np.float32)    # absolute Sim(2) of the keyframe
        self._last_pose = np.zeros(4, np.float32)   # last trusted absolute pose
        self._frame_index = 0
        # keyframe database for loop closure and pose-graph refinement:
        # features and the absolute pose each keyframe was anchored at
        self.keyframes: List[FrameFeatures] = []
        self.keyframe_poses: List[np.ndarray] = []
        self.keyframe_frames: List[int] = []

    def _add_keyframe(self, feats: FrameFeatures, pose: np.ndarray) -> int:
        self.keyframes.append(feats)
        self.keyframe_poses.append(np.asarray(pose, np.float32))
        self.keyframe_frames.append(self._frame_index)
        return len(self.keyframes) - 1

    def process(self, image) -> Dict[str, object]:
        """One frame -> tracking stats and the absolute Sim(2) pose, with
        ``key_id`` (the keyframe the pose is anchored to) and ``rel`` (the
        keyframe -> frame motion) for `refine_with_pose_graph`."""
        feats = self.extract(image)
        self._frame_index += 1
        if self._keyframe is None:
            self._keyframe = feats
            kid = self._add_keyframe(feats, np.zeros(4, np.float32))
            return {
                "pose": np.zeros(4, np.float32), "num_matches": 0,
                "num_inliers": 0, "is_keyframe": True, "tracked": True,
                "key_id": kid, "rel": np.zeros(4, np.float32),
            }

        est = self._program(feats, self._keyframe,
                            item_generator(self.seed, self._frame_index))
        n_inl, n_match, rel = _read(est)
        # trust the estimate only with a minimal inlier support: RANSAC over
        # too few matches fits noise, and a committed pose would corrupt
        # the rest of the trajectory
        trusted = n_inl >= self.trust_min_inliers
        key_id = len(self.keyframes) - 1
        if trusted:
            pose = _compose(self._key_pose, rel)
            self._last_pose = pose
        else:
            pose = self._last_pose                    # hold the last good pose
            rel = np.zeros(4, np.float32)
        promoted = n_inl < self.min_inliers
        if promoted:
            # re-anchor the new keyframe at the best available pose
            self._keyframe = feats
            self._key_pose = pose
            key_id = self._add_keyframe(feats, pose)
            rel = np.zeros(4, np.float32)             # the frame IS the keyframe
        return {
            "pose": np.asarray(pose, np.float32),
            "num_matches": n_match,
            "num_inliers": n_inl,
            "is_keyframe": promoted,
            "tracked": trusted,
            "key_id": key_id,
            "rel": rel,
        }

    def track(self, images: Iterable) -> List[Dict[str, object]]:
        return [self.process(im) for im in images]


def detect_loop_closures(
    tracker: Tracker,
    min_inliers: int = 25,
    min_gap: int = 2,
    seed: int = 1,
) -> List[Dict[str, object]]:
    """Match every keyframe pair ``(i, j)`` with ``j - i >= min_gap`` through
    the frame-tracking program; a pair with at least ``min_inliers`` RANSAC
    inliers gives a loop-closure edge whose measurement is the Sim(2)
    relative pose ``T_i^-1 ∘ T_j`` (the `slam.posegraph` edge convention)."""
    n = len(tracker.keyframes)
    closures: List[Dict[str, object]] = []
    for j in range(n):
        for i in range(0, j - min_gap + 1):
            est = tracker._program(tracker.keyframes[j], tracker.keyframes[i],
                                   item_generator(seed, i * n + j))
            n_inl, _, rel = _read(est)
            if n_inl >= min_inliers:
                closures.append({"i": i, "j": j, "rel": rel, "num_inliers": n_inl})
    return closures


def refine_with_pose_graph(
    results: List[Dict[str, object]],
    tracker: Tracker,
    closures: List[Dict[str, object]],
    loop_weight: float = 5.0,
    iters: int = 20,
) -> np.ndarray:
    """Pose-graph refinement of a tracked trajectory: odometry edges chain
    consecutive keyframes, loop edges re-observe old ones, and Gauss-Newton
    spreads the drift.  Returns refined absolute ``(N_frames, 4)`` poses,
    every frame recomposed as ``refined_keyframe_pose ∘ rel``.  The graph
    is solved on the keyframe features' device."""
    device = tracker.keyframes[0].desc.device
    kf_poses = torch.from_numpy(np.stack(tracker.keyframe_poses))   # (N, 4)
    n = kf_poses.shape[0]
    edges, meas, w = [], [], []
    for i in range(n - 1):
        edges.append((i, i + 1))
        meas.append(sim2_compose(sim2_inverse(kf_poses[i]), kf_poses[i + 1]).numpy())
        w.append(1.0)
    for c in closures:
        edges.append((c["i"], c["j"]))
        meas.append(c["rel"])
        w.append(loop_weight)

    if edges:
        graph = PoseGraph(
            poses=kf_poses.to(device),
            edges_ij=torch.as_tensor(np.asarray(edges, np.int64), device=device),
            measurements=torch.as_tensor(np.stack(meas).astype(np.float32),
                                         device=device),
            weights=torch.as_tensor(np.asarray(w, np.float32), device=device),
        )
        refined = optimize_pose_graph(graph, iters=iters).cpu().numpy()
    else:
        refined = kf_poses.numpy()

    out = np.zeros((len(results), 4), np.float32)
    last = np.zeros(4, np.float32)
    for f, r in enumerate(results):
        if r.get("tracked", False) or r.get("is_keyframe", False):
            # a promoted frame IS its keyframe (rel = 0): even when the
            # promotion was untrusted, its refined pose is refined[key_id]
            last = _compose(refined[r["key_id"]], r["rel"])
        out[f] = last
    return out
