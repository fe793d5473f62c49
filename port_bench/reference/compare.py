"""Judging the program's outputs against the reference's.

Keypoints are compared as sets of pixel positions: the program's bf16
forward puts a few keypoints elsewhere than the float32 reference (ties
at the threshold, at the N-th score and in NMS chains), so the share of
positions that the two do not share is a number with a limit, not an
exact test.  Scores and descriptors are compared at the shared positions,
matches as pairs of (frame position, keyframe position).
"""

from __future__ import annotations

import numpy as np


def _keys(kp: np.ndarray, n: int, w: int) -> np.ndarray:
    return (kp[:n, 0].astype(np.int64) * w + kp[:n, 1].astype(np.int64))


def frames(prog: dict, ref: dict, width: int) -> dict:
    """Per frame: ``kp_mismatch`` (1 - shared / the larger set),
    ``score_err`` and ``desc_err`` (the mean absolute score gap and the
    mean L2 descriptor gap over the shared positions: a single point's gap
    swings with the ties of the bf16 forward, a frame's mean does not), and
    the match pairs' ``shared`` and ``larger`` counts.  ``prog`` and ``ref``: ``num_valid``, ``kp``,
    ``match``, ``desc`` and ``key_kp`` as `reference.frame.serve` gives."""
    hw = 1 << 32
    out = {k: [] for k in ("kp_mismatch", "score_err", "desc_err",
                           "match_shared", "match_larger")}
    for i in range(len(prog["num_valid"])):
        np_, nr = int(prog["num_valid"][i]), int(ref["num_valid"][i])
        kp_p, kp_r = _keys(prog["kp"][i], np_, width), _keys(ref["kp"][i], nr, width)
        common, ip, ir = np.intersect1d(kp_p, kp_r, return_indices=True)
        out["kp_mismatch"].append(1.0 - len(common) / max(np_, nr) if max(np_, nr) else 0.0)
        if len(common):
            out["score_err"].append(float(np.abs(
                prog["kp"][i, ip, 2] - ref["kp"][i, ir, 2]).mean()))
            out["desc_err"].append(float(np.linalg.norm(
                prog["desc"][i, ip].astype(np.float32) - ref["desc"][i, ir], axis=-1).mean()))
        else:
            out["score_err"].append(0.0)
            out["desc_err"].append(0.0)
        pairs = []
        for side, kp, n in ((prog, kp_p, np_), (ref, kp_r, nr)):
            key = side["key_kp"][i]
            m = side["match"][i][:n]
            rows = np.nonzero(m >= 0)[0]
            if key is None or not len(rows):
                pairs.append(np.zeros(0, np.int64))
                continue
            kk = key[:, 0].astype(np.int64) * width + key[:, 1].astype(np.int64)
            pairs.append(kp[rows] * hw + kk[m[rows]])
        shared = len(np.intersect1d(pairs[0], pairs[1]))
        out["match_shared"].append(shared)
        out["match_larger"].append(max(len(pairs[0]), len(pairs[1])))
    return out


def frame_numbers(per_frame: dict) -> dict:
    """The numbers compared over every judged frame: the worst frame's
    keypoint mismatch and mean score and descriptor gaps, and the pooled
    share of match pairs that the two do not share."""
    larger = sum(per_frame["match_larger"])
    return {
        "kp_mismatch": max(per_frame["kp_mismatch"]),
        "score_err": max(per_frame["score_err"]),
        "desc_err": max(per_frame["desc_err"]),
        # no match on either side (no keyframe yet): nothing to disagree on
        "match_mismatch": 1.0 - sum(per_frame["match_shared"]) / larger if larger else 0.0,
    }


def frames_failed(per_frame: dict, limits: dict) -> int:
    """Frames whose own keypoint, score or descriptor number is over its
    limit."""
    return sum(
        any(per_frame[k][i] > limits[k] for k in ("kp_mismatch", "score_err", "desc_err"))
        for i in range(len(per_frame["kp_mismatch"])))


def maps(prog: dict, ref: dict) -> dict:
    """The forward's outputs: ``logits_err`` (largest absolute gap over the
    reference's largest magnitude), ``prob_err`` (largest absolute gap)
    and ``desc_err`` (largest L2 gap of a cell's unit descriptor)."""
    return {
        "logits_err": float(np.abs(prog["logits"] - ref["logits"]).max()
                            / max(float(np.abs(ref["logits"]).max()), 1e-30)),
        "prob_err": float(np.abs(prog["prob"] - ref["prob"]).max()),
        "desc_err": float(np.linalg.norm(prog["desc"] - ref["desc"], axis=-1).max()),
    }


def _leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """Each leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    med = float(np.median([ref[k] for k in keep]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def train(prog: dict, ref: dict, init: dict) -> dict:
    """Three steps from the same parameters: ``loss_gap`` (the worst step's
    relative loss gap) and ``loss_gap_step1``; ``grad_gap`` (step 1's
    clipped gradient: the worst leaf's gap of norms) and
    ``grad_diff_median`` (the median leaf's norm of the difference over its
    reference norm); ``update_gap`` (the parameters' change over the three
    steps: the worst leaf's gap of norms); and the three leaves with the
    largest gaps (``worst_leaves``, not a number).  Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out."""
    def norms(d):
        return {k: float(v.double().norm()) for k, v in d.items()}

    # step 1's gradient by direction too: each leaf's difference over its
    # reference norm (a gradient of other items, or of rounded arithmetic,
    # points elsewhere even where its norm is alike)
    diff = {k: float((prog["grad"][k] - ref["grad"][k]).double().norm())
            / max(float(ref["grad"][k].double().norm()), 1e-30) for k in ref["grad"]}

    g_ref, g_prog = norms(ref["grad"]), norms(prog["grad"])
    med = float(np.median(list(g_ref.values())))
    keep = [k for k, v in g_ref.items() if v >= 1e-3 * med]
    d_ref = norms({k: ref["params"][k] - init[k] for k in keep})
    d_prog = norms({k: prog["params"][k] - init[k] for k in keep})
    grad, update = _leaf_gaps(g_prog, g_ref, keep), _leaf_gaps(d_prog, d_ref, keep)
    steps = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    return {
        "loss_gap": max(steps),
        "loss_gap_step1": steps[0],
        "grad_gap": max(grad.values()),
        "update_gap": max(update.values()),
        "grad_diff_median": float(np.median([diff[k] for k in keep])),
        "worst_leaves": {"grad": sorted(grad, key=grad.get)[-3:],
                         "update": sorted(update, key=update.get)[-3:]},
    }
