"""The plain reference of the VGG SuperPoint + SuperGlue frame, and the
numbers its check compares.  Imports nothing of the port.

Detect and describe are the VGG forward (`models.vgg_forward`) and the
frame reference's keypoints (`frame.keypoints`: threshold, exact greedy
NMS, border, top N, bilinear descriptors), judged as the ResNet frame
cells judge them (`compare.frames`): ``kp_mismatch``, ``score_err``,
``desc_err``.

The matcher is judged alone: the plain SuperGlue (`superglue.match_pair`)
is fed the program's own outputs, the frame's and the keyframe's
keypoints, scores and f16 descriptors, so keypoint selection can neither
hide nor fake a matcher gap.

* ``assign_err``: per pair, the mean over the frame's valid rows of
  ``|log match_score - max_j Z_ij|`` (the program's log row maximum
  against the reference's), over the spread (largest less smallest) of
  the reference's log row maxima; the worst pair's.  Dense: every valid
  row counts, matched or not, and it is free of the scores' scale.
* ``best_mismatch``: pooled over the pairs, the share of rows that either
  side matches whose match differs (another column, or none on one side).
  The program's outputs hold a row's argmax only where it is a match
  (``match_index``), so this is taken over the matched rows.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from port_bench.reference import compare, models
from port_bench.reference.frame import keypoints
from port_bench.reference.superglue import match_pair

CHUNK = 8       # images a forward at once


@torch.no_grad()
def extract(cfg: dict, weights: dict, frames: np.ndarray, device, q) -> Dict[str, torch.Tensor]:
    """``(n, H, W, 1)`` u8 frames -> the top N keypoints of each: ``y``,
    ``x``, ``score`` ``(n, N)``, ``valid``, ``desc (n, N, D)``, by the
    plain VGG forward under the rounding ``q``."""
    out: Dict[str, List[torch.Tensor]] = {k: [] for k in ("y", "x", "score", "valid", "desc")}
    for s in range(0, len(frames), CHUNK):
        x = torch.from_numpy(frames[s:s + CHUNK]).to(device).permute(0, 3, 1, 2).float() / 255.0
        logits, desc = models.vgg_forward(weights, cfg, x, q)
        part = keypoints(models.prob_map(logits, cfg["cell"]), desc, cfg)
        for k in out:
            out[k].append(part[k])
    return {k: torch.cat(v) for k, v in out.items()}


def detect_frames(prog: dict, ref: Dict[str, torch.Tensor], width: int) -> dict:
    """`compare.frames` of the program's ``num_valid``, ``kp``, ``desc``
    against the reference's extract, matches left out."""
    b = len(prog["num_valid"])
    want = {"num_valid": ref["valid"].sum(1).cpu().numpy(),
            "kp": torch.stack([ref["y"], ref["x"], ref["score"]], -1).cpu().numpy(),
            "desc": ref["desc"].cpu().numpy()}
    none = {"match": np.full(prog["kp"].shape[:2], -1), "key_kp": [None] * b}
    return compare.frames({**prog, **none}, {**want, **none}, width)


def detect_numbers(per_frame: dict) -> dict:
    numbers = compare.frame_numbers(per_frame)
    return {k: numbers[k] for k in ("kp_mismatch", "score_err", "desc_err")}


def match_pairs(weights: dict, cfg: dict, frame: dict, key: dict, image_size, device,
                q=None) -> List[dict]:
    """The plain SuperGlue of each frame against its keyframe: ``frame``
    holds ``num_valid (B,)``, ``kp (B, N, 3)``, ``desc (B, N, D)``;
    ``key`` one frame's ``num``, ``kp``, ``desc``; numpy arrays as the
    program returned them."""
    kw = {} if q is None else {"q": q}
    kc = int(key["num"])
    kp1 = torch.from_numpy(np.asarray(key["kp"][:kc], np.float32)).to(device)
    d1 = torch.from_numpy(np.asarray(key["desc"][:kc])).to(device)
    out = []
    for b in range(len(frame["num_valid"])):
        c = int(frame["num_valid"][b])
        kp0 = torch.from_numpy(np.asarray(frame["kp"][b, :c], np.float32)).to(device)
        d0 = torch.from_numpy(np.asarray(frame["desc"][b, :c])).to(device)
        r = match_pair(weights, cfg, kp0, d0, kp1, d1, image_size, **kw)
        out.append({"index": r["index"].cpu().numpy(),
                    "log_best": None if r["Z"] is None
                    else r["Z"][:-1, :-1].amax(1).cpu().numpy()})
    return out


def matcher_pairs(index: np.ndarray, score: np.ndarray, num: np.ndarray,
                  ref: List[dict]) -> dict:
    """Per pair: ``assign_err`` (None where the reference has no
    assignment) and the matched rows' ``differ`` and ``matched`` counts,
    for ``index (B, N)``, ``score (B, N)`` and ``num (B,)`` of one call."""
    out = {"assign_err": [], "differ": [], "matched": []}
    for b, r in enumerate(ref):
        c = int(num[b])
        mine, theirs = np.asarray(index[b, :c], np.int64), r["index"]
        either = (mine >= 0) | (theirs >= 0)
        out["differ"].append(int((either & (mine != theirs)).sum()))
        out["matched"].append(int(either.sum()))
        if r["log_best"] is None or not c:
            out["assign_err"].append(None)
            continue
        best = r["log_best"]
        spread = max(float(best.max() - best.min()), 1e-6)
        with np.errstate(divide="ignore"):
            gap = np.abs(np.log(np.asarray(score[b, :c], np.float64)) - best)
        out["assign_err"].append(float(gap.mean()) / spread)
    return out


def matcher_numbers(per_pair: dict) -> dict:
    errs = [e for e in per_pair["assign_err"] if e is not None]
    matched = sum(per_pair["matched"])
    return {"assign_err": max(errs) if errs else 0.0,
            "best_mismatch": sum(per_pair["differ"]) / matched if matched else 0.0}
