"""HPatches-format evaluation on the published directory layout
(`feature_point_cnn_tpu/eval/hpatches.py:42-180`):

    hpatches-sequences-release/
      i_ajuntament/ 1.ppm .. 6.ppm  H_1_2 .. H_1_6
      v_abstract/   1.ppm .. 6.ppm  H_1_2 .. H_1_6
      ...

``H_1_k`` is a row-major 3x3 matrix mapping image-1 pixel coordinates
(x, y, 1) to image-k coordinates.  The SuperPoint protocol (arXiv:1712.07629
§7.3) resizes every image to 240x320 and scales the homography with it;
sizes may differ within a sequence, so each side gets its own scale:
``H' = S_k @ H @ S_1^-1``, entering the framework as ``mat2flat(inv(H'))``.
Images are read as gray (BT.601) and resized with ``INTER_AREA``'s
arithmetic, without ``cv2`` (`utils/image.py`).

Usage:
    python -m feature_point_cnn_tpu_torch.eval.hpatches \
        --root /path/to/hpatches-sequences-release [--weights weights/X.npz] \
        [--eps 3.0] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from feature_point_cnn_tpu_torch.utils.image import read_gray, resize_area


def _scale_matrix(src_hw: Tuple[int, int], dst_hw: Tuple[int, int]) -> np.ndarray:
    """Pixel-coordinate scaling (x, y, 1 homogeneous) for a resize."""
    sy = dst_hw[0] / src_hw[0]
    sx = dst_hw[1] / src_hw[1]
    return np.diag([sx, sy, 1.0]).astype(np.float64)


def hpatches_flat_homography(
    h_mat: np.ndarray,
    src1_hw: Tuple[int, int],
    srck_hw: Tuple[int, int],
    dst_hw: Tuple[int, int],
) -> np.ndarray:
    """HPatches ``H_1_k`` (3x3, x/y convention, original resolutions) ->
    the framework's flat homography at the resized resolution, such that
    ``warp_points(p1_yx, h_flat)`` lands view-1 keypoints in view k."""
    h = np.asarray(h_mat, np.float64)
    h_resized = (
        _scale_matrix(srck_hw, dst_hw) @ h @ np.linalg.inv(_scale_matrix(src1_hw, dst_hw))
    )
    # warp_points applies inv(flat2mat(h_flat)) in (x, y) space
    flat9 = np.linalg.inv(h_resized).reshape(9)
    return (flat9 / flat9[8])[:8].astype(np.float32)


def load_image(path: str, shape: Tuple[int, int]) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Read as gray and resize to ``shape``: ``(H, W, 3)`` float32 in [0, 1]
    and the ORIGINAL ``(H, W)`` (for the homography's scale)."""
    img = read_gray(path)
    src_hw = img.shape[:2]
    img = resize_area(img, shape)
    rgb = np.repeat(img[..., None].astype(np.float32) / 255.0, 3, axis=-1)
    return rgb, src_hw


def iter_sequences(root: str) -> Iterator[Tuple[str, Path]]:
    """Yield ``(name, dir)`` for every HPatches sequence under ``root``."""
    for d in sorted(Path(root).iterdir()):
        if d.is_dir() and (d / "1.ppm").exists() and (d / "H_1_2").exists():
            yield d.name, d


def evaluate_hpatches(
    frontend,
    root: str,
    shape: Tuple[int, int] = (240, 320),
    eps: float = 3.0,
    max_sequences: Optional[int] = None,
    nn_thresh: Optional[float] = None,
) -> Dict[str, Dict[str, float]]:
    """Run the SuperPoint HPatches protocol; aggregates overall and per
    split (``i_*`` illumination / ``v_*`` viewpoint prefixes)."""
    from feature_point_cnn_tpu_torch.eval.benchmark import aggregate
    from feature_point_cnn_tpu_torch.eval.metrics import (
        matching_metrics,
        repeatability,
    )

    rows: List[Tuple[str, Dict[str, float]]] = []
    n_seq = 0
    for name, d in iter_sequences(root):
        if max_sequences is not None and n_seq >= max_sequences:
            break
        n_seq += 1
        img1, hw1 = load_image(d / "1.ppm", shape)
        kp1, desc1 = frontend.extract(img1[None])
        for k in range(2, 7):
            hpath = d / f"H_1_{k}"
            ipath = d / f"{k}.ppm"
            if not (hpath.exists() and ipath.exists()):
                continue
            imgk, hwk = load_image(ipath, shape)
            h_mat = np.loadtxt(hpath).reshape(3, 3)
            h_flat = hpatches_flat_homography(h_mat, hw1, hwk, shape)
            kpk, desck = frontend.extract(imgk[None])
            row = repeatability(kp1, kpk, h_flat, shape, eps)
            row.update(
                matching_metrics(
                    kp1, desc1, kpk, desck, h_flat, shape, eps,
                    nn_thresh=nn_thresh,
                )
            )
            rows.append((name, row))

    return {
        "overall": aggregate([r for _, r in rows]),
        "illumination": aggregate([r for n, r in rows if n.startswith("i_")]),
        "viewpoint": aggregate([r for n, r in rows if n.startswith("v_")]),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True,
                    help="hpatches-sequences-release directory")
    ap.add_argument("--weights", default=None,
                    help="default: the pinned weights/RELEASED snapshot")
    ap.add_argument("--H", type=int, default=240)
    ap.add_argument("--W", type=int, default=320)
    ap.add_argument("--eps", type=float, default=3.0)
    ap.add_argument("--max-keypoints", type=int, default=512)
    ap.add_argument("--max-sequences", type=int, default=None)
    ap.add_argument("--subpixel", action="store_true")
    ap.add_argument("--device", default=None, help="default: cuda")
    opt = ap.parse_args(argv)

    from feature_point_cnn_tpu_torch.config import SuperPointConfig
    from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
    from feature_point_cnn_tpu_torch.utils.weights import released_path

    cfg = SuperPointConfig(
        max_keypoints=opt.max_keypoints, subpixel_refine=opt.subpixel
    )
    frontend = SuperPointFrontend(cfg, weights_path=opt.weights or released_path(),
                                  device=opt.device)
    out = evaluate_hpatches(
        frontend, opt.root, (opt.H, opt.W), eps=opt.eps,
        max_sequences=opt.max_sequences,
    )
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
