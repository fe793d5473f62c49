"""Two-view evaluation harness: HPatches-protocol metrics over warped pairs
(`feature_point_cnn_tpu/eval/benchmark.py:48-120`).

Builds evaluation pairs from an image directory, a labeled npz dataset or
the synthetic-shape generator (`data/synthetic_shapes.py`, which draws with
``cv2``: without it ``--source synthetic`` raises an ``ImportError``) by
warping each image with a sampled homography, runs the frontend on both
views, and aggregates `eval.metrics` over the pairs.

Usage:
    python -m feature_point_cnn_tpu_torch.eval.benchmark \
        [--source synthetic|<dir>] [--weights-path weights/X.npz] \
        [--pairs 20] [--eps 3.0] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
from feature_point_cnn_tpu_torch.eval.metrics import matching_metrics, repeatability
from feature_point_cnn_tpu_torch.geometry.homography import sample_homography
from feature_point_cnn_tpu_torch.geometry.warp import warp_image
from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
from feature_point_cnn_tpu_torch.selflabel.coco import item_generator


def synthetic_images(n: int, shape: Tuple[int, int],
                     seed: int = 0) -> Iterable[np.ndarray]:
    """``n`` ``(H, W, 3)`` float32 scenes of the corner-rich primitives in
    turn, drawn at 4x and downscaled, as the JAX package's
    ``synthetic_images``; raises ``ImportError`` here, not when iterated,
    where ``cv2`` is missing."""
    try:
        import cv2  # noqa: F401  (the shape generator draws with it)
    except ImportError as e:
        raise ImportError(
            "--source synthetic draws its scenes with cv2, which is not "
            "installed; pass --source <image or npz directory>") from e
    from feature_point_cnn_tpu_torch.data.synthetic_shapes import (
        PRIMITIVES,
        SyntheticShapeGenerator,
    )

    gen = SyntheticShapeGenerator(
        np.random.default_rng(seed),
        image_size=(shape[0] * 4, shape[1] * 4),
        out_size=shape,
    )
    corner_rich = [p for p in PRIMITIVES if p not in ("ellipses", "gaussian_noise")]

    def images():
        for i in range(n):
            image, _ = gen.sample(corner_rich[i % len(corner_rich)])
            yield np.repeat(image[0][..., None], 3, axis=-1)

    return images()


def directory_images(path: str, shape: Tuple[int, int]) -> Iterable[np.ndarray]:
    """``(H, W, 3)`` float32 images of a directory: image files cropped to
    ``shape``, npz items as they are."""
    from feature_point_cnn_tpu_torch.data.datasets import read_npz_item
    from feature_point_cnn_tpu_torch.selflabel.coco import load_and_crop

    for p in sorted(Path(path).iterdir()):
        if p.suffix.lower() in (".jpg", ".jpeg", ".png", ".bmp"):
            img = load_and_crop(str(p), shape)
            if img is not None:
                yield img
        elif p.suffix == ".npz":
            yield read_npz_item(str(p))[0]


def aggregate(rows: List[Dict[str, float]]) -> Dict[str, float]:
    """Mean of each metric over the pairs where it is finite."""
    agg: Dict[str, float] = {"pairs": float(len(rows))}
    if rows:
        for k in rows[0]:
            vals = [r[k] for r in rows if np.isfinite(r[k])]
            agg[k] = float(np.mean(vals)) if vals else float("nan")
    return agg


def evaluate_pairs(
    frontend: SuperPointFrontend,
    images: Iterable[np.ndarray],
    homo_config: HomographyConfig,
    eps: float = 3.0,
    seed: int = 0,
    nn_thresh: float | None = None,
) -> Dict[str, float]:
    """Aggregate metrics over (image, warped image) pairs; pair ``i``'s
    homography comes from a generator seeded by ``(seed, i)``."""
    rows: List[Dict[str, float]] = []
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        hf = sample_homography(item_generator(seed, i), (h, w), homo_config)
        image = torch.as_tensor(np.asarray(img, np.float32), device=frontend.device)
        warped = warp_image(image, hf.to(frontend.device))
        kp1, d1 = frontend.extract(image[None])
        kp2, d2 = frontend.extract(warped[None])
        hf_np = hf.cpu().numpy()
        row = repeatability(kp1, kp2, hf_np, (h, w), eps)
        row.update(
            matching_metrics(kp1, d1, kp2, d2, hf_np, (h, w), eps,
                             nn_thresh=nn_thresh)
        )
        rows.append(row)
    return aggregate(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--weights-path", default=None,
                    help="weights/*.npz snapshot (random init if omitted)")
    ap.add_argument("--source", default="synthetic")
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--H", type=int, default=240)
    ap.add_argument("--W", type=int, default=320)
    ap.add_argument("--eps", type=float, default=3.0)
    ap.add_argument("--max-keypoints", type=int, default=512)
    ap.add_argument("--subpixel", action="store_true",
                    help="log-parabola subpixel keypoint refinement")
    ap.add_argument("--device", default=None, help="default: cuda")
    opt = ap.parse_args(argv)

    shape = (opt.H, opt.W)
    if opt.source == "synthetic":
        images = synthetic_images(opt.pairs, shape)
    else:
        images = list(directory_images(opt.source, shape))[: opt.pairs]
    cfg = SuperPointConfig(
        max_keypoints=opt.max_keypoints, subpixel_refine=opt.subpixel
    )
    frontend = SuperPointFrontend(cfg, weights_path=opt.weights_path,
                                  device=opt.device)
    out = evaluate_pairs(frontend, images, HomographyConfig(), eps=opt.eps)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
