"""A real-image corpus for the self-labeling stage
(`feature_point_cnn_tpu/data/real_corpus.py`).

Expands the photographs installed with Python packages (sklearn's sample
photos, matplotlib's grace_hopper, pygame's images, material textures)
into a corpus of DISTINCT crops: random window, scale, flip, rotation by
90 degrees, brightness/contrast jitter, laid out as ``<out>/train2014`` and
``<out>/test2014`` JPEGs so the COCO self-labeling flow runs on it
unchanged.  Every pixel comes from a real source image.  The draws come from
one `numpy.random.Generator` in the JAX package's order, so both packages
write the same files from the same photos.  ``cv2`` and ``PIL`` are imported
inside the functions that need them.

Usage:
  python -m feature_point_cnn_tpu_torch.data.real_corpus OUT_DIR \
      --train-size 6000 --test-size 600
"""

from __future__ import annotations

import argparse
import glob
import json
import sysconfig
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

# Seed photos installed with Python packages.  Processed/binary duplicates
# of the pygame webcam scene (mask/thresh variants) are excluded: near-
# duplicate binary frames add no texture diversity.  Real material-photo
# textures shipped with simulation packages (wood/marble/tile/metal/skin/
# grass/foil surfaces) and scene montages add ~30 distinct sources.
_SP = sysconfig.get_paths()["purelib"]
DEFAULT_PATTERNS = (
    f"{_SP}/sklearn/datasets/images/*.jpg",
    f"{_SP}/matplotlib/mpl-data/sample_data/grace_hopper.jpg",
    f"{_SP}/pygame/docs/generated/_images/*.jpg",
    f"{_SP}/pygame/docs/generated/_images/*.png",
    f"{_SP}/pygame/examples/data/*.jpg",
    # real photographed material surfaces (kitchen/adroit assets)
    f"{_SP}/gymnasium_robotics/envs/assets/kitchen_franka/kitchen_assets/textures/*.png",
    f"{_SP}/gymnasium_robotics/envs/assets/adroit_hand/resources/textures/*.png",
    # natural outdoor surfaces + montages
    f"{_SP}/dm_control/locomotion/arenas/assets/outdoor_natural/*.png",
    f"{_SP}/dm_control/suite/dog_assets/*.png",
    f"{_SP}/dm_control/suite/all_domains.png",
    f"{_SP}/dm_control/locomotion/soccer/soccer.png",
    f"{_SP}/dm_control/locomotion/soccer/assets/pitch/pitch_xs.png",
    f"{_SP}/dm_control/blender/mujoco_exporter/doc/*.png",
    # labmaze wall/floor surface photos; color-recolor variants of the same
    # texture are collapsed by the grayscale dedup below
    f"{_SP}/labmaze/assets/style_*/*_d.png",
)
_EXCLUDE_SUBSTRINGS = ("mask", "thresh", "_lofi", "_logo", "logo2")
MIN_SOURCE_HW = 160
# sources whose grayscale correlation with an already-kept source exceeds
# this are dropped (labmaze ships the same surface recolored per style —
# in grayscale those are near-identical and would leak train<->test)
_DEDUP_CORR = 0.9


def _gray_signature(img: np.ndarray, size: int = 48) -> np.ndarray:
    """Normalized downsampled grayscale signature for near-duplicate checks
    (invariant to recoloring and mild brightness shifts)."""
    import cv2

    g = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY).astype(np.float32)
    g = cv2.resize(g, (size, size), interpolation=cv2.INTER_AREA)
    g -= g.mean()
    n = np.linalg.norm(g)
    return g / n if n > 0 else g


def collect_source_images(
    patterns: Sequence[str] = DEFAULT_PATTERNS,
    min_hw: int = MIN_SOURCE_HW,
) -> List[np.ndarray]:
    """Load every usable seed image as ``(H, W, 3)`` uint8 RGB, dropping
    near-duplicates (grayscale correlation > ``_DEDUP_CORR`` with an
    already-kept source — recolored texture variants leak between the
    source-partitioned train/test splits otherwise)."""
    from PIL import Image

    out: List[np.ndarray] = []
    sigs: List[np.ndarray] = []
    for pattern in patterns:
        for path in sorted(glob.glob(pattern)):
            name = Path(path).name.lower()
            if any(s in name for s in _EXCLUDE_SUBSTRINGS):
                continue
            try:
                img = Image.open(path).convert("RGB")
            except Exception:
                continue
            if img.width < min_hw or img.height < min_hw:
                continue
            arr = np.asarray(img)
            sig = _gray_signature(arr)
            if any(abs(float((sig * s).sum())) > _DEDUP_CORR for s in sigs):
                continue
            out.append(arr)
            sigs.append(sig)
    return out


def _random_crop(
    rng: np.random.Generator, src: np.ndarray, out_hw: Tuple[int, int]
) -> np.ndarray:
    """One distinct reframing: random window at the target aspect ratio and
    a random scale, resized to ``out_hw``, with flip / 90°-rotation /
    photometric jitter."""
    import cv2

    h, w = src.shape[:2]
    out_h, out_w = out_hw
    if rng.random() < 0.25:
        src = np.ascontiguousarray(np.rot90(src, rng.integers(1, 4)))
        h, w = src.shape[:2]

    aspect = out_w / out_h
    # largest target-aspect window that fits, scaled down by s
    max_w = min(w, h * aspect)
    s = rng.uniform(0.35, 1.0)
    crop_w = max(int(max_w * s), 32)
    crop_h = max(int(crop_w / aspect), 24)
    x0 = rng.integers(0, w - crop_w + 1)
    y0 = rng.integers(0, h - crop_h + 1)
    crop = src[y0 : y0 + crop_h, x0 : x0 + crop_w]
    crop = cv2.resize(crop, (out_w, out_h), interpolation=cv2.INTER_AREA)

    if rng.random() < 0.5:
        crop = crop[:, ::-1]
    # mild photometric jitter (the heavy augmentation happens on-device at
    # train time; this only decorrelates crops of the same source)
    gain = rng.uniform(0.85, 1.15)
    bias = rng.uniform(-12, 12)
    crop = np.clip(crop.astype(np.float32) * gain + bias, 0, 255)
    return crop.astype(np.uint8)


def _texture_energy(crop: np.ndarray) -> float:
    """Mean Sobel gradient magnitude of the gray crop in [0, 1] units."""
    import cv2

    g = cv2.cvtColor(crop, cv2.COLOR_RGB2GRAY).astype(np.float32) / 255.0
    gx = cv2.Sobel(g, cv2.CV_32F, 1, 0)
    gy = cv2.Sobel(g, cv2.CV_32F, 0, 1)
    return float(np.sqrt(gx * gx + gy * gy).mean())


# Crops below this gradient floor are rejected (re-sampled): flat regions
# (sky, page margins, solid UI backgrounds) carry no interest points, so the
# self-label teacher correctly labels them empty — and a corpus full of
# empty labels starves the joint phase (measured round 2: 4 of 6 test crops
# were flat, teacher prob ceiling ~6e-5 on them).  Live crops measured
# 0.07-0.33 on this scale.
MIN_TEXTURE_ENERGY = 0.05
_CROP_ATTEMPTS = 12


def _textured_crop(
    rng: np.random.Generator,
    srcs: List[np.ndarray],
    out_hw: Tuple[int, int],
) -> Tuple[np.ndarray, int]:
    """Sample crops until one clears the texture floor (best-of-N fallback
    so all-flat sources cannot loop forever).  Returns ``(crop, source
    index within srcs)`` so evals can group held-out items by source."""
    best, best_e, best_j = None, -1.0, -1
    for _ in range(_CROP_ATTEMPTS):
        j = int(rng.integers(0, len(srcs)))
        crop = _random_crop(rng, srcs[j], out_hw)
        e = _texture_energy(crop)
        if e > best_e:
            best, best_e, best_j = crop, e, j
        if e >= MIN_TEXTURE_ENERGY:
            break
    return best, best_j


def build_corpus(
    out_dir: str,
    train_size: int = 6000,
    test_size: int = 600,
    out_hw: Tuple[int, int] = (240, 320),
    seed: int = 0,
    patterns: Sequence[str] = DEFAULT_PATTERNS,
) -> Tuple[int, int]:
    """Write ``train2014``/``test2014`` JPEG splits; returns written counts.

    Source images are partitioned between the splits (4:1) so test crops
    never share pixels with train crops."""
    import cv2

    sources = collect_source_images(patterns)
    if len(sources) < 2:
        raise RuntimeError(
            f"need at least 2 seed images, found {len(sources)}"
        )
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(sources))
    n_test_src = max(1, len(sources) // 5)
    test_src = [sources[i] for i in order[:n_test_src]]
    train_src = [sources[i] for i in order[n_test_src:]]

    counts = []
    manifest = {"n_sources": len(sources)}
    for split, srcs, src_ids, n_items in (
        ("train2014", train_src, [int(i) for i in order[n_test_src:]], train_size),
        ("test2014", test_src, [int(i) for i in order[:n_test_src]], test_size),
    ):
        split_dir = Path(out_dir, split)
        split_dir.mkdir(parents=True, exist_ok=True)
        for i in range(n_items):
            crop, j = _textured_crop(rng, srcs, out_hw)
            # global source id in the filename -> per-source eval grouping
            cv2.imwrite(
                str(split_dir / f"real_s{src_ids[j]:03d}_{i:06d}.jpg"),
                cv2.cvtColor(crop, cv2.COLOR_RGB2BGR),
                [cv2.IMWRITE_JPEG_QUALITY, 92],
            )
        counts.append(n_items)
        manifest[split] = {"sources": src_ids, "items": n_items}
        print(f"[real_corpus] {split}: {n_items} crops from {len(srcs)} sources")
    Path(out_dir, "sources.json").write_text(json.dumps(manifest, indent=1))
    return counts[0], counts[1]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir")
    p.add_argument("--train-size", type=int, default=6000)
    p.add_argument("--test-size", type=int, default=600)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    build_corpus(
        a.out_dir, a.train_size, a.test_size, (a.height, a.width), a.seed
    )


if __name__ == "__main__":
    main()
