"""Synthetic dataset generation CLI (`feature_point_cnn_tpu/data/generate.py`).

Writes ``<out>/{train,test}/<primitive>_<i>.npz`` with ``{image: (1, 240,
320) float32, points: (3, N) [x, y, conf]}``, one process per (split,
primitive) task.  Every task seeds its own `numpy.random.Generator` from
(seed, split, primitive) with the JAX package's ``zlib`` rule, so both
packages write the same files.  Needs ``cv2`` (the shape generator draws
with it).

Usage:  python -m feature_point_cnn_tpu_torch.data.generate OUT_DIR \
            [--train-size 3000] [--test-size 500] [--seed 0] [--workers N]
"""

from __future__ import annotations

import argparse
import zlib
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from feature_point_cnn_tpu_torch.data.synthetic_shapes import (
    PRIMITIVES,
    SyntheticShapeGenerator,
)


def task_seed(seed: int, split: str, primitive: str) -> int:
    """The seed of one (split, primitive) task; ``zlib.crc32`` is stable
    across interpreters, where ``hash()`` is randomized."""
    tag = zlib.crc32(f"{split}/{primitive}".encode())
    return seed * 1_000_003 + tag % 1_000_003


def generate_task(out_dir: str, primitive: str, size: int, seed: int) -> int:
    rng = np.random.default_rng(seed)
    gen = SyntheticShapeGenerator(rng)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for i in range(size):
        image, points = gen.sample(primitive)
        np.savez_compressed(out / f"{primitive}_{i}.npz", image=image, points=points)
    return size


def generate_dataset(
    path: str,
    train_size: int = 3000,
    test_size: int = 500,
    seed: int = 0,
    workers: int | None = None,
) -> None:
    if train_size < 0 or test_size < 0:
        raise ValueError(
            f"split sizes must be >= 0, got train={train_size} test={test_size}"
        )
    tasks = [
        (str(Path(path, split)), primitive, size, task_seed(seed, split, primitive))
        for split, size in (("train", train_size), ("test", test_size))
        for primitive in PRIMITIVES
    ]
    with ProcessPoolExecutor(max_workers=workers) as pool:
        futures = [pool.submit(generate_task, *t) for t in tasks]
        total = sum(f.result() for f in futures)
    print(f"wrote {total} items under {path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", type=str)
    ap.add_argument("--train-size", type=int, default=3000)
    ap.add_argument("--test-size", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=None)
    opt = ap.parse_args(argv)
    generate_dataset(opt.path, opt.train_size, opt.test_size, opt.seed, opt.workers)


if __name__ == "__main__":
    main()
