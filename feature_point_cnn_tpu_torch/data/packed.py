"""Packed single-file dataset splits: memmap-able, zero-decode batch reads
(`feature_point_cnn_tpu/data/packed.py`), numpy only.

Three flat arrays a split that numpy can memmap, so a batch read is a
fancy-index copy with no decompression and no per-item files:

    <root>/<split>/images.npy   (N, H, W, C) uint8
    <root>/<split>/points.npy   (N, P, 2)    float32, (y, x), padded
    <root>/<split>/counts.npy   (N,)         int32   valid points per item
    <root>/<split>/meta.json    {"n", "height", "width", "channels",
                                 "max_points"}

Images are stored uint8, the quantization every real image has on entry.
``pack_dataset`` converts an ``.npz`` tree (`data/datasets.py`'s on-disk
contract) in one pass; both packages write the same arrays.  The device
loader (`data/device_store.py`) uploads such a split once.

CLI:  python -m feature_point_cnn_tpu_torch.data.packed SRC_NPZ_DIR OUT_DIR
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np


def pack_split(
    src_split_dir: str,
    out_split_dir: str,
    max_points: Optional[int] = None,
    read_item=None,
) -> Dict[str, int]:
    """Convert one ``<split>/*.npz`` directory into packed arrays.

    ``max_points`` defaults to the true maximum over the split; larger point
    lists are truncated (matching `datasets._assemble_batch` semantics).
    """
    if read_item is None:
        from feature_point_cnn_tpu_torch.data.datasets import read_npz_item

        read_item = read_npz_item
    items = sorted(str(p) for p in Path(src_split_dir).glob("*.npz"))
    if not items:
        raise FileNotFoundError(f"no .npz items under {src_split_dir}")

    with ThreadPoolExecutor(8) as pool:
        first_img, _ = read_item(items[0])
        h, w, c = first_img.shape
        # grayscale repeated to 3 channels (the loader contract) packs as 1
        gray = c == 3 and bool(
            np.all(first_img[..., :1] == first_img[..., 1:])
        )
        if gray:
            c = 1
        if max_points is None:
            max_points = 1
            for _, pts in pool.map(read_item, items):
                max_points = max(max_points, len(pts))

        out = Path(out_split_dir)
        out.mkdir(parents=True, exist_ok=True)
        n = len(items)
        images = np.lib.format.open_memmap(
            out / "images.npy", mode="w+", dtype=np.uint8, shape=(n, h, w, c)
        )
        points = np.lib.format.open_memmap(
            out / "points.npy", mode="w+", dtype=np.float32,
            shape=(n, max_points, 2),
        )
        counts = np.lib.format.open_memmap(
            out / "counts.npy", mode="w+", dtype=np.int32, shape=(n,)
        )
        points[:] = 0.0

        def write(i_path):
            i, path = i_path
            img, pts = read_item(path)
            if gray:
                img = img[..., :1]
            images[i] = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
            k = min(len(pts), max_points)
            points[i, :k] = pts[:k]
            counts[i] = k

        list(pool.map(write, enumerate(items)))
    images.flush(); points.flush(); counts.flush()
    meta = {
        "n": n, "height": h, "width": w, "channels": c,
        "max_points": int(max_points),
    }
    (out / "meta.json").write_text(json.dumps(meta))
    return meta


def pack_dataset(src_dir: str, out_dir: str, splits=("train", "test")) -> None:
    for split in splits:
        if (Path(src_dir) / split).is_dir():
            meta = pack_split(
                str(Path(src_dir) / split), str(Path(out_dir) / split)
            )
            print(f"packed {split}: {meta}")


def is_packed(path: str, split: str) -> bool:
    return (Path(path) / split / "images.npy").is_file()


class PackedPointDataset:
    """Memmap-backed dataset, API-compatible with ``NpzPointDataset`` plus a
    vectorized ``read_batch`` fast path the loader prefers."""

    def __init__(self, path: str, split: str, seed: int = 0, size: int = 0):
        root = Path(path) / split
        self.meta = json.loads((root / "meta.json").read_text())
        self.images = np.load(root / "images.npy", mmap_mode="r")
        self.points = np.load(root / "points.npy", mmap_mode="r")
        self.counts = np.load(root / "counts.npy", mmap_mode="r")
        index = np.arange(self.meta["n"])
        np.random.default_rng(seed).shuffle(index)
        if size:
            index = index[:size]
        self.index = index

    def __len__(self) -> int:
        return len(self.index)

    def _to_float_image(self, img_u8: np.ndarray) -> np.ndarray:
        img = img_u8.astype(np.float32) / 255.0
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        return img

    def read(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        i = int(self.index[index])
        img = self._to_float_image(np.asarray(self.images[i]))
        pts = np.asarray(self.points[i, : self.counts[i]], np.float32)
        return img, pts

    def read_batch(self, idxs, max_points: int) -> Dict[str, np.ndarray]:
        """Fixed-shape batch in one fancy-index copy (no per-item decode).

        Images stay ``uint8`` with the stored channel count: the float
        conversion and the gray->RGB repeat happen on the device inside the
        step (`train/steps.py::_prep_images`), which shrinks both host work
        and the host->device copy up to 12x.
        """
        ids = np.sort(self.index[np.asarray(idxs)])  # sorted -> sequential IO
        images = np.asarray(self.images[ids])
        stored = self.points.shape[1]
        pts = np.zeros((len(ids), max_points, 2), np.float32)
        k = min(stored, max_points)
        pts[:, :k] = self.points[ids, :k]
        counts = np.minimum(self.counts[ids], max_points)
        valid = np.arange(max_points)[None, :] < counts[:, None]
        return {"image": images, "points": pts, "points_valid": valid}


def open_dataset(path: str, split: str, seed: int = 0, size: int = 0):
    """Packed if available, else per-item npz."""
    if is_packed(path, split):
        return PackedPointDataset(path, split, seed=seed, size=size)
    from feature_point_cnn_tpu_torch.data.datasets import NpzPointDataset

    return NpzPointDataset(path, split, seed=seed, size=size)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src", help="directory with <split>/*.npz")
    ap.add_argument("out", help="output directory for packed splits")
    ap.add_argument("--splits", nargs="*", default=["train", "test"])
    opt = ap.parse_args(argv)
    pack_dataset(opt.src, opt.out, splits=tuple(opt.splits))


if __name__ == "__main__":
    main()
