"""COCO self-labeling: pseudo-label real images with an adapted MagicPoint
(`feature_point_cnn_tpu/selflabel/coco.py:29-205`).

Reads images, resizes them ratio-preserving and centre-crops them to the
training size, runs batched homography adaptation, and writes ``{image,
points}`` npz items (``image`` CHW float32 in [0, 1], ``points`` ``(3, N)``
``[x, y, conf]``), the item format both packages' ``read_npz_item`` read.

Each item's warps are drawn from a generator seeded by ``(seed, the item's
index in the full sorted file list)`` alone, so a sharded or resumed run
labels every item as a single run does.  Two levels of parallelism, as in
JAX: the file list splits across jobs by ``shard_index / num_shards``, and
with ``use_mesh`` each global batch of ``d * batch_size`` items splits over
the d ranks of a job's data mesh (`parallel/mesh.py`), ``batch_size`` a
rank; each rank labels and writes its own items.  Unlike JAX, whose
devices take ``batch_size / d`` items each, a rank runs the program shape
a single run runs: the card's convolutions may round differently at
another batch size, and the labels would then depend on the rank count.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
from feature_point_cnn_tpu_torch.parallel.mesh import make_mesh
from feature_point_cnn_tpu_torch.utils.image import ratio_preserving_crop, read_rgb

_IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


def load_and_crop(path: str, out_hw: Tuple[int, int]) -> Optional[np.ndarray]:
    """Ratio-preserving resize + centre crop: ``(H, W, 3)`` float32 RGB in
    [0, 1], or ``None`` where the file cannot be decoded."""
    img = read_rgb(path)
    if img is None:
        return None
    return ratio_preserving_crop(img, out_hw).astype(np.float32) / 255.0


def item_generator(seed: int, index: int) -> torch.Generator:
    """The generator of the item at ``index`` of the full sorted list."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _batched_reader(
    paths: List[Tuple[int, str]],
    out_hw: Tuple[int, int],
    batch_size: int,
    prefetch: int = 2,
) -> Iterable[Tuple[np.ndarray, List[str], List[int]]]:
    """Yields ``(images, names, global_indices)`` batches, read by a
    thread; an error in the thread is raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)

    def worker():
        try:
            images, names, idxs = [], [], []
            for gi, p in paths:
                img = load_and_crop(p, out_hw)
                if img is None:
                    continue
                images.append(img)
                names.append(p)
                idxs.append(gi)
                if len(images) == batch_size:
                    q.put((np.stack(images), names, idxs))
                    images, names, idxs = [], [], []
            if images:
                q.put((np.stack(images), names, idxs))
            q.put(None)
        except BaseException as e:  # handed to the consumer, which raises it
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is None:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def preprocess_folder(
    frontend: SuperPointFrontend,
    image_dir: str,
    output_dir: str,
    homo_config: HomographyConfig,
    batch_size: int = 16,
    seed: int = 0,
    shard_index: int = 0,
    num_shards: int = 1,
    limit: int = 0,
    use_mesh: bool = True,
    skip_existing: bool = True,
) -> int:
    """Label every image under ``image_dir`` into ``output_dir`` npz items
    and return the count this process wrote.

    With ``use_mesh`` under a process group, the items go to the d ranks
    of the data mesh in blocks of ``batch_size``, rank r taking blocks r,
    r + d, ... of this shard's list; written items are dropped from a
    rank's own blocks after that, so the split does not depend on when
    each rank lists the folder.  Without a group the mesh is this process
    alone.

    Each item's warps come from `item_generator` ``(seed, index in the full
    sorted list)``, so the labels do not depend on the shard or on the
    other items of a batch (at one ``batch_size``: the batch shape is part
    of the device program), and an interrupted run resumes by skipping
    written items (``skip_existing``) without changing the rest.  The tail
    batch is padded to ``batch_size``."""
    mesh = make_mesh() if use_mesh else None
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    all_paths = sorted(
        str(p) for p in Path(image_dir).iterdir() if p.suffix.lower() in _IMG_EXTS
    )
    # index BEFORE sharding/filtering: the generator is a function of the
    # position in the full sorted list, never of batch or shard layout
    paths = list(enumerate(all_paths))[shard_index::num_shards]
    if limit:
        paths = paths[:limit]
    if mesh is not None:
        # blocks of the list as it stands before written items are dropped:
        # a rank that lists the folder after another rank wrote to it takes
        # the same blocks
        paths = [p for i, p in enumerate(paths)
                 if (i // batch_size) % mesh.size == mesh.rank]
    n_assigned = len(paths)
    if skip_existing:
        paths = [
            (gi, p) for gi, p in paths
            if not (out / f"{Path(p).stem}.npz").exists()
        ]
        if len(paths) < n_assigned:
            print(
                f"[selflabel] resume: {n_assigned - len(paths)}/{n_assigned}"
                f" items already in {output_dir}, labeling the rest"
                " (existing labels are KEPT)"
            )
    out_hw = frontend.config.train_image_size
    written = 0
    for i, (images, names, idxs) in enumerate(
        _batched_reader(paths, out_hw, batch_size)
    ):
        n_real = len(names)
        if n_real < batch_size:
            pad = np.zeros((batch_size - n_real,) + images.shape[1:], images.dtype)
            images = np.concatenate([images, pad])
            idxs = idxs + [0] * (batch_size - n_real)
        gens = [item_generator(seed, gi) for gi in idxs]
        points = frontend.run_with_homography_adaptation(images, homo_config, gens)
        for j in range(n_real):
            name = Path(names[j]).stem
            chw = np.transpose(images[j], (2, 0, 1))
            np.savez_compressed(out / f"{name}.npz", image=chw, points=points[j])
            written += 1
        if (i + 1) % 10 == 0:
            print(f"[selflabel] {written}/{len(paths)} items -> {output_dir}")
    return written


def preprocess_coco(
    coco_path: str,
    magicpoint_weights: str,
    config: SuperPointConfig,
    batch_size: int = 16,
    limit: int = 0,
    shard_index: int = 0,
    num_shards: int = 1,
    skip_existing: bool = True,
    device=None,
) -> None:
    """Label ``train2014``/``test2014`` into ``train``/``test`` with the
    looser preprocess homography family; ``magicpoint_weights`` is a
    ``weights/*.npz`` snapshot."""
    frontend = SuperPointFrontend(config, weights_path=magicpoint_weights,
                                  device=device)
    homo = HomographyConfig.for_preprocess()
    for src, dst in (("train2014", "train"), ("test2014", "test")):
        n = preprocess_folder(
            frontend,
            str(Path(coco_path, src)),
            str(Path(coco_path, dst)),
            homo,
            batch_size=batch_size,
            limit=limit,
            shard_index=shard_index,
            num_shards=num_shards,
            skip_existing=skip_existing,
        )
        print(f"[selflabel] {src}: wrote {n} labeled items")
