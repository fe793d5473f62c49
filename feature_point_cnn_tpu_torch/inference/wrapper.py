"""Serving front end: image batch -> keypoints + descriptors (+ matches).

Port of `feature_point_cnn_tpu/inference/wrapper.py`: `extract_fn`
(`:33-66`), `adaptation_fn` (`:69-74`), `SuperPointFrontend.extract`/`run`/
`run_with_homography_adaptation` (`:134-199`), and the packed frame program
of ``export_pjrt`` (input prep `:298-307`, frame `:351-387`) as
`SuperPointFrontend.frame`.  PyTorch runs eagerly, so there is nothing to
export: the frame program is a method.  `load_state` is `load_variables`
(`:77-95`): weights come from a ``weights/*.npz`` snapshot or from a
directory of the port's checkpoints (`utils/checkpoint.py`); the JAX
package's orbax directories need orbax, and with it JAX, so the port does
not read them.  `SuperPointFrontend.extract_sharded` (`:139-175`) splits a
batch over the ranks of a data mesh (`parallel/mesh.py`): each rank runs
`extract_fn` on its rows and every rank gets the whole batch back.
StableHLO/PJRT export (ROADMAP §1 item 7) is not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
from feature_point_cnn_tpu_torch.device import resolve_device
from feature_point_cnn_tpu_torch.models.fold import fold_batchnorm
from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
from feature_point_cnn_tpu_torch.ops.descriptors import sample_descriptors
from feature_point_cnn_tpu_torch.ops.detection import (
    Keypoints,
    decode_prob_map,
    extract_keypoints,
    extract_keypoints_from_scores,
    keypoints_to_numpy,
    refine_keypoints,
)
from feature_point_cnn_tpu_torch.ops.kernels import use_kernel
from feature_point_cnn_tpu_torch.ops.kernels.decode import decode_threshold_cuda
from feature_point_cnn_tpu_torch.ops.matching import mnn_match
from feature_point_cnn_tpu_torch.selflabel.adaptation import (
    Generators,
    homography_adaptation,
)
from feature_point_cnn_tpu_torch.utils import checkpoint as ckpt
from feature_point_cnn_tpu_torch.utils.weights import load_variables


def extract_fn(
    model: SuperPoint, images: torch.Tensor, config: SuperPointConfig
) -> Tuple[Keypoints, torch.Tensor]:
    """Forward -> decode -> NMS -> top-K -> descriptor sampling.

    With the decode kernel on, the thresholded map comes straight from the
    logits and the raw prob map is decoded only for subpixel refinement.
    """
    h, w = images.shape[1:3]
    logits, desc_map = model.features(images)
    prob = None
    if use_kernel(config.use_cuda_decode, logits):
        scores = decode_threshold_cuda(logits, config.cell, config.confidence_thresh)
        kp = extract_keypoints_from_scores(scores, config)
    else:
        prob = decode_prob_map(logits, config.cell)
        kp = extract_keypoints(prob, config)
    if config.subpixel_refine:
        # refine on the RAW prob map: the thresholded map zeroes
        # sub-threshold neighbours and would bias the fit
        if prob is None:
            prob = decode_prob_map(logits, config.cell)
        kp = refine_keypoints(prob, kp)
    return kp, sample_descriptors(desc_map, kp, h, w)


def adaptation_prob_fn(model: SuperPoint, config: SuperPointConfig):
    """The probability map adaptation aggregates: ``(M, H, W, 3)`` images
    -> ``(M, H, W)``, through the decode kernel where its gate is on."""
    def prob_fn(x: torch.Tensor) -> torch.Tensor:
        logits, _ = model.features(x, enable_descriptor=False)
        if use_kernel(config.use_cuda_decode, logits):
            # threshold 0 keeps every probability (where(p >= 0, p, 0) = p),
            # so the kernel returns the raw decoded map
            return decode_threshold_cuda(logits, config.cell, 0.0)
        return decode_prob_map(logits, config.cell)

    return prob_fn


def adaptation_fn(
    model: SuperPoint, images: torch.Tensor, gen: Generators,
    config: SuperPointConfig, homo_config: HomographyConfig,
) -> torch.Tensor:
    """Homography adaptation of the model's own probability map: ``(B, H,
    W, 3)`` images -> ``(B, H, W)`` aggregated probabilities."""
    return homography_adaptation(gen, images, adaptation_prob_fn(model, config),
                                 homo_config)


def prep_images(images: torch.Tensor, channels: int) -> torch.Tensor:
    """u8 -> float32 / 255, and gray -> ``channels`` repeated channels."""
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) * (1.0 / 255.0)
    else:
        images = images.to(torch.float32)
    if images.shape[-1] == 1 and channels != 1:
        images = images.expand(*images.shape[:-1], channels)
    return images


def load_state(weights_path: str) -> Tuple[int, Dict[str, torch.Tensor]]:
    """``(step, state_dict)`` on the CPU from a ``.npz`` snapshot (step 0)
    or from the newest ``ckpt_<step>.pt`` of a checkpoint directory (its
    ``"model"`` entry)."""
    if str(weights_path).endswith(".npz"):
        return 0, load_variables(weights_path, device="cpu")
    if not Path(weights_path).is_dir():
        raise FileNotFoundError(f"no .npz snapshot or checkpoint directory at "
                                f"{weights_path}")
    step, state = ckpt.restore_latest(ckpt.checkpoint_manager(weights_path))
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {weights_path}")
    return step, state["model"]


class SuperPointFrontend:
    """Holds the model on one device; ``device=None`` means ``cuda``."""

    def __init__(
        self,
        config: SuperPointConfig = SuperPointConfig(),
        weights_path: Optional[str] = None,
        seed: int = 0,
        device=None,
    ):
        """``weights_path``: a ``weights/*.npz`` snapshot or a checkpoint
        directory (`load_state`); without one the weights are random, drawn
        from ``seed``.  With ``config.fold_bn``
        the BatchNorms are folded into the convolutions here: snapshots
        always keep the live-BN layout (`wrapper.py:117-121`)."""
        self.config = config
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        # the fold reads float32 parameters, as the JAX fold does
        live = SuperPoint(config.replace(fold_bn=False, compute_dtype=(
            "float32" if config.fold_bn else config.compute_dtype)), generator=gen)
        if weights_path is not None:
            step, state = load_state(weights_path)
            live.load_state_dict(state)
            if not str(weights_path).endswith(".npz"):
                print(f"[frontend] loaded checkpoint step {step} from {weights_path}")
        model = live
        if config.fold_bn:
            model = SuperPoint(config, generator=torch.Generator())
            model.load_state_dict(fold_batchnorm(live.state_dict()))
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()

    def _images(self, images) -> torch.Tensor:
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.asarray(images))
        return images.to(self.device)

    @torch.inference_mode()
    def extract(self, images) -> Tuple[Keypoints, torch.Tensor]:
        """``(B, H, W, 3)`` float images in [0, 1] -> ``(Keypoints, desc
        (B, K, D))`` on the frontend's device."""
        images = self._images(images).to(torch.float32)
        return extract_fn(self.model, images, self.config)

    @torch.inference_mode()
    def extract_sharded(self, images, mesh) -> Tuple[Keypoints, torch.Tensor]:
        """`extract` of a ``(B, H, W, 3)`` batch split over ``mesh``: each
        rank runs the whole extract (the decode and NMS kernels included)
        on its ``B / d`` rows, and every rank gets the whole batch's
        keypoints and descriptors back through one exact sum of zero-filled
        buffers a field (`parallel/collectives.py::gather_rows`).  Every
        rank passes the same global batch, as in JAX."""
        from feature_point_cnn_tpu_torch.parallel.collectives import gather_rows
        from feature_point_cnn_tpu_torch.parallel.mesh import batch_sharding

        images = self._images(images).to(torch.float32)
        kp, desc = extract_fn(self.model, images[batch_sharding(mesh, images.shape[0])],
                              self.config)
        return (Keypoints(*(gather_rows(f, mesh.group) for f in kp)),
                gather_rows(desc, mesh.group))

    def run(self, img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One ``(H, W, 3)`` image -> ``(points (3, N) [x, y, conf], desc
        (D, N))``, the reference's layout."""
        kp, desc = self.extract(np.asarray(img, np.float32)[None])
        v = kp.valid[0].cpu().numpy()
        return keypoints_to_numpy(kp, 0), desc[0].cpu().numpy()[v].T

    @torch.inference_mode()
    def run_with_homography_adaptation(
        self, images, homo_config: HomographyConfig, gen: Generators
    ) -> List[np.ndarray]:
        """Self-labeling pass: ``(B, H, W, 3)`` images -> the aggregated
        map's keypoints, one ``(3, N)`` ``[x, y, conf]`` array an image.
        ``gen``: one generator shared by the batch, or one an image."""
        images = self._images(images).to(torch.float32)
        prob = adaptation_fn(self.model, images, gen, self.config, homo_config)
        kp = extract_keypoints(prob, self.config)
        return [keypoints_to_numpy(kp, i) for i in range(images.shape[0])]

    @torch.inference_mode()
    def frame(self, images, key_desc, key_num, top_n: int = 256):
        """The packed serving frame: detect + describe + match every frame
        of the batch against one keyframe.

        ``images``: ``(B, H, W, C)`` uint8 (scaled by 1/255 here) or float in
        [0, 1], with C = 3 or 1 (gray, repeated to 3 channels here).
        ``key_desc``: ``(N, D)`` float16 keyframe descriptors, ``key_num``
        its valid row count; N = ``min(top_n, max_keypoints)``.

        Returns ``(num_valid (B,) int32, kp_packed (B, N, 3) float32 [y, x,
        score], match_index (B, N) int32 (-1 = no match), desc16 (B, N, D)
        float16)``.  Keypoints are score-sorted, so the first N rows are the
        top N.  Frame ``b``'s ``(desc16[b], num_valid[b])`` is the next
        keyframe input.
        """
        cfg = self.config
        n = min(top_n, cfg.max_keypoints)
        images = prep_images(self._images(images), cfg.image_channels)
        kp, desc = extract_fn(self.model, images, cfg)
        y, x = kp.y[:, :n], kp.x[:, :n]
        score, valid = kp.score[:, :n], kp.valid[:, :n]
        desc_n = torch.where(valid[..., None], desc[:, :n], 0.0)
        key_desc = torch.as_tensor(key_desc, device=self.device).float()
        key_valid = torch.arange(key_desc.shape[0], device=self.device) < (
            torch.as_tensor(key_num, device=self.device)
        )
        m = mnn_match(desc_n, valid, key_desc, key_valid, max_l2_dist=cfg.nn_thresh)
        num_valid = valid.sum(-1, dtype=torch.int32)
        packed = torch.stack([y, x, score], dim=-1)
        match_index = torch.where(m.valid, m.index, -1).to(torch.int32)
        return num_valid, packed, match_index, desc_n.to(torch.float16)
