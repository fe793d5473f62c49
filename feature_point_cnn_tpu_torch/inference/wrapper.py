"""Serving front end: image batch -> keypoints + descriptors (+ matches).

Port of `feature_point_cnn_tpu/inference/wrapper.py`: `extract_fn`
(`:33-66`), `SuperPointFrontend.extract`/`run` (`:134-184`), and the packed
frame program of ``export_pjrt`` (input prep `:298-307`, frame `:351-387`)
as `SuperPointFrontend.frame`.  PyTorch runs eagerly, so there is nothing
to export: the frame program is a method.  StableHLO/PJRT export, sharded
extraction and homography adaptation are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.device import resolve_device
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


def prep_images(images: torch.Tensor, channels: int) -> torch.Tensor:
    """u8 -> float32 / 255, and gray -> ``channels`` repeated channels."""
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) * (1.0 / 255.0)
    else:
        images = images.to(torch.float32)
    if images.shape[-1] == 1 and channels != 1:
        images = images.expand(*images.shape[:-1], channels)
    return images


class SuperPointFrontend:
    """Holds the model on one device; ``device=None`` means ``cuda``."""

    def __init__(
        self,
        config: SuperPointConfig = SuperPointConfig(),
        weights_path: Optional[str] = None,
        seed: int = 0,
        device=None,
    ):
        """``weights_path``: a ``weights/*.npz`` snapshot; without one the
        weights are random, drawn from ``seed``."""
        self.config = config
        self.device = resolve_device(device)
        model = SuperPoint(config, generator=torch.Generator().manual_seed(seed))
        if weights_path is not None:
            model.load_state_dict(load_variables(weights_path, device="cpu"))
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

    def run(self, img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One ``(H, W, 3)`` image -> ``(points (3, N) [x, y, conf], desc
        (D, N))``, the reference's layout."""
        kp, desc = self.extract(np.asarray(img, np.float32)[None])
        v = kp.valid[0].cpu().numpy()
        return keypoints_to_numpy(kp, 0), desc[0].cpu().numpy()[v].T

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
