"""Configuration of the port, shared by serving and training.

A copy of the JAX package's ``SuperPointConfig`` and ``HomographyConfig``
(`feature_point_cnn_tpu/config.py:27-180,202-239`) with the same defaults,
so one operating point means the same thing on both sides.  Left out on
purpose: ``stem_s2d`` (a TPU-only reparametrisation of the stem conv) and
``grid_channels`` (always 65: the 64 cell positions and the dustbin).
``data_axis`` names the axis of the data mesh (`parallel/mesh.py`).
``fold_bn`` folds BatchNorm into the convolutions for serving
(`models/fold.py`); ``train_steps_per_call`` runs k optimizer steps a host
call, on the card as k replays of a CUDA graph of the step
(`train/trainer.py`).

``backbone`` picks the detector family the serving frontend builds (the
ResNet SuperPoint or magicleap's VGG one, `models/vgg_superpoint.py`), and
``matcher`` its keyframe match: mutual nearest neighbours
(`ops/matching.py`) or SuperGlue (`models/superglue.py`), whose widths and
operating point are the ``superglue`` section, `SuperGlueConfig`.

The kernel gates take ``"auto"`` (the CUDA kernel for CUDA tensors, the
plain PyTorch version otherwise), ``"on"`` or ``"off"``.  Unlike the JAX
default, the fused decode kernel is on: its TPU measurement does not carry
over to the H100.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SuperGlueConfig:
    """SuperGlue's ``default_config`` (magicleap/SuperGluePretrainedNetwork,
    ``models/superglue.py``; Sarlin et al., CVPR 2020) and the port's
    precision split: the 1x1 convolutions, the attention and the MLPs run
    in ``compute_dtype`` (accumulating in float32); the residual stream,
    BatchNorm (eval, running statistics), the score matrix and the whole
    Sinkhorn in float32."""

    descriptor_dim: int = 256
    keypoint_encoder: Tuple[int, ...] = (32, 64, 128, 256)
    gnn_layers: Tuple[str, ...] = ("self", "cross") * 9
    num_heads: int = 4
    sinkhorn_iterations: int = 100
    match_threshold: float = 0.2
    bn_eps: float = 1e-5
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if set(self.gnn_layers) - {"self", "cross"}:
            raise ValueError(f"GNN layers are 'self' or 'cross': {self.gnn_layers}")
        if self.descriptor_dim % self.num_heads:
            raise ValueError("descriptor_dim must be a multiple of num_heads")

    def replace(self, **kw) -> "SuperGlueConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SuperPointConfig:
    # --- keypoint decode operating point ---
    cell: int = 8                     # output cell size; total encoder stride
    nms_dist: int = 4                 # NMS suppression radius (inf-norm)
    confidence_thresh: float = 0.015  # detector confidence threshold
    nn_thresh: float = 0.7            # descriptor L2 distance for a match
    border_remove: int = 4            # strip detections this close to border
    max_keypoints: int = 1024         # K: keypoints padded/truncated to this
    subpixel_refine: bool = False     # log-parabola refinement on the raw
                                      # prob map (ops/detection.py)
    nms_iters: int = 0                # 0 = suppression rounds to convergence
                                      # (exact greedy); >0 = that many rounds
    use_cuda_decode: str = "auto"     # fused decode+threshold kernel
                                      # (ops/kernels/decode.py)
    use_cuda_nms: str = "auto"        # exact-greedy NMS kernel
                                      # (ops/kernels/nms.py)
    use_cuda_desc_loss: str = "auto"  # hinge descriptor loss kernels, forward
                                      # and backward, no (B, N, N) in device
                                      # memory (ops/kernels/descriptor_loss.py)
    fold_bn: bool = False             # serving topology: BatchNorms folded
                                      # into conv weight + bias at load
                                      # (models/fold.py); training always
                                      # keeps live BatchNorm

    # --- model topology ---
    image_channels: int = 3
    descriptor_dim: int = 128
    backbone: str = "resnet"          # "resnet" (models/superpoint.py) |
                                      # "vgg" (models/vgg_superpoint.py)

    # --- the serving frame's keyframe match ---
    matcher: str = "mnn"              # "mnn" (ops/matching.py) | "superglue"
                                      # (models/superglue.py)
    superglue: SuperGlueConfig = SuperGlueConfig()

    # --- numerics: "bfloat16" runs the convolutions in bf16 with float32
    # parameters and BatchNorm statistics; "float32" is the parity path ---
    compute_dtype: str = "bfloat16"

    # --- loss ---
    lambda_d: float = 250.0
    positive_margin: float = 1.0
    negative_margin: float = 0.2
    detector_loss: str = "ce"         # "ce" | "distance" (soft-argmax position;
                                      # cell confidences collapse below the
                                      # operating threshold: prefer "ce")
    descriptor_loss: str = "hinge"    # "hinge" | "mse" | "hinge_hn" (hard-
                                      # negative-mined hinge on plain cosine
                                      # similarity)
    desc_hn_topk: int = 8             # hinge_hn: hardest negatives mined per
                                      # cell (each direction)
    lambda_hn: float = 1.0            # hinge_hn: descriptor-vs-detector weight

    # --- training ---
    train_image_size: Tuple[int, int] = (240, 320)
    batch_size: int = 32
    grad_accum_steps: int = 1         # accumulate k FULL-size batches into one
                                      # update (k x effective batch)
    train_steps_per_call: int = 1     # device-resident data only: k optimizer
                                      # steps a host call (on the card, k
                                      # replays of a CUDA graph of the step);
                                      # 1 = one eager step a call
    learning_rate: float = 1.0e-3
    lr_schedule: str = "warmup_cosine"  # "constant" | "warmup_cosine"
    warmup_steps: int = 200           # linear warmup from 0
    lr_final_ratio: float = 0.05      # cosine floor as a fraction of peak
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1.0e-8
    weight_decay: float = 0.01
    grad_clip_norm: float = 5.0       # global-norm clip; 0 disables
    epochs: int = 100
    microbatch_steps: int = 1         # split each batch into k sequential
                                      # microbatches inside the step (gradients
                                      # averaged, BatchNorm statistics threaded):
                                      # same effective batch, ~k-fold less
                                      # activation memory
    eval_max_items: int = 1000        # cap on per-epoch eval items of the
                                      # SuperPoint phase; 0 = the full split

    # --- data pipeline ---
    max_points: int = 512             # fixed-size padded ground-truth point sets
    shuffle_seed: int = 0
    prefetch_batches: int = 2
    photometric_augment: bool = False # on-device photometric augmentation

    # --- parallelism ---
    data_axis: str = "data"           # the data mesh's axis (parallel/mesh.py)

    def __post_init__(self):
        for gate in ("use_cuda_decode", "use_cuda_nms", "use_cuda_desc_loss"):
            if getattr(self, gate) not in ("auto", "on", "off"):
                raise ValueError(f"{gate} must be 'auto', 'on' or 'off'")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.backbone not in ("resnet", "vgg"):
            raise ValueError(f"unknown backbone {self.backbone!r}")
        if self.matcher not in ("mnn", "superglue"):
            raise ValueError(f"unknown matcher {self.matcher!r}")
        if self.matcher == "superglue" and self.superglue.descriptor_dim != self.descriptor_dim:
            raise ValueError("SuperGlue's descriptor_dim must be the detector's")
        if self.train_steps_per_call < 1:
            raise ValueError("train_steps_per_call must be >= 1")

    def grid_size(self, img_h: int, img_w: int) -> Tuple[int, int]:
        if img_h % self.cell or img_w % self.cell:
            raise ValueError(
                f"image size ({img_h},{img_w}) must be divisible by "
                f"cell={self.cell}"
            )
        return img_h // self.cell, img_w // self.cell

    def replace(self, **kw) -> "SuperPointConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class HomographyConfig:
    """Random homography family for augmentation / adaptation
    (`feature_point_cnn_tpu/config.py:202-239`); ``for_preprocess()`` is the
    looser self-labeling variant."""

    num: int = 15                     # warps per image in adaptation
    perspective: bool = True
    scaling: bool = True
    rotation: bool = True
    translation: bool = True
    n_scales: int = 5
    n_angles: int = 25
    scaling_amplitude: float = 0.1
    perspective_amplitude_x: float = 0.1
    perspective_amplitude_y: float = 0.1
    patch_ratio: float = 0.5
    max_angle: float = math.pi / 2
    allow_artifacts: bool = False
    translation_overflow: float = 0.0
    valid_border_margin: int = 8
    aggregation: str = "sum"          # "sum" (mean) | "max"

    @classmethod
    def for_preprocess(cls) -> "HomographyConfig":
        return cls(
            scaling_amplitude=0.2,
            perspective_amplitude_x=0.2,
            perspective_amplitude_y=0.2,
            allow_artifacts=True,
            patch_ratio=0.85,
        )

    def replace(self, **kw) -> "HomographyConfig":
        return dataclasses.replace(self, **kw)
