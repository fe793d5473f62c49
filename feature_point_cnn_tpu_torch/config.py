"""Serving configuration of the port.

A copy of the decode, model and numerics fields of the JAX package's
``SuperPointConfig`` (`feature_point_cnn_tpu/config.py:27-89,171`), with the
same defaults, so one operating point means the same thing on both sides.
The training fields belong to a later slice.  Left out on purpose:
``stem_s2d`` (a TPU-only reparametrisation of the stem conv), ``fold_bn``
(its folding module is not ported yet) and ``grid_channels`` (always 65:
the 64 cell positions and the dustbin).

The kernel gates take ``"auto"`` (the CUDA kernel for CUDA tensors, the
plain PyTorch version otherwise), ``"on"`` or ``"off"``.  Unlike the JAX
default, the fused decode kernel is on: its TPU measurement does not carry
over to the H100.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


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

    # --- model topology ---
    image_channels: int = 3
    descriptor_dim: int = 128

    # --- numerics: "bfloat16" runs the convolutions in bf16 with float32
    # parameters and BatchNorm statistics; "float32" is the parity path ---
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        for gate in ("use_cuda_decode", "use_cuda_nms"):
            if getattr(self, gate) not in ("auto", "on", "off"):
                raise ValueError(f"{gate} must be 'auto', 'on' or 'off'")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")

    def grid_size(self, img_h: int, img_w: int) -> Tuple[int, int]:
        if img_h % self.cell or img_w % self.cell:
            raise ValueError(
                f"image size ({img_h},{img_w}) must be divisible by "
                f"cell={self.cell}"
            )
        return img_h // self.cell, img_w // self.cell

    def replace(self, **kw) -> "SuperPointConfig":
        return dataclasses.replace(self, **kw)
