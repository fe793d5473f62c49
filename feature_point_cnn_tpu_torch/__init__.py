"""PyTorch/CUDA port of the SuperPoint serving, training, self-labeling and
two-view evaluation paths, for one NVIDIA H100.

The JAX package `feature_point_cnn_tpu` is the reference; this package
imports none of it (nor JAX) and keeps its own copies of what it needs.
Public functions keep the reference's layouts: images ``(B, H, W, 3)`` in
[0, 1], prob maps ``(B, H, W)``, descriptor maps ``(B, Hc, Wc, D)``, logits
``(B, Hc, Wc, 65)``, keypoints ``(B, K)``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device argument and no GPU they raise (`device.resolve_device`).
"""

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.device import resolve_device

__all__ = ["SuperPointConfig", "resolve_device"]
