"""PyTorch port: the CUDA kernels against their plain versions, on the card.

This file imports neither JAX nor the JAX package and defines its own
fixtures, so it runs on a CUDA machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

Without a card every test skips.  Tolerances: decode within 1e-6 of its
plain version (``expf`` against PyTorch's ``exp``, same float32 order of
the 65-way sum up to a few ulps), NMS exactly (float compare and max only).
"""

import numpy as np
import pytest
import torch

from feature_point_cnn_tpu_torch.ops.kernels.decode import (
    decode_threshold_cuda,
    decode_threshold_plain,
)
from feature_point_cnn_tpu_torch.ops.kernels.nms import (
    grid_nms_cuda,
    grid_nms_plain,
)


@pytest.fixture
def rng():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return np.random.default_rng(0)


def _cuda(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 60, 80), (1, 9, 11)])
def test_decode_kernel_matches_plain(rng, shape):
    logits = _cuda(rng.standard_normal((*shape, 65)) * 4)
    logits[0, 0, 0] = 300.0          # extreme but finite logits
    logits[0, 0, 0, 3] = 400.0
    n0 = decode_threshold_cuda.launches
    got = decode_threshold_cuda(logits, 8, 0.015)
    assert decode_threshold_cuda.launches == n0 + 1
    want = decode_threshold_plain(logits, 8, 0.015)
    prob = decode_threshold_plain(logits, 8, 0.0)
    flip = (got > 0) != (want > 0)
    assert bool(((prob[flip] - 0.015).abs() <= 1e-6).all())
    assert (got - want).abs()[~flip].max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.01, 0.3, 1.0])
def test_nms_kernel_matches_plain_exactly(rng, density):
    vals = rng.random((3, 120, 168)).astype(np.float32) * 0.9 + 0.05
    vals[rng.random(vals.shape) >= density] = 0.0
    scores = _cuda(vals)
    n0 = grid_nms_cuda.launches
    got = grid_nms_cuda(scores, 4)
    assert grid_nms_cuda.launches == n0 + 1
    assert torch.equal(got, grid_nms_plain(scores, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("dist", [0, 1, 7])
def test_nms_kernel_ramp_and_plateaus(rng, dist):
    h, w = 64, 96
    ramp = np.arange(h * w, dtype=np.float32).reshape(h, w) / (h * w) * 0.9 + 0.05
    plate = np.zeros((h, w), np.float32)
    plate[8:40, 8:40] = 0.25
    plate[::2, 50::2] = 0.9
    scores = _cuda(np.stack([ramp, plate, np.full((h, w), 0.015, np.float32)]))
    got = grid_nms_cuda(scores, dist)
    assert torch.equal(got, grid_nms_plain(scores, dist))
    assert grid_nms_cuda.last_rounds >= 1


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(rng):
    """On a CUDA tensor a wrapper launches its kernel or raises; it never
    hands the tensor to its plain version."""
    with pytest.raises(ValueError):
        decode_threshold_cuda(_cuda(np.zeros((1, 2, 2, 65))).half(), 8, 0.015)
    with pytest.raises(ValueError):
        decode_threshold_cuda(_cuda(np.zeros((1, 2, 2, 65))), 4, 0.015)
    with pytest.raises(ValueError):
        grid_nms_cuda(_cuda(np.zeros((1, 8, 8))), 8)
    with pytest.raises(ValueError):
        grid_nms_cuda(_cuda(np.zeros((8, 8))), 4)
