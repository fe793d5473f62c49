"""PyTorch port: the plain versions of the decode and NMS kernels against
the JAX package's Pallas kernels (interpret mode) and XLA paths, on the CPU.

Tolerances: decode agrees to atol 1e-6 + rtol 2e-6 (float32 softmax; XLA's
and PyTorch's CPU ``exp`` and sums differ by a few ulps), and its kept mask
may differ only where the probability lies within 1e-6 of the threshold;
NMS and the priority key are exact (float compare/max and integer bit
packing have no rounding).  The CUDA kernels themselves run only on the
card: `tests/test_torch_cuda_kernels.py` compares them with these plain
versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.ops import detection as JD
from feature_point_cnn_tpu.ops.pallas.decode import decode_threshold_pallas
from feature_point_cnn_tpu.ops.pallas.nms import grid_nms_pallas
from tests.test_detection import (
    _assert_spacing,
    _plateau_maps,
    _random_scores,
)

from feature_point_cnn_tpu_torch.ops.kernels import use_kernel
from feature_point_cnn_tpu_torch.ops.kernels.decode import (
    decode_threshold_cuda,
    decode_threshold_plain,
)
from feature_point_cnn_tpu_torch.ops.kernels.nms import (
    grid_nms_cuda,
    grid_nms_plain,
    nms_priority_key,
)


def assert_decode_close(got, want, threshold):
    """Values within atol 1e-6 + rtol 2e-6 where both kept; a mask flip only
    for a probability within 1e-6 of the threshold."""
    flip = (got > 0) != (want > 0)
    edge = np.maximum(got, want)[flip]
    assert np.all(np.abs(edge - threshold) <= 1e-6), edge
    both = ~flip
    np.testing.assert_allclose(got[both], want[both], atol=1e-6, rtol=2e-6)


@pytest.mark.parametrize("shape", [(1, 6, 8), (3, 30, 40), (2, 15, 20)])
def test_decode_plain_matches_pallas(rng, shape):
    logits = (rng.standard_normal((*shape, 65)) * 4).astype(np.float32)
    want = np.asarray(decode_threshold_pallas(jnp.asarray(logits), 8, 0.015,
                                              interpret=True))
    got = decode_threshold_plain(torch.from_numpy(logits), 8, 0.015).numpy()
    assert_decode_close(got, want, 0.015)


def test_decode_plain_extreme_logits():
    logits = np.full((1, 2, 2, 65), 300.0, np.float32)
    logits[0, 0, 0, 3] = 400.0
    want = np.asarray(decode_threshold_pallas(jnp.asarray(logits), 8, 0.015,
                                              interpret=True))
    got = decode_threshold_plain(torch.from_numpy(logits), 8, 0.015).numpy()
    assert np.isfinite(got).all() and got[0, 0, 3] > 0.99
    assert_decode_close(got, want, 0.015)


def _nms_maps(rng):
    maps = [_random_scores(rng, density=0.03 + 0.05 * t) for t in range(4)]
    ramp = np.zeros((48, 64), np.float32)
    ramp[24, :] = np.linspace(0.1, 0.9, 64)  # deep suppression chain
    full_ramp = (np.arange(48 * 64, dtype=np.float32).reshape(48, 64)
                 / (48 * 64) * 0.9 + 0.05)
    return maps + [ramp, full_ramp] + _plateau_maps()


def test_nms_plain_matches_pallas_and_xla_exactly(rng):
    for scores in _nms_maps(rng):
        got = grid_nms_plain(torch.from_numpy(scores[None]), 4).numpy()[0]
        pallas = np.asarray(grid_nms_pallas(jnp.asarray(scores[None]), 4,
                                             interpret=True))[0]
        xla = np.asarray(JD.grid_nms(jnp.asarray(scores[None]), 4))[0]
        np.testing.assert_array_equal(got, pallas)
        np.testing.assert_array_equal(got, xla)
        _assert_spacing(got, 4)


def test_nms_plain_batched(rng):
    scores = np.stack([_random_scores(rng, 0.05) for _ in range(3)])
    got = grid_nms_plain(torch.from_numpy(scores), 4).numpy()
    want = np.asarray(JD.grid_nms(jnp.asarray(scores), 4))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dist", [1, 2, 4, 7])
def test_priority_key_bitwise(rng, dist):
    scores = _random_scores(rng, 0.3)
    scores[0, :5] = [1e-30, 0.015, 0.25, 1.0, -0.5]  # tiny, exact, negative
    scores = np.concatenate([scores[None], np.stack(_plateau_maps())])
    want = np.asarray(JD.nms_priority_key(jnp.asarray(scores), dist))
    got = nms_priority_key(torch.from_numpy(scores), dist).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_priority_key_rejects_wide_window():
    with pytest.raises(ValueError):
        nms_priority_key(torch.zeros(1, 4, 4), 8)


def test_wrappers_take_plain_version_for_cpu_tensors(rng):
    """On a CPU tensor the wrappers run the plain version and count no
    launch; the gates switch on CUDA tensors only under "auto"."""
    d0, n0 = decode_threshold_cuda.launches, grid_nms_cuda.launches
    logits = torch.from_numpy((rng.standard_normal((2, 6, 8, 65)) * 4)
                              .astype(np.float32))
    assert torch.equal(decode_threshold_cuda(logits, 8, 0.015),
                       decode_threshold_plain(logits, 8, 0.015))
    scores = torch.from_numpy(_random_scores(rng, 0.1)[None])
    assert torch.equal(grid_nms_cuda(scores, 4), grid_nms_plain(scores, 4))
    assert (decode_threshold_cuda.launches, grid_nms_cuda.launches) == (d0, n0)
    assert not use_kernel("auto", scores)
    assert use_kernel("on", scores) and not use_kernel("off", scores)
    with pytest.raises(ValueError):
        use_kernel("yes", scores)
