"""PyTorch port parity: the SuperPoint forward against the JAX model on the
released weights, on the CPU.

Tolerances: float32 on both sides differs only by summation order inside
the convolutions, so logits, descriptor maps and prob maps agree to 1e-4.
The bf16 case rounds activations to 8 mantissa bits at every layer, in
different places in the two frameworks; it is held to the float32
reference at atol 0.1 + rtol 0.05 on logits (they reach ~30, where one
bf16 ulp is 0.125) and atol 0.05 on prob maps.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
from feature_point_cnn_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from feature_point_cnn_tpu.utils.weights import load_weights as jax_load_weights
from feature_point_cnn_tpu.utils.weights import released_path as jax_released_path

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
from feature_point_cnn_tpu_torch.utils.weights import (
    load_variables,
    released_path,
)

SIZES = [(64, 96), (72, 88)]  # 72x88: odd Hc/Wc (9x11), exercises the crop


@functools.lru_cache(maxsize=None)
def released_jax_variables():
    return jax_load_weights(jax_released_path())


def torch_model(compute_dtype="float32"):
    model = SuperPoint(SuperPointConfig(compute_dtype=compute_dtype))
    model.load_state_dict(load_variables(released_path(), device="cpu"))
    return model.eval()


def jax_forward(images, enable_descriptor=True):
    model = JaxSuperPoint(config=JaxConfig(compute_dtype="float32"))
    prob, desc, logits = model.apply(
        released_jax_variables(), jnp.asarray(images), train=False,
        enable_descriptor=enable_descriptor,
    )
    return np.asarray(prob), np.asarray(desc), np.asarray(logits)


def images_for(seed, b, h, w):
    return np.random.default_rng(seed).random((b, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_forward_matches_jax_float32(size):
    imgs = images_for(1, 2, *size)
    want = jax_forward(imgs)
    with torch.no_grad():
        got = torch_model()(torch.from_numpy(imgs))
    hc, wc = size[0] // 8, size[1] // 8
    assert got[0].shape == (2, *size)
    assert got[1].shape == (2, hc, wc, 128)
    assert got[2].shape == (2, hc, wc, 65)
    for g, w, name in zip(got, want, ("prob", "desc", "logits")):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, err_msg=name)


def test_forward_without_descriptor():
    imgs = images_for(2, 1, 64, 96)
    want = jax_forward(imgs, enable_descriptor=False)
    with torch.no_grad():
        prob, desc, logits = torch_model()(torch.from_numpy(imgs),
                                           enable_descriptor=False)
    assert desc.shape == (1, 8, 12, 128) and not desc.any()
    np.testing.assert_array_equal(want[1], 0.0)
    np.testing.assert_allclose(logits.numpy(), want[2], atol=1e-4)
    np.testing.assert_allclose(prob.numpy(), want[0], atol=1e-4)


def test_forward_bfloat16_close_to_float32_reference():
    imgs = images_for(3, 1, 64, 96)
    want = jax_forward(imgs)
    model = torch_model("bfloat16")
    assert model.encoder.conv1.weight.dtype == torch.bfloat16
    assert model.encoder.bn1.running_var.dtype == torch.float32
    with torch.no_grad():
        prob, desc, logits = model(torch.from_numpy(imgs))
    assert prob.dtype == desc.dtype == logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want[2], rtol=0.05, atol=0.1)
    np.testing.assert_allclose(prob.numpy(), want[0], atol=0.05)


def test_random_init_is_seeded():
    a = SuperPoint(generator=torch.Generator().manual_seed(5)).state_dict()
    b = SuperPoint(generator=torch.Generator().manual_seed(5)).state_dict()
    c = SuperPoint(generator=torch.Generator().manual_seed(6)).state_dict()
    key = "encoder.conv1.weight"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
