"""PyTorch port parity: the VGG SuperPoint family against the JAX package's
`VGGSuperPoint`, on the CPU.

JAX variables drawn by `init_vgg_superpoint` go across with
`utils/weights.vgg_state_dict_from_jax_variables`; the forward at 48x64,
float32, is held to ``VGGSuperPoint.apply`` within 1e-5 on the prob map
and 1e-4 on the descriptors and logits.  The weights go there and back
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
from feature_point_cnn_tpu.models.vgg_superpoint import (
    VGGSuperPoint as JaxVGG,
    init_vgg_superpoint as jax_init_vgg,
)

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.models.vgg_superpoint import (
    VGGSuperPoint,
    init_vgg_superpoint,
)
from feature_point_cnn_tpu_torch.utils.weights import (
    jax_variables_from_vgg_state_dict,
    vgg_state_dict_from_jax_variables,
)

JCFG = JaxConfig(image_channels=1, descriptor_dim=256, compute_dtype="float32")
CFG = SuperPointConfig(image_channels=1, descriptor_dim=256, compute_dtype="float32")


def _jax_variables(seed=0):
    _, variables = jax_init_vgg(jax.random.PRNGKey(seed), JCFG, (48, 64))
    return jax.tree_util.tree_map(np.asarray, variables)


def test_forward_matches_jax_on_carried_weights():
    variables = _jax_variables()
    model = VGGSuperPoint(CFG)
    model.load_state_dict(vgg_state_dict_from_jax_variables(variables))
    images = np.random.default_rng(0).random((2, 48, 64, 1)).astype(np.float32)
    with torch.no_grad():
        prob, desc, logits = model(torch.from_numpy(images))
    jprob, jdesc, jlogits = JaxVGG(config=JCFG).apply(variables, jnp.asarray(images))
    assert prob.shape == (2, 48, 64) and desc.shape == (2, 6, 8, 256)
    assert logits.shape == (2, 6, 8, 65) and prob.dtype == torch.float32
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(desc.numpy(), np.asarray(jdesc), atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(desc.numpy(), axis=-1), 1.0, atol=1e-5)


def test_bf16_forward_stays_near_float32():
    variables = _jax_variables(1)
    sd = vgg_state_dict_from_jax_variables(variables)
    images = torch.from_numpy(np.random.default_rng(1).random((1, 48, 64, 1)).astype(
        np.float32))
    out = {}
    for dtype in ("float32", "bfloat16"):
        model = VGGSuperPoint(CFG.replace(compute_dtype=dtype))
        model.load_state_dict(sd)
        with torch.no_grad():
            out[dtype] = model(images)
    assert all(t.dtype == torch.float32 for t in out["bfloat16"])
    np.testing.assert_allclose(out["bfloat16"][1].numpy(), out["float32"][1].numpy(),
                               atol=0.05)


def test_weights_round_trip_exactly():
    variables = _jax_variables(2)
    sd = vgg_state_dict_from_jax_variables(variables)
    back = jax_variables_from_vgg_state_dict(sd)
    assert back["batch_stats"] == {}
    assert jax.tree_util.tree_structure(back["params"]) == jax.tree_util.tree_structure(
        variables["params"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, back["params"],
                           variables["params"])
    model = init_vgg_superpoint(torch.Generator().manual_seed(3), CFG, device="cpu")
    again = vgg_state_dict_from_jax_variables(jax_variables_from_vgg_state_dict(
        model.state_dict()))
    assert again.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(again[k], v), k


def test_init_is_seeded_and_needs_a_device_without_a_card():
    a = init_vgg_superpoint(torch.Generator().manual_seed(5), CFG, device="cpu")
    b = init_vgg_superpoint(torch.Generator().manual_seed(5), CFG, device="cpu")
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            init_vgg_superpoint(config=CFG)
