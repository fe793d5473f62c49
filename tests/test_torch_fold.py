"""PyTorch port: BatchNorm folding for serving against live BatchNorm and
against the JAX package's fold, on the CPU.

Tolerances: the folded port model against the live-BN port model at
float32, atol 1e-5 + rtol 1e-4 (the fold moves rounding, and oneDNN sums in
a varying order); the folded model in bf16 against JAX's float32 forward at
the bf16 tolerance of `tests/test_torch_model.py` (logits atol 0.1 + rtol
0.05, prob maps atol 0.05); the port's fold of the JAX-carried released weights
against JAX's ``fold_batchnorm`` carried across, leaf by leaf, 1e-6; the
folded frontends of both packages, end to end, as the unfolded ones are
held in `tests/test_torch_frontend.py`: keypoint sets overlap >= 99% and
prob maps within atol 1e-5 + rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
from feature_point_cnn_tpu.inference.wrapper import SuperPointFrontend as JaxFrontend
from feature_point_cnn_tpu.models.fold import fold_batchnorm as jax_fold_batchnorm
from tests.test_torch_frontend import _kp_set, _scenes
from tests.test_torch_model import images_for, jax_forward, released_jax_variables

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
from feature_point_cnn_tpu_torch.models.fold import fold_batchnorm
from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
from feature_point_cnn_tpu_torch.utils.weights import (
    load_variables,
    released_path,
    state_dict_from_jax_variables,
)


def _live_model_with_random_bn(seed: int = 5) -> SuperPoint:
    """A float32 live-BN model whose BatchNorms are far from the identity:
    seeded conv weights, numpy-drawn scales, shifts and running statistics."""
    model = SuperPoint(SuperPointConfig(compute_dtype="float32"),
                       generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(0.5 + rng.random(c, np.float32)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(0.2 * rng.standard_normal(c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(0.5 + rng.random(c, np.float32)))
    return model.eval()


def _folded(live: SuperPoint, compute_dtype: str) -> SuperPoint:
    model = SuperPoint(SuperPointConfig(compute_dtype=compute_dtype, fold_bn=True),
                       generator=torch.Generator())
    sd = {k: v.float() for k, v in live.state_dict().items()}
    model.load_state_dict(fold_batchnorm(sd))
    return model.eval()


def test_folded_model_equals_live_bn_at_float32():
    live = _live_model_with_random_bn()
    folded = _folded(live, "float32")
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.modules())
    assert set(folded.state_dict()) == set(fold_batchnorm(live.state_dict()))
    x = torch.from_numpy(np.random.default_rng(6).random((2, 48, 64, 3), np.float32))
    with torch.no_grad():
        want, got = live(x), folded(x)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


def test_folded_bf16_model_within_the_bf16_tolerance_of_the_float32_reference():
    """The released weights folded, computed in bf16 (bias cast to bf16 as
    JAX does), against JAX's float32 forward: the bf16 tolerance of
    `tests/test_torch_model.py`."""
    live = SuperPoint(SuperPointConfig(compute_dtype="float32"))
    live.load_state_dict(load_variables(released_path(), device="cpu"))
    folded = _folded(live, "bfloat16")
    assert folded.encoder.conv1.bias.dtype == torch.bfloat16
    imgs = images_for(3, 1, 64, 96)
    want = jax_forward(imgs)
    with torch.no_grad():
        prob, _, logits = folded(torch.from_numpy(imgs))
    np.testing.assert_allclose(logits.numpy(), want[2], rtol=0.05, atol=0.1)
    np.testing.assert_allclose(prob.numpy(), want[0], atol=0.05)


def test_fold_of_jax_variables_equals_jax_fold_leaf_by_leaf():
    variables = released_jax_variables()
    want = state_dict_from_jax_variables(jax_fold_batchnorm(variables))
    got = fold_batchnorm(state_dict_from_jax_variables(variables))
    assert set(got) == set(want)
    assert not any("running" in k or ".bn" in k for k in got)
    assert got["descriptor.up_sample.weight"].shape == (256, 128, 3, 3)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=1e-6, msg=k)
    # the folded tree loads into the fold_bn model under the same names
    SuperPoint(SuperPointConfig(fold_bn=True)).load_state_dict(got)


def test_fold_rejects_an_unpaired_batchnorm_and_train_mode():
    sd = load_variables(released_path(), device="cpu")
    sd["encoder.bn9.running_mean"] = sd["encoder.bn1.running_mean"]
    with pytest.raises(ValueError, match="bn9"):
        fold_batchnorm(sd)
    with pytest.raises(ValueError, match="fold_bn"):
        SuperPoint(SuperPointConfig(fold_bn=True)).train()


def test_folded_frontend_matches_jax_folded_frontend():
    jfe = JaxFrontend(JaxConfig(compute_dtype="float32", max_keypoints=128, fold_bn=True),
                      variables=released_jax_variables())
    assert "batch_stats" not in jfe.variables
    tfe = SuperPointFrontend(SuperPointConfig(compute_dtype="float32", max_keypoints=128,
                                              fold_bn=True),
                             weights_path=released_path(), device="cpu")
    images = _scenes(2, seed=3)
    jkp, _ = jfe.extract(images)
    tkp, _ = tfe.extract(images)
    both = total = 0
    for b in range(2):
        js, ts = _kp_set(jkp, b), _kp_set(tkp, b)
        both, total = both + len(js & ts), total + len(js | ts)
    assert total >= 10 and both / total >= 0.99
    jprob = np.asarray(jfe.model.apply(jfe.variables, images, train=False)[0])
    with torch.no_grad():
        tprob = tfe.model(torch.from_numpy(images))[0].numpy()
    np.testing.assert_allclose(tprob, jprob, atol=1e-5, rtol=1e-4)
