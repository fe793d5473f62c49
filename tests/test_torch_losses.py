"""PyTorch port parity: every training loss, in value and in gradient,
against the JAX package (`jax.grad`), on the CPU in float32.

Tolerances: values rtol 1e-5; gradients rtol 1e-4 + atol 1e-6 (the same
float32 formulas; sums over N and D run in another order, and the
descriptor losses divide N^2-term sums by large counts).  The descriptor
hinge is also held to the JAX Pallas kernel in interpret mode at the
shapes and tolerances of `tests/test_pallas.py:49-62` (value rtol 2e-5,
gradients atol 2e-6 + rtol 2e-4).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
from feature_point_cnn_tpu.train import loss as jloss

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.ops.kernels.descriptor_loss import (
    hinge_descriptor_loss_cuda,
    hinge_descriptor_loss_plain,
)
from feature_point_cnn_tpu_torch.train import loss as tloss
from feature_point_cnn_tpu_torch.utils import profiling

HOMOG = np.array([1.02, 0.01, 3.0, -0.02, 0.98, -2.0, 1e-4, -1e-4], np.float32)
PALLAS_SHAPES = [(2, 6, 8, 32), (1, 8, 16, 16), (2, 10, 14, 8)]


def _torch_value_and_grad(fn, *xs):
    ts = [torch.from_numpy(np.array(x)).requires_grad_(True) for x in xs]
    v = fn(*ts)
    v.backward()
    return float(v), [t.grad.numpy() for t in ts]


def _jax_value_and_grad(fn, *xs):
    v, g = jax.value_and_grad(fn, argnums=tuple(range(len(xs))))(
        *[jnp.asarray(x) for x in xs])
    return float(v), [np.asarray(a) for a in g]


def _assert_close(got, want, rtol=1e-5, grtol=1e-4, gatol=1e-6):
    np.testing.assert_allclose(got[0], want[0], rtol=rtol)
    for g, w in zip(got[1], want[1]):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=grtol, atol=gatol)


def _detector_case(seed=0, b=2, hc=6, wc=8):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, hc, wc, 65)) * 3).astype(np.float32)
    targets = rng.integers(0, 65, (b, hc, wc))
    targets[0, :2] = 64
    mask = (rng.random((b, hc, wc)) > 0.3).astype(np.float32)
    return logits, targets, mask


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("kind,hard", [("ce", False), ("distance", False),
                                       ("distance", True)],
                         ids=["ce", "distance", "distance_hard"])
def test_detector_loss_matches_jax(kind, hard, masked):
    logits, targets, mask = _detector_case()
    m = mask if masked else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _jax_value_and_grad(
            lambda l: jloss.detector_loss(l, jnp.asarray(targets),
                                          None if m is None else jnp.asarray(m),
                                          8, kind, hard), logits)
        got = _torch_value_and_grad(
            lambda l: tloss.detector_loss(l, torch.from_numpy(targets),
                                          None if m is None else torch.from_numpy(m),
                                          8, kind, hard), logits)
    _assert_close(got, want)


def test_detector_loss_distance_warns_and_all_masked_is_zero():
    logits, targets, mask = _detector_case()
    with pytest.warns(UserWarning, match="distance"):
        tloss.detector_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                            None, 8, "distance")
    zero = tloss.detector_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                               torch.zeros(mask.shape), 8)
    assert float(zero) == 0.0


def test_l2_normalize_matches_jax_and_is_finite_at_zero_rows():
    x = np.random.default_rng(1).standard_normal((3, 5, 8)).astype(np.float32)
    x[1, 2] = 0.0
    want = _jax_value_and_grad(
        lambda a: jnp.sum(jloss._l2_normalize(a, -1) * jnp.arange(8.0)), x)
    got = _torch_value_and_grad(
        lambda a: (tloss._l2_normalize(a, -1) * torch.arange(8.0)).sum(), x)
    _assert_close(got, want)
    assert np.abs(got[1][0][1, 2]).max() > 1e3      # finite, though huge


def _descriptor_case(seed, b, hc, wc, dd, masked=True):
    rng = np.random.default_rng(seed)
    desc = rng.standard_normal((b, hc, wc, dd)).astype(np.float32)
    wdesc = rng.standard_normal((b, hc, wc, dd)).astype(np.float32)
    homog = np.tile(HOMOG, (b, 1))
    homog[-1, 2] += 8.0
    mask = (rng.random((b, hc, wc)) > 0.15).astype(np.float32) if masked else None
    return desc, wdesc, homog, mask


def _desc_fns(jfn, tfn, homog, mask, jcfg, tcfg, with_mask=True):
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    if with_mask:
        return (lambda d, w: jfn(d, w, jnp.asarray(homog), jm, jcfg),
                lambda d, w: tfn(d, w, torch.from_numpy(homog), tm, tcfg))
    return (lambda d, w: jfn(d, w, jnp.asarray(homog), jcfg),
            lambda d, w: tfn(d, w, torch.from_numpy(homog), tcfg))


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("shape", [(2, 6, 8, 32), (2, 5, 7, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_descriptor_hinge_loss_matches_jax_xla_path(shape, masked):
    desc, wdesc, homog, mask = _descriptor_case(2, *shape, masked=masked)
    jf, tf = _desc_fns(jloss.descriptor_loss, tloss.descriptor_loss, homog, mask,
                       JaxConfig(use_pallas_desc_loss="off"), SuperPointConfig())
    _assert_close(_torch_value_and_grad(tf, desc, wdesc),
                  _jax_value_and_grad(jf, desc, wdesc))


@pytest.mark.parametrize("shape", PALLAS_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_descriptor_hinge_loss_matches_jax_pallas_interpret(shape):
    """The port's loss (on the CPU the kernels' plain version) against the
    JAX loss through its Pallas kernel in interpret mode."""
    desc, wdesc, homog, mask = _descriptor_case(3, *shape)
    jf, tf = _desc_fns(jloss.descriptor_loss, tloss.descriptor_loss, homog, mask,
                       JaxConfig(use_pallas_desc_loss="on"), SuperPointConfig())
    _assert_close(_torch_value_and_grad(tf, desc, wdesc),
                  _jax_value_and_grad(jf, desc, wdesc),
                  rtol=2e-5, grtol=2e-4, gatol=2e-6)


def test_descriptor_hinge_loss_zero_descriptors_finite():
    cfg = SuperPointConfig()
    homog = np.array([[1.0, 0, 0, 0, 1, 0, 0, 0]], np.float32)
    zero = np.zeros((1, 4, 4, 8), np.float32)
    got = _torch_value_and_grad(
        lambda d: tloss.descriptor_loss(d, d, torch.from_numpy(homog), None, cfg), zero)
    want = _jax_value_and_grad(
        lambda d: jloss.descriptor_loss(d, d, jnp.asarray(homog), None,
                                        JaxConfig(use_pallas_desc_loss="off")), zero)
    assert np.isfinite(got[0]) and np.isfinite(got[1][0]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)


def test_kernel_wrapper_on_cpu_is_the_plain_version():
    """A CPU tensor goes to the plain version (and counts no launch); the
    raw sum divided by the normalisation is `descriptor_loss`."""
    desc, wdesc, homog, mask = _descriptor_case(4, 2, 6, 8, 16)
    b, n = 2, 48
    d = tloss._l2_normalize(torch.from_numpy(desc).reshape(b, n, 16), -1)
    wd = tloss._l2_normalize(torch.from_numpy(wdesc).reshape(b, n, 16), -1)
    centers = tloss._cell_centers(6, 8, 8, "cpu")
    from feature_point_cnn_tpu_torch.geometry.homography import warp_points

    wc = warp_points(centers, torch.from_numpy(homog))
    m = torch.from_numpy(mask).reshape(b, n)
    args = (d, wd, wc, centers, m, 250.0, 1.0, 0.2, 8)
    before = profiling.counters()
    raw = hinge_descriptor_loss_cuda(*args)
    assert profiling.counted_since(before) == {}
    assert torch.equal(raw, hinge_descriptor_loss_plain(*args))
    full = tloss.descriptor_loss(torch.from_numpy(desc), torch.from_numpy(wdesc),
                                 torch.from_numpy(homog), torch.from_numpy(mask),
                                 SuperPointConfig())
    np.testing.assert_allclose(float(raw / (m.sum() * n)), float(full), rtol=1e-6)


@pytest.mark.parametrize("topk", [8, 100])
def test_descriptor_hinge_hn_loss_matches_jax(topk):
    desc, wdesc, homog, mask = _descriptor_case(5, 2, 6, 8, 32)
    jf, tf = _desc_fns(jloss.descriptor_hinge_hn_loss, tloss.descriptor_hinge_hn_loss,
                       homog, mask, JaxConfig(desc_hn_topk=topk, lambda_hn=1.5),
                       SuperPointConfig(desc_hn_topk=topk, lambda_hn=1.5))
    _assert_close(_torch_value_and_grad(tf, desc, wdesc),
                  _jax_value_and_grad(jf, desc, wdesc))


def test_descriptor_mse_loss_matches_jax():
    desc, wdesc, homog, _ = _descriptor_case(6, 2, 6, 8, 32)
    jf, tf = _desc_fns(jloss.descriptor_mse_loss, tloss.descriptor_mse_loss,
                       homog, None, JaxConfig(), SuperPointConfig(), with_mask=False)
    _assert_close(_torch_value_and_grad(tf, desc, wdesc),
                  _jax_value_and_grad(jf, desc, wdesc))


@pytest.mark.parametrize("kind", ["hinge", "mse", "hinge_hn"])
def test_global_loss_matches_jax(kind):
    logits, targets, mask = _detector_case(7)
    wlogits, wtargets, _ = _detector_case(8)
    desc, wdesc, homog, _ = _descriptor_case(9, 2, 6, 8, 32)
    jcfg = JaxConfig(descriptor_loss=kind, use_pallas_desc_loss="off")
    tcfg = SuperPointConfig(descriptor_loss=kind)

    def jf(lg, wl, d, w):
        return jloss.global_loss(lg, jnp.asarray(targets), wl, jnp.asarray(wtargets),
                                 d, w, jnp.asarray(homog), jnp.asarray(mask), jcfg)

    def tf(lg, wl, d, w):
        return tloss.global_loss(lg, torch.from_numpy(targets), wl,
                                 torch.from_numpy(wtargets), d, w,
                                 torch.from_numpy(homog), torch.from_numpy(mask), tcfg)

    xs = (logits, wlogits, desc, wdesc)
    want = _jax_value_and_grad(lambda *a: jf(*a)["total"], *xs)
    got = _torch_value_and_grad(lambda *a: tf(*a)["total"], *xs)
    _assert_close(got, want)
    parts_j = jf(*[jnp.asarray(x) for x in xs])
    parts_t = tf(*[torch.from_numpy(x) for x in xs])
    assert set(parts_t) == set(parts_j) == {"detector", "warped_detector",
                                            "descriptor", "total"}
    for k in parts_j:
        np.testing.assert_allclose(float(parts_t[k]), float(parts_j[k]), rtol=1e-5)
