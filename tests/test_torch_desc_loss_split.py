"""PyTorch port: the arithmetic of the tensor-core descriptor-loss kernels,
emulated on the CPU.

The CUDA kernels compute each ``d . wd`` product on the tensor cores as three
TF32 products of operands split into ``hi + lo``
(`feature_point_cnn_tpu_torch/csrc/descriptor_loss.cu`).  They run only on the
card; `split_tf32_product` below repeats their products in plain PyTorch
(round to nearest to TF32's 11 significant bits by Veltkamp's split, the
remainder read as the tensor cores read it, three float32 ``einsum``s; the
tensor cores' truncating adder is not modelled), and the package's
`_hinge_from_dots` is the plain version's hinge on given ``relu(d . wd)``, so
the split can be held to the plain version and to the JAX loss here.  Inputs
are those of `tests/test_torch_cuda_kernels.py` (numpy, seed 0).

Tolerances and their reasons:

- the split product is within 1e-6 of a float64 product on unit rows (the
  dropped ``lo.lo`` term and the float32 sums leave ~2e-7, the same as a
  float32 ``einsum``) and at least 100 times closer than one TF32 product
  (~1e-4 to 5e-4: TF32 keeps 11 bits);
- the loss through the split product holds the CUDA kernels' tolerances
  against `hinge_descriptor_loss_plain`: value rtol 2e-5, gradients rtol
  2e-4 + atol 2e-6 on the loss scaled as `descriptor_loss` normalises it;
- the loss through ONE TF32 product does not hold the gradient tolerance at
  (3, 9, 15, 128): 1e-4 errors in the dot products flip the hinge's
  comparisons.  That is why the kernels split, kept as a test;
- the port's `descriptor_loss` with the split product in place of the plain
  one holds the same tolerances against the JAX package's `descriptor_loss`
  on the same numpy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
from feature_point_cnn_tpu.train import loss as jloss

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.ops.kernels.descriptor_loss import (
    _hinge_from_dots,
    hinge_descriptor_loss_plain,
)
from feature_point_cnn_tpu_torch.train import loss as tloss

SHAPES = [(2, 6, 8, 32), (1, 8, 16, 16), (2, 10, 14, 8), (3, 9, 15, 128)]
ZERO = (1, 4, 4, 8)
HINGE = (250.0, 1.0, 0.2, 8)
_id = lambda s: "x".join(map(str, s))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 11 significant bits, to nearest, by
    Veltkamp's split in float32 arithmetic, as the kernels round.  It has no
    gradient; `split_tf32_product` passes the gradient straight through."""
    x = x.detach()
    t = x * 8193.0
    return t - (t - x)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) with the 13 low mantissa bits cleared, as the tensor
    cores read a float32 register as TF32."""
    bits = x.detach().contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def split_tf32_product(d: torch.Tensor, wd: torch.Tensor,
                       terms: int = 3) -> torch.Tensor:
    """``einsum("bid,bjd->bij", d, wd)`` as the kernels multiply: each
    operand is split into ``hi = tf32(x)`` (to nearest) and ``lo = x - hi``
    (exact, then read by the tensor cores as TF32), and the product is
    ``lo.hi + hi.lo + hi.hi`` accumulated in float32 (the dropped ``lo.lo``
    is ~2^-22 relative).  ``terms=1`` keeps ``hi.hi`` only: one TF32
    product, ~3 decimal digits.  The rounding passes gradients through as
    the identity."""
    assert terms in (1, 3)

    def parts(x):
        hi = x + (round_tf32(x) - x.detach())        # the gradient goes to hi
        lo = truncate_tf32(x.detach() - hi.detach())  # the difference is exact
        return hi, lo

    def dot(p, q):
        return torch.einsum("bid,bjd->bij", p, q)

    d_hi, d_lo = parts(d)
    w_hi, w_lo = parts(wd)
    if terms == 1:
        return dot(d_hi, w_hi)
    return (dot(d_lo, w_hi) + dot(d_hi, w_lo)) + dot(d_hi, w_hi)


def _inputs(b, hc, wc, dim, zero=False):
    """Unit descriptors, cell centers moved by a mild affine map, and a
    mask with ~15% zeros."""
    rng = np.random.default_rng(0)
    n = hc * wc
    d = rng.standard_normal((2, b, n, dim))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if zero:
        d[:] = 0.0
    ys, xs = np.mgrid[0:hc, 0:wc]
    centers = np.stack([ys, xs], -1).reshape(n, 2) * 8.0 + 4.0
    warped = np.stack([centers[:, 0] * 0.98 + 0.02 * centers[:, 1] - 2.0,
                       centers[:, 1] * 1.02 + 0.01 * centers[:, 0] + 3.0], -1)
    warped = np.broadcast_to(warped, (b, n, 2))
    mask = rng.random((b, n)) > 0.15
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t(d[0]), t(d[1]), (t(warped), t(centers), t(mask.astype(np.float32)))


def _value_and_grads(loss, d, wd, scale):
    d = d.clone().requires_grad_(True)
    wd = wd.clone().requires_grad_(True)
    v = loss(d, wd) * scale
    v.backward()
    return v.detach(), d.grad, wd.grad


def _through(product, rest):
    return lambda d, wd: _hinge_from_dots(torch.relu(product(d, wd)), *rest, *HINGE)


def _scale(shape, rest):
    return 1.0 / max(float(rest[2].sum()) * shape[1] * shape[2], 1.0)


def test_round_and_truncate_to_tf32():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -0.3, 0.0, 1e-20])
    r, t = round_tf32(x), truncate_tf32(x)
    for y in (r, t):   # 13 low mantissa bits clear
        assert int((y.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float((r - x).abs().max()) <= 2.0 ** -11 * 1.0
    assert torch.all((t.abs() <= x.abs()) & ((x - t).abs() <= 2.0 ** -10 * x.abs()))
    assert float(r[2]) == 1.0 + 2.0 ** -10       # above the half: rounds up
    assert float(t[2]) == 1.0                     # truncation does not


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_split_product_is_float32_grade(shape):
    d, wd, _ = _inputs(*shape)
    ref = torch.einsum("bid,bjd->bij", d.double(), wd.double())
    err3 = float((split_tf32_product(d, wd) - ref).abs().max())
    err1 = float((split_tf32_product(d, wd, terms=1) - ref).abs().max())
    assert err3 <= 1e-6
    assert err1 >= 100 * err3


def test_split_product_of_zero_descriptors_is_zero():
    d, wd, _ = _inputs(*ZERO, zero=True)
    assert float(split_tf32_product(d, wd).abs().max()) == 0.0
    assert float(split_tf32_product(d, wd, terms=1).abs().max()) == 0.0


def test_hinge_from_dots_is_the_plain_version():
    d, wd, rest = _inputs(*SHAPES[0])
    a = torch.relu(torch.einsum("bid,bjd->bij", d, wd))
    assert torch.equal(_hinge_from_dots(a, *rest, *HINGE),
                       hinge_descriptor_loss_plain(d, wd, *rest, *HINGE))


@pytest.mark.parametrize("shape", SHAPES + [ZERO], ids=_id)
def test_loss_through_split_product_matches_plain(shape):
    d, wd, rest = _inputs(*shape, zero=shape == ZERO)
    scale = _scale(shape, rest)
    got = _value_and_grads(_through(split_tf32_product, rest), d, wd, scale)
    want = _value_and_grads(
        lambda a, b: hinge_descriptor_loss_plain(a, b, *rest, *HINGE), d, wd, scale)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=0.0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-6)


def test_single_tf32_product_breaks_the_gradients():
    shape = (3, 9, 15, 128)
    d, wd, rest = _inputs(*shape)
    scale = _scale(shape, rest)
    want = _value_and_grads(
        lambda a, b: hinge_descriptor_loss_plain(a, b, *rest, *HINGE), d, wd, scale)
    single = _value_and_grads(
        _through(lambda a, b: split_tf32_product(a, b, terms=1), rest), d, wd, scale)
    split = _value_and_grads(_through(split_tf32_product, rest), d, wd, scale)
    # the value survives one TF32 product (the sum averages the noise) ...
    torch.testing.assert_close(single[0], want[0], rtol=2e-5, atol=0.0)
    # ... the gradients do not
    assert not all(torch.allclose(g, w, rtol=2e-4, atol=2e-6)
                   for g, w in zip(single[1:], want[1:]))
    err = lambda got: max(float((g - w).abs().max()) for g, w in zip(got[1:], want[1:]))
    assert err(single) >= 100 * err(split)


@pytest.mark.parametrize("shape", [(2, 6, 8, 32), (2, 10, 14, 8), (2, 5, 7, 128)],
                         ids=_id)
def test_loss_through_split_product_matches_jax(shape, monkeypatch):
    """The port's `descriptor_loss` (raw descriptors, normalisation and all)
    with the kernels' product in place of the plain one, against the JAX
    package's loss on the same numpy inputs."""
    rng = np.random.default_rng(3)
    desc, wdesc = rng.standard_normal((2, *shape)).astype(np.float32)
    homog = np.tile(np.array([1.02, 0.01, 3.0, -0.02, 0.98, -2.0, 1e-4, -1e-4],
                             np.float32), (shape[0], 1))
    homog[-1, 2] += 8.0
    mask = (rng.random(shape[:3]) > 0.15).astype(np.float32)
    # the loss's kernel entry point (on the CPU the plain product) replaced
    monkeypatch.setattr(
        tloss, "hinge_descriptor_loss_cuda",
        lambda d, wd, *rest: _hinge_from_dots(
            torch.relu(split_tf32_product(d, wd)), *rest))
    td = torch.from_numpy(desc).requires_grad_(True)
    tw = torch.from_numpy(wdesc).requires_grad_(True)
    got = tloss.descriptor_loss(td, tw, torch.from_numpy(homog),
                                torch.from_numpy(mask), SuperPointConfig())
    got.backward()
    want, grads = jax.value_and_grad(
        lambda d, w: jloss.descriptor_loss(
            d, w, jnp.asarray(homog), jnp.asarray(mask),
            JaxConfig(use_pallas_desc_loss="off")), argnums=(0, 1))(
        jnp.asarray(desc), jnp.asarray(wdesc))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=2e-5)
    for g, w in zip((td.grad, tw.grad), grads):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-6)
