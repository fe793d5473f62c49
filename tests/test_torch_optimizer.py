"""PyTorch port parity: the optimizer against the JAX package's optax chain,
update for update on the same gradients, on the CPU in float32.

Parameters and gradients are made with numpy under the port's names and
carried to the Flax tree with `jax_variables_from_state_dict` (a
permutation of entries, so a gradient travels like its parameter).
Tolerance after every update: rtol 2e-5 + atol 2e-7 on every parameter (the
port multiplies by reciprocals of the bias corrections and by clip / norm
where optax divides: an ulp or two per update on values of order 0.1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
from feature_point_cnn_tpu.train import optimizer as jopt

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
from feature_point_cnn_tpu_torch.train import optimizer as topt
from feature_point_cnn_tpu_torch.utils.weights import (
    jax_variables_from_state_dict,
    state_dict_from_jax_variables,
)

D = 16   # a narrow descriptor keeps the trees small


def _model(seed=0):
    cfg = SuperPointConfig(descriptor_dim=D, compute_dtype="float32")
    m = SuperPoint(cfg, generator=torch.Generator().manual_seed(seed),
                   float32_params=True)
    rng = np.random.default_rng(seed)
    with torch.no_grad():       # BatchNorm scales/biases away from 1 and 0
        for n, p in m.named_parameters():
            if p.dim() == 1:
                p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    return m


def _jax_params(model):
    tree = jax_variables_from_state_dict(model.state_dict())["params"]
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _grads(model, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(p.shape) * scale).astype(np.float32)
            for n, p in model.named_parameters()}


def _grads_as_tree(model, grads):
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    for n, g in grads.items():
        sd[n] = torch.from_numpy(g)
    return jax.tree_util.tree_map(
        jnp.asarray, jax_variables_from_state_dict(sd)["params"])


def _assert_params_equal(model, jparams, msg=""):
    got = jax_variables_from_state_dict(model.state_dict())["params"]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(g, np.asarray(flat_w[path]), rtol=2e-5, atol=2e-7,
                                   err_msg=f"{msg} {jax.tree_util.keystr(path)}")


def test_decay_mask_picks_the_same_tensors_as_the_flax_rule():
    model = _model()
    jparams = _jax_params(model)
    jmask = jopt.decay_mask(jparams)
    # carry the mask to the port's names as arrays of 1.0 / 0.0
    as_arrays = jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, float(m), np.float32), jmask, jparams)
    stats = jax_variables_from_state_dict(model.state_dict())["batch_stats"]
    carried = state_dict_from_jax_variables({"params": as_arrays, "batch_stats": stats})
    names = [n for n, _ in model.named_parameters()]
    tmask = topt.decay_mask(names)
    assert set(tmask) == set(names) and len(names) > 80
    for n in names:
        assert bool(carried[n].flatten()[0]) == tmask[n], n
    assert tmask["encoder.conv1.weight"] and tmask["descriptor.up_sample.weight"]
    assert not tmask["encoder.layer1.0.identity_downsample.0.weight"]   # a conv
    assert not tmask["descriptor.up_sample.bias"] and not tmask["descriptor.bn.weight"]
    assert sum(tmask.values()) == sum(jax.tree_util.tree_leaves(jmask))


@pytest.mark.parametrize("total", [None, 50, 4000])
def test_schedule_matches_optax(total):
    kw = dict(learning_rate=2e-3, warmup_steps=200, lr_final_ratio=0.05)
    js = jopt.make_schedule(JaxConfig(**kw), total)
    ts = topt.make_schedule(SuperPointConfig(**kw), total)
    if total is None:
        assert js == ts == 2e-3
        return
    for count in (0, 1, 3, 5, 6, total // 2, total - 1, total, total + 10):
        np.testing.assert_allclose(float(ts(torch.tensor(count))), float(js(count)),
                                   rtol=1e-5, atol=1e-10, err_msg=str(count))
    assert float(ts(torch.tensor(0))) == 0.0      # the first warm-up step has lr 0
    with pytest.raises(ValueError):
        topt.make_schedule(SuperPointConfig(lr_schedule="step"), 10)


def _run_both(kw, steps, frozen=None, total=50):
    """``steps``: a list of (seed, scale, poison) gradient recipes.  Applies
    them through optax and through the port and compares after each."""
    model = _model()
    jparams = _jax_params(model)
    tx = jopt.make_optimizer(JaxConfig(descriptor_dim=D, **kw), jparams,
                             frozen_subtree=frozen, total_steps=total)
    opt_state = tx.init(jparams)
    opt = topt.make_optimizer(SuperPointConfig(descriptor_dim=D, **kw),
                              model.named_parameters(), frozen_subtree=frozen,
                              total_steps=total)
    counts = []
    for i, (seed, scale, poison) in enumerate(steps):
        grads = _grads(model, seed, scale)
        if poison:
            grads[poison].flat[3] = np.nan if i % 2 else np.inf
        updates, opt_state = tx.update(_grads_as_tree(model, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        opt.step()
        _assert_params_equal(model, jparams, f"update {i}")
        counts.append(int(opt.count))
    return model, opt, counts


def test_five_updates_match_optax_warmup_clip_and_skipped_step():
    """Warm-up from lr 0 (update 0 moves nothing), a clipped update (norm far
    above 5), an update inside the clip, two non-finite updates (inf, NaN)
    that must leave parameters, moments and count alone, then updates that
    show the moments were indeed untouched."""
    start = _model()
    steps = [(1, 1e-3, None), (2, 10.0, None), (3, 1e-3, None),
             (4, 1.0, "encoder.conv1.weight"), (5, 1.0, "descriptor.bn.bias"),
             (6, 1e-2, None), (7, 1.0, None)]
    model, opt, counts = _run_both(dict(lr_schedule="warmup_cosine"), steps)
    assert counts == [1, 2, 3, 3, 3, 4, 5]
    moved = [n for (n, p), (_, q) in zip(model.named_parameters(),
                                         start.named_parameters())
             if not torch.equal(p, q)]
    assert len(moved) == len(list(model.parameters()))
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_first_warmup_update_has_learning_rate_zero():
    model, opt, _ = _run_both(dict(lr_schedule="warmup_cosine"), [(1, 1.0, None)])
    fresh = _model()
    for (n, p), (_, q) in zip(model.named_parameters(), fresh.named_parameters()):
        assert torch.equal(p, q), n
    assert int(opt.count) == 1 and float(opt.learning_rate()) > 0.0


def test_constant_schedule_no_clip_no_decay_matches_optax():
    _run_both(dict(lr_schedule="constant", grad_clip_norm=0.0, weight_decay=0.0),
              [(1, 1.0, None), (2, 100.0, None), (3, 1.0, None)])


def test_frozen_subtree_matches_optax_and_never_moves():
    """MagicPoint phase: the descriptor subtree is frozen; a NaN in ITS
    gradient neither skips the update nor reaches the norm."""
    start = _model()
    steps = [(1, 1.0, None), (2, 1.0, "descriptor.bn.weight"), (3, 10.0, None)]
    model, opt, counts = _run_both(dict(lr_schedule="constant"), steps,
                                   frozen="descriptor")
    assert counts == [1, 2, 3]
    for (n, p), (_, q) in zip(model.named_parameters(), start.named_parameters()):
        assert torch.equal(p, q) == n.startswith("descriptor"), n
    assert not any(n.startswith("descriptor") for n in opt.names)


def test_grad_accum_steps_two_matches_optax_multisteps():
    start = _model()
    steps = [(1, 1.0, None), (2, 3.0, None), (3, 1.0, None), (4, 1.0, None),
             (5, 1.0, "encoder.bn1.weight"), (6, 1.0, None), (7, 1.0, None)]
    model, opt, counts = _run_both(
        dict(lr_schedule="constant", grad_accum_steps=2), steps)
    # updates land on every second call; the poisoned pair is skipped
    assert counts == [0, 1, 1, 2, 2, 2, 2]
    assert opt.mini_step == 1


def test_optimizer_state_dict_round_trip():
    model, opt, _ = _run_both(dict(lr_schedule="constant"), [(1, 1.0, None)] * 2)
    state = {k: (v.clone() if torch.is_tensor(v) else v)
             for k, v in opt.state_dict().items()}
    other = topt.make_optimizer(SuperPointConfig(descriptor_dim=D,
                                                 lr_schedule="constant"),
                                _model().named_parameters())
    other.load_state_dict(state)
    assert int(other.count) == 2
    assert all(torch.equal(a, b) for a, b in zip(other.mu, opt.mu))
    frozen = topt.make_optimizer(SuperPointConfig(descriptor_dim=D),
                                 _model().named_parameters(), "descriptor")
    with pytest.raises(KeyError):
        frozen.load_state_dict(state)
