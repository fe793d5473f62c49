"""PyTorch port parity: the training slice as a whole against the JAX
package, on the CPU in float32 (JAX side: ``compute_dtype="float32"``,
``use_pallas_desc_loss="off"``; the Pallas route is held in
`tests/test_torch_losses.py`).

Both sides start from the same Flax-initialised variables, carried to the
port with `state_dict_from_jax_variables` and back with
`jax_variables_from_state_dict`.  Tolerances: train-mode forward outputs
atol 3e-4 + rtol 1e-4 on values up to ~8 (convolutions sum in another order,
and each of the 27 train-mode BatchNorms divides by a batch deviation
computed from those sums; measured 1.3e-4, the same whether the port
normalises by E[x^2] - E[x]^2 or by PyTorch's own batch variance); new
BatchNorm statistics atol 2e-5 + rtol 1e-4; losses and gradient norms rtol
2e-4; updated parameters atol 2e-6 + rtol 1e-4.  The steps run with
``adam_eps = 1.0``: the first Adam update is lr * g / (|g| + eps).  At the
default 1e-8 that is nearly the SIGN of each gradient entry, so entries
whose true gradient is zero (a convolution bias in front of a BatchNorm)
move by +-lr on float noise alone; and the backward through 27 train-mode
BatchNorms over a few hundred samples a channel leaves ~3e-4 of absolute
float noise on gradient entries (norms of order 10), which eps = 1e-3 still
turns into 1e-4 on a parameter.  With eps = 1 the update is lr * g / (1 +
|g|), so the parameter comparison holds every gradient ENTRY to ~2e-3
absolute; the update rule itself is held to optax at the default eps in
`tests/test_torch_optimizer.py`.  At lr 1e-3 a tensor's update has an rms of
1e-6 to 2e-5, near that atol, so each tensor's UPDATE (new minus initial
parameters) is also held to JAX's: the norm of the difference is at most
1e-2 of the update's norm (measured up to 3.5e-3, on the 1x1 convolutions of
the descriptor head), which a tensor left unmoved, or moved by a wrong
gradient, cannot meet (plus one ulp of the parameter an entry, at most a
few percent of an update); a tensor that JAX leaves alone must not move.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.config import HomographyConfig as JaxHomographyConfig
from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
from feature_point_cnn_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from feature_point_cnn_tpu.models.superpoint import init_superpoint
from feature_point_cnn_tpu.train import steps as jsteps
from feature_point_cnn_tpu.train.optimizer import make_optimizer as jax_make_optimizer

from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
from feature_point_cnn_tpu_torch.train import steps as tsteps
from feature_point_cnn_tpu_torch.train.optimizer import make_optimizer
from feature_point_cnn_tpu_torch.utils.weights import (
    jax_variables_from_state_dict,
    state_dict_from_jax_variables,
)

H, W, D = 48, 64, 32
KW = dict(train_image_size=(H, W), descriptor_dim=D, compute_dtype="float32",
          lr_schedule="constant", adam_eps=1.0, max_points=16)
NO_FAMILIES = dict(perspective=False, scaling=False, rotation=False,
                   translation=False)


@functools.lru_cache(maxsize=None)
def _jax_init():
    cfg = JaxConfig(use_pallas_desc_loss="off", **KW)
    # jitted: the same bits as op by op, in a third of the time
    variables = jax.jit(lambda key: init_superpoint(key, cfg)[1])(jax.random.PRNGKey(0))
    model = JaxSuperPoint(config=cfg)
    rng = np.random.default_rng(0)

    def jitter(path, x):      # BatchNorm scales, biases and statistics off 1 / 0
        name = jax.tree_util.keystr(path)
        if x.ndim == 1:
            r = rng.standard_normal(x.shape).astype(np.float32) * 0.2
            return jnp.asarray(np.abs(1 + r) if ("scale" in name or "var" in name) else r)
        return x
    return cfg, model, jax.tree_util.tree_map_with_path(jitter, variables)


def _torch_state(frozen=None, **over):
    _, _, variables = _jax_init()
    cfg = SuperPointConfig(**{**KW, **over})
    model = SuperPoint(cfg, float32_params=True)
    model.load_state_dict(state_dict_from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))
    opt = make_optimizer(cfg, model.named_parameters(), frozen_subtree=frozen)
    return cfg, tsteps.create_train_state(model, opt)


def _jax_state(frozen=None, **over):
    cfg, model, variables = _jax_init()
    cfg = cfg.replace(**over)
    tx = jax_make_optimizer(cfg, variables["params"], frozen_subtree=frozen)
    return cfg, model, tx, jsteps.create_train_state(variables, tx)


def _batch(seed, b, u8_gray=False):
    """Images and at most one point a cell, at x.5 offsets (so truncation to
    a pixel is stable under a 1e-4 px wobble)."""
    rng = np.random.default_rng(seed)
    if u8_gray:
        image = rng.integers(0, 256, (b, H, W, 1), dtype=np.uint8)
    else:
        image = rng.random((b, H, W, 3)).astype(np.float32)
    pts = np.zeros((b, 16, 2), np.float32)
    valid = np.zeros((b, 16), bool)
    for i in range(b):
        cells = rng.choice((H // 8) * (W // 8), 12, replace=False)
        inside = rng.integers(1, 7, (12, 2))
        pts[i, :12, 0] = (cells // (W // 8)) * 8 + inside[:, 0] + 0.5
        pts[i, :12, 1] = (cells % (W // 8)) * 8 + inside[:, 1] + 0.5
        valid[i, :12] = True
    return {"image": image, "points": pts, "points_valid": valid}


def _to_torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _to_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _assert_tree_close(sd, jax_tree, top, rtol, atol, what):
    got = jax_variables_from_state_dict(sd)[top]
    want = dict(jax.tree_util.tree_flatten_with_path(jax_tree)[0])
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat) == len(want)
    for path, g in flat:
        np.testing.assert_allclose(
            g, np.asarray(want[path]), rtol=rtol, atol=atol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _assert_updates_close(sd, jax_params, rtol):
    """Per tensor: ||(port - initial) - (jax - initial)|| <= rtol ||jax - initial||
    plus what float32 storage of the parameters cannot resolve."""
    initial = dict(jax.tree_util.tree_flatten_with_path(_jax_init()[2]["params"])[0])
    want = dict(jax.tree_util.tree_flatten_with_path(jax_params)[0])
    moved = 0
    for path, g in jax.tree_util.tree_flatten_with_path(
            jax_variables_from_state_dict(sd)["params"])[0]:
        start = np.asarray(initial[path])
        delta_jax = np.asarray(want[path]) - start
        miss = np.linalg.norm((g - start) - delta_jax)
        floor = np.linalg.norm(np.spacing(np.abs(start)))   # one ulp an entry
        assert miss <= rtol * np.linalg.norm(delta_jax) + floor, (
            f"update of {jax.tree_util.keystr(path)}: off by {miss:.3g} of "
            f"{np.linalg.norm(delta_jax):.3g}")
        moved += bool(np.any(delta_jax != 0))
    assert moved > len(want) // 2


def _assert_step_matches(tstate, tmetrics, jstate, jmetrics, heads,
                         update_rtol=1e-2):
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   rtol=2e-4, atol=1e-6, err_msg=k)
    for head in heads:
        assert float(tmetrics[f"grad_norm/{head}"]) > 0
    sd = tstate.model.state_dict()
    _assert_tree_close(sd, jstate.params, "params", 1e-4, 2e-6, "param")
    _assert_updates_close(sd, jstate.params, update_rtol)
    _assert_tree_close(sd, jstate.batch_stats, "batch_stats", 1e-4, 2e-5, "stat")
    assert tstate.step == int(jstate.step) == 1


def test_train_mode_forward_of_both_views_matches_jax():
    """One forward of 2B images in train mode: logits, descriptors and the
    new running statistics (Flax's biased variance, momentum 0.1)."""
    _, jmodel, variables = _jax_init()
    _, state = _torch_state()
    both = np.random.default_rng(1).random((4, H, W, 3)).astype(np.float32)
    (_, jdesc, jlogits), mutated = jmodel.apply(
        variables, jnp.asarray(both), train=True, enable_descriptor=True,
        mutable=["batch_stats"])
    model = state.model.train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    logits, desc = model.features(torch.from_numpy(both))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=3e-4)
    np.testing.assert_allclose(desc.detach().numpy(), np.asarray(jdesc),
                               rtol=1e-4, atol=3e-4)
    sd = model.state_dict()
    _assert_tree_close(sd, mutated["batch_stats"], "batch_stats", 1e-4, 2e-5, "stat")
    assert not torch.equal(sd["encoder.bn1.running_var"], before["encoder.bn1.running_var"])
    # PyTorch's own BatchNorm would store the unbiased variance instead
    n = 4 * (H // 2) * (W // 2)
    x = model.encoder.conv1(torch.from_numpy(both).permute(0, 3, 1, 2))
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    want = 0.9 * before["encoder.bn1.running_var"] + 0.1 * biased
    np.testing.assert_allclose(sd["encoder.bn1.running_var"].numpy(),
                               want.detach().numpy(), rtol=1e-4)
    assert n / (n - 1) > 1.0001    # the two conventions are distinguishable here
    # eval mode reads the statistics and leaves them alone
    model.eval()
    model.features(torch.from_numpy(both))
    assert torch.equal(model.state_dict()["encoder.bn1.running_var"],
                       sd["encoder.bn1.running_var"])


def _jax_encoded(batch, key, cfg, homo):
    warped, labels, wlabels, cell_mask, homog, images = jsteps._augment_and_encode(
        _to_jax(batch), key, cfg, homo)
    return {"images": images, "warped": warped, "labels": labels,
            "wlabels": wlabels, "cell_mask": cell_mask, "homog": homog}


@pytest.mark.parametrize("k", [1, 2], ids=["whole_batch", "microbatch_2"])
def test_joint_step_on_jax_encoded_data_matches_jax(k):
    """One joint step on the views, labels, mask and homographies that the
    JAX `_augment_and_encode` made (default homography family): losses,
    per-head gradient norms, every updated parameter and statistic.  With
    ``microbatch_steps = 2`` also the strided split and the statistics
    threaded through the microbatches in order."""
    b = 2 * k
    jcfg, jmodel, tx, jstate = _jax_state(microbatch_steps=k)
    tcfg, tstate = _torch_state(microbatch_steps=k)
    batch, key = _batch(2, b), jax.random.PRNGKey(3)
    data = _jax_encoded(batch, key, jcfg, JaxHomographyConfig())
    assert float(jnp.abs(data["homog"] - jnp.asarray([1, 0, 0, 0, 1, 0, 0, 0.0])).max()) > 0.1
    jstate, jmetrics = jsteps.superpoint_train_step(
        jstate, _to_jax(batch), key, model=jmodel, tx=tx, config=jcfg)
    tdata = _to_torch({n: np.asarray(v) for n, v in data.items()})
    tdata["labels"], tdata["wlabels"] = tdata["labels"].long(), tdata["wlabels"].long()
    tstate, tmetrics = tsteps.superpoint_train_step_encoded(tstate, tdata, config=tcfg)
    if k > 1:      # the JAX step pairs microbatch-ordered logits with unsplit labels
        jmetrics = dict(jmetrics)
        tmetrics = dict(tmetrics)
        jmetrics.pop("f1"), tmetrics.pop("f1")
    _assert_step_matches(tstate, tmetrics, jstate, jmetrics,
                         ("encoder", "detector", "descriptor"))


def test_microbatch_two_is_close_to_the_whole_batch():
    """k = 2 against k = 1 in the port: the same data and parameters, but
    BatchNorm normalises each half by its own statistics, so losses agree
    only loosely (5%) and gradients point roughly the same way."""
    data = None
    out = {}
    for k in (1, 2):
        tcfg, tstate = _torch_state(microbatch_steps=k)
        if data is None:
            data = tsteps._augment_and_encode(
                _to_torch(_batch(4, 4)), torch.Generator().manual_seed(0), tcfg,
                HomographyConfig())
            data = dict(zip(("warped", "labels", "wlabels", "cell_mask", "homog",
                             "images"), data))
        _, m = tsteps.superpoint_train_step_encoded(tstate, data, config=tcfg)
        out[k] = (m, torch.cat([p.grad.flatten() for p in tstate.model.parameters()]))
    np.testing.assert_allclose(float(out[2][0]["loss"]), float(out[1][0]["loss"]),
                               rtol=0.05)
    cos = torch.nn.functional.cosine_similarity(out[1][1], out[2][1], dim=0)
    assert float(cos) > 0.5
    with pytest.raises(ValueError, match="divisible"):
        tsteps.superpoint_train_step_encoded(
            _torch_state()[1], data, config=_torch_state(microbatch_steps=3)[0])


def test_prep_images_u8_gray_matches_jax():
    batch = _batch(5, 2, u8_gray=True)
    jcfg, _, _, _ = _jax_state()
    tcfg, _ = _torch_state()
    want = np.asarray(jsteps._prep_images(jnp.asarray(batch["image"]), jcfg))
    got = tsteps._prep_images(torch.from_numpy(batch["image"]), tcfg)
    assert got.shape == (2, H, W, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_magicpoint_step_on_u8_gray_matches_jax_and_freezes_descriptor():
    """Whole MagicPoint step on both sides (at most one point a cell, so
    neither side's tie-break noise changes a label), u8 gray input."""
    jcfg, jmodel, tx, jstate = _jax_state(frozen="descriptor")
    tcfg, tstate = _torch_state(frozen="descriptor")
    before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    batch = _batch(6, 2, u8_gray=True)
    jeval = jsteps.magicpoint_eval_step(jstate, _to_jax(batch), jax.random.PRNGKey(1),
                                        model=jmodel, config=jcfg)
    teval = tsteps.magicpoint_eval_step(tstate, _to_torch(batch),
                                        torch.Generator().manual_seed(1), config=tcfg)
    for k in jeval:
        np.testing.assert_allclose(float(teval[k]), float(jeval[k]), rtol=2e-4, atol=1e-6)
    jstate, jmetrics = jsteps.magicpoint_train_step(
        jstate, _to_jax(batch), jax.random.PRNGKey(1), model=jmodel, tx=tx, config=jcfg)
    tstate, tmetrics = tsteps.magicpoint_train_step(
        tstate, _to_torch(batch), torch.Generator().manual_seed(1), config=tcfg)
    assert float(tmetrics["grad_norm/descriptor"]) == 0.0
    _assert_step_matches(tstate, tmetrics, jstate, jmetrics, ("encoder", "detector"))
    after = tstate.model.state_dict()
    for k in after:
        if k.startswith("descriptor"):
            assert torch.equal(after[k], before[k]), k


def test_whole_superpoint_step_matches_jax_when_no_draw_matters():
    """`superpoint_train_step` end to end on both sides, each with its own
    random draws: with the four homography families off the sampled
    homography is the identity (up to the 8x8 solve's rounding), and with at
    most one point a cell the label noise decides nothing."""
    jcfg, jmodel, tx, jstate = _jax_state()
    tcfg, tstate = _torch_state()
    batch = _batch(7, 2)
    jstate, jmetrics = jsteps.superpoint_train_step(
        jstate, _to_jax(batch), jax.random.PRNGKey(5), model=jmodel, tx=tx,
        config=jcfg, homo_config=JaxHomographyConfig(**NO_FAMILIES))
    tstate, tmetrics = tsteps.superpoint_train_step(
        tstate, _to_torch(batch), torch.Generator().manual_seed(5), config=tcfg,
        homo_config=HomographyConfig(**NO_FAMILIES))
    # each side warps by its own near-identity homography, so the views
    # differ in the last bits and the updates agree to 1.8e-2 (measured, on
    # the descriptor head's transposed convolution), not 3.5e-3
    _assert_step_matches(tstate, tmetrics, jstate, jmetrics,
                         ("encoder", "detector", "descriptor"), update_rtol=5e-2)
    jeval = jsteps.superpoint_eval_step(
        jstate, _to_jax(batch), jax.random.PRNGKey(6), model=jmodel, config=jcfg,
        homo_config=JaxHomographyConfig(**NO_FAMILIES))
    teval = tsteps.superpoint_eval_step(
        tstate, _to_torch(batch), torch.Generator().manual_seed(6), config=tcfg,
        homo_config=HomographyConfig(**NO_FAMILIES))
    assert set(teval) == set(jeval)
    for k in jeval:
        np.testing.assert_allclose(float(teval[k]), float(jeval[k]), rtol=5e-4, atol=1e-6)


class Scenes:
    """Six items for `BatchLoader`."""

    def __init__(self):
        b = _batch(8, 6)
        self.items = [(b["image"][i], b["points"][i, :12]) for i in range(6)]

    def __len__(self):
        return len(self.items)

    def read(self, i):
        return self.items[i]


def test_trainer_trains_resumes_and_grafts(tmp_path):
    """`Trainer` on the CPU: MagicPoint epochs, a resumed run that has
    nothing left to do, the SuperPoint graft from the checkpoint directory
    and from the `.npz` snapshot (encoder and detector carried over, the
    descriptor head fresh), and the snapshot read back in the JAX layout."""
    from feature_point_cnn_tpu.utils.weights import load_weights as jax_load_weights
    from feature_point_cnn_tpu_torch.data.datasets import BatchLoader
    from feature_point_cnn_tpu_torch.train.trainer import Trainer

    cfg = SuperPointConfig(**{**KW, "batch_size": 2, "epochs": 2, "adam_eps": 1e-8})
    loader = BatchLoader(Scenes(), 2, cfg.max_points)
    assert len(loader) == 3 and next(loader.epoch(0))["points"].shape == (2, 16, 2)
    snap = str(tmp_path / "mp.npz")
    mp = Trainer(cfg, "magicpoint", loader, loader, str(tmp_path / "mp"), device="cpu",
                 log_every=1, snapshot_path=snap)
    fresh_desc = mp.state.model.descriptor.layer_in[0].conv1.weight.clone()
    mp.train()
    assert mp.state.step == 6 and int(mp.state.optimizer.count) == 6
    assert torch.equal(mp.state.model.descriptor.layer_in[0].conv1.weight, fresh_desc)

    again = Trainer(cfg, "magicpoint", loader, None, str(tmp_path / "mp"), device="cpu")
    assert again.start_epoch == 2 and again.state.step == 6
    assert int(again.state.optimizer.count) == 6
    assert torch.equal(again.state.model.encoder.conv1.weight,
                       mp.state.model.encoder.conv1.weight)

    for source in (str(tmp_path / "mp"), snap):
        sp = Trainer(cfg, "superpoint", loader, loader, str(tmp_path / "sp"),
                     magicpoint_checkpoint_dir=source, device="cpu", seed=1)
        assert sp.start_epoch == 0
        torch.testing.assert_close(sp.state.model.detector.layer[1].bn2.running_var,
                                   mp.state.model.detector.layer[1].bn2.running_var)
        assert not torch.equal(sp.state.model.descriptor.layer_in[0].conv1.weight,
                               fresh_desc)
    m = sp.train_epoch(0)
    assert np.isfinite(m["loss"]) and m["grad_norm/descriptor"] > 0
    assert set(sp.evaluate(0)) == {"loss", "descriptor_loss", "f1"}

    back = jax_load_weights(snap)
    got = jax_variables_from_state_dict(mp.state.model.state_dict())
    np.testing.assert_array_equal(back["params"]["encoder"]["conv1"]["kernel"],
                                  got["params"]["encoder"]["conv1"]["kernel"])
    with pytest.raises(ValueError):
        Trainer(cfg, "descriptor", loader, None, str(tmp_path / "x"), device="cpu")


def test_trainer_resume_with_another_optimizer_layout_keeps_the_model(tmp_path, capsys):
    """A checkpoint whose optimizer state is for another parameter set (a
    MagicPoint checkpoint, descriptor frozen, resumed as SuperPoint): the
    model and the step are restored, the optimizer starts anew and the
    trainer says so, as the JAX trainer does (`train/trainer.py:88-104`)."""
    from feature_point_cnn_tpu_torch.data.datasets import BatchLoader
    from feature_point_cnn_tpu_torch.train.trainer import Trainer

    cfg = SuperPointConfig(**{**KW, "batch_size": 2, "epochs": 1, "adam_eps": 1e-8})
    loader = BatchLoader(Scenes(), 2, cfg.max_points)
    mp = Trainer(cfg, "magicpoint", loader, None, str(tmp_path / "ck"), device="cpu")
    mp.train()
    assert int(mp.state.optimizer.count) == 3
    capsys.readouterr()
    sp = Trainer(cfg, "superpoint", loader, None, str(tmp_path / "ck"), device="cpu",
                 seed=1)
    assert "fresh optimizer" in capsys.readouterr().out
    assert sp.start_epoch == 1 and sp.state.step == 3
    assert int(sp.state.optimizer.count) == 0
    assert all(not m.any() for m in sp.state.optimizer.mu)
    for k, v in mp.state.model.state_dict().items():
        assert torch.equal(sp.state.model.state_dict()[k], v), k
