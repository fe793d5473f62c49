"""PyTorch port: W-sharded training (`train/steps.py` inside
`parallel.spatial.width_group`), on the CPU over gloo, against JAX's GSPMD
step on a W-sharded batch and the port's one-process step.

One module-scoped job of 4 ranks of this file's ``__main__`` (no JAX in
them) runs every scenario on a width mesh of its d ranks (the job's group
or a subgroup of its first ranks), each writing an npz a scenario.
`tests/test_torch_train_step.py`'s model: 48 px high, ``descriptor_dim=32``,
float32, JAX-initialised weights with every BatchNorm jittered off 1 / 0,
``adam_eps = 1``, a constant schedule, B = 2, at most one point a cell at
x.5 offsets (so no label's tie-break noise decides anything and the two
packages' different draws do not matter).

* Against JAX's GSPMD step (the image W-sharded over JAX's 2-device width
  mesh, the state replicated, each step jitted once): `magicpoint_train_step`
  (descriptor frozen) and `superpoint_train_step_encoded` fed the
  whole-width output of JAX's `_augment_and_encode`, at 48x64, d = 2;
  losses, metrics, per-head gradient norms, every parameter and each
  tensor's update, and the BatchNorm statistics at
  `tests/test_torch_train_step.py`'s tolerances.
* Against the port's one-process step with the same generator seed:
  `superpoint_train_step` at 48x64 / d = 2, 48x16 / d = 2 (8 px a shard:
  rank 1's 1/16 block is empty), 48x24 / d = 3 and with ``microbatch_steps
  = 2`` at 48x64 / d = 2 (a microbatch of one item: rank 1 computes no
  descriptor loss), the hard-negative hinge at 48x64 / d = 2 and the
  correspondence MSE at 48x24 / d = 3 (rank 2 has no item),
  `magicpoint_train_step` with ``photometric_augment`` at 48x64 / d = 4,
  both JAX cases, and both eval steps.  The scenarios
  but the JAX ones run the model in float64 (the losses stay float32), as
  `tests/test_torch_distributed.py` does: in float32 a ReLU at its kink
  flips on rounding noise, and in the microbatched step the one-process
  encoder's gradient norm then moved by 3.5e-5 relative, away from the
  float64 value that the sharded step kept.  Measured: metrics within
  1.1e-7 relative (the float32 losses; eval steps, float32, 8.1e-8), the
  float64 state within 8.7e-16, the JAX cases' float32 state within
  2.4e-7; held to metrics rtol 1e-6 and the state to atol 1e-12 (float64)
  or 1e-6 (float32).
* The parts, float64: `_GroupBatchNorm` over a width group of blocks 3, 0
  and 4 columns wide against `F.batch_norm` on the whole tensor (``y``,
  the running statistics and every gradient within 1e-12 of each tensor's
  largest entry); the width gather's forward and backward exact.
* Every rank ends each step with the same parameters, statistics and
  optimizer moments bit for bit; each rank ran the plain loss on the items
  ``r, r + d, ...`` of each microbatch (none where it has none); a data
  group inside a width group raises.
"""

import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
from feature_point_cnn_tpu_torch.parallel import mesh as M
from feature_point_cnn_tpu_torch.parallel import spatial
from feature_point_cnn_tpu_torch.train import steps as S
from feature_point_cnn_tpu_torch.train.optimizer import make_optimizer

RANKS = 4
H, D, B, P = 48, 32, 2, 16
KW = dict(descriptor_dim=D, compute_dtype="float32", lr_schedule="constant",
          adam_eps=1.0, max_points=P)
# name: (W, d, step, config overrides, batch seed, generator seed)
STEPS = {
    "mp_jax": (64, 2, "magicpoint", {}, 6, 1),
    "sp_encoded_jax": (64, 2, "encoded", {}, 2, 3),
    "sp_w64_d2": (64, 2, "superpoint", {}, 7, 5),
    "sp_w16_d2": (16, 2, "superpoint", {}, 8, 6),
    "sp_w24_d3": (24, 3, "superpoint", {}, 9, 7),
    "mp_photo_w64_d4": (64, 4, "magicpoint", {"photometric_augment": True}, 10, 8),
    "sp_micro2_w64_d2": (64, 2, "superpoint", {"microbatch_steps": 2}, 11, 9),
    "sp_hn_w64_d2": (64, 2, "superpoint", {"descriptor_loss": "hinge_hn"}, 14, 12),
    "sp_mse_w24_d3": (24, 3, "superpoint", {"descriptor_loss": "mse"}, 15, 13),
}
EVALS = {"magicpoint": (64, 2, 12, 10), "superpoint": (64, 2, 13, 11)}
# the steps whose descriptor loss is the hinge of the kernels
DESC_STEPS = [n for n, s in STEPS.items()
              if s[2] != "magicpoint" and "descriptor_loss" not in s[3]]
# the exactness of the parts: BatchNorm over blocks of these widths (an
# empty one included), and the width gather over d = 2
BN_WIDTHS = (3, 0, 4)
GATHER_D = 2


def _batch(seed, w, b=B):
    """Images and at most one point a cell at x.5 offsets (as
    `tests/test_torch_train_step.py::_batch`, at width ``w``)."""
    rng = np.random.default_rng(seed)
    cells_w = w // 8
    n = min(12, (H // 8) * cells_w)
    image = rng.random((b, H, w, 3)).astype(np.float32)
    pts = np.zeros((b, P, 2), np.float32)
    valid = np.zeros((b, P), bool)
    for i in range(b):
        cells = rng.choice((H // 8) * cells_w, n, replace=False)
        inside = rng.integers(1, 7, (n, 2))
        pts[i, :n, 0] = (cells // cells_w) * 8 + inside[:, 0] + 0.5
        pts[i, :n, 1] = (cells % cells_w) * 8 + inside[:, 1] + 0.5
        valid[i, :n] = True
    return {"image": torch.from_numpy(image), "points": torch.from_numpy(pts),
            "points_valid": torch.from_numpy(valid)}


def _state(state_dict, w, step, over, double=False):
    cfg = SuperPointConfig(train_image_size=(H, w), **{**KW, **over})
    model = SuperPoint(cfg, float32_params=True)
    model.load_state_dict(state_dict)
    if double:      # the model in float64 (the losses stay float32)
        model.double()
        model.compute_dtype = torch.float64
    frozen = "descriptor" if step == "magicpoint" else None
    opt = make_optimizer(cfg, model.named_parameters(), frozen_subtree=frozen)
    return cfg, S.create_train_state(model, opt)


def _run_step(inputs, name, mesh=None):
    """Scenario ``name``'s step, W-sharded over ``mesh`` (``None``: one
    process on the whole batch): metrics, and the state after it."""
    w, _, step, over, _, gseed = STEPS[name]
    cfg, state = _state(inputs["state_dict"], w, step, over, double="jax" not in name)
    gen = torch.Generator().manual_seed(gseed)
    batch = inputs["batches"][name]
    if mesh is not None:
        batch = dict(batch, image=M.shard_images_spatial(batch["image"], mesh))
    with spatial.width_group(None if mesh is None else mesh.group):
        if step == "magicpoint":
            _, m = S.magicpoint_train_step(state, batch, gen, config=cfg)
        elif step == "superpoint":
            _, m = S.superpoint_train_step(state, batch, gen, config=cfg)
        else:
            _, m = S.superpoint_train_step_encoded(state, inputs["encoded"], config=cfg)
    return ({k: float(v) for k, v in m.items()}, state)


def _run_eval(inputs, kind, mesh=None):
    w, _, _, gseed = EVALS[kind]
    _, state = _state(inputs["state_dict"], w, kind, {})
    cfg = state.model.config
    batch = inputs["evals"][kind]
    if mesh is not None:
        batch = dict(batch, image=M.shard_images_spatial(batch["image"], mesh))
    fn = S.magicpoint_eval_step if kind == "magicpoint" else S.superpoint_eval_step
    with spatial.width_group(None if mesh is None else mesh.group):
        m = fn(state, batch, torch.Generator().manual_seed(gseed), config=cfg)
    return {k: float(v) for k, v in m.items()}


def _state_arrays(state):
    return {**{f"sd/{k}": v.numpy() for k, v in state.model.state_dict().items()},
            **{f"mu/{i}": m.numpy() for i, m in enumerate(state.optimizer.mu)},
            **{f"nu/{i}": v.numpy() for i, v in enumerate(state.optimizer.nu)}}


# ---------------------------------------------------------------------------
# the ranks (no JAX here)

def _parts(inputs, rank):
    """float64: train-mode BatchNorm over the d = 3 width group of blocks
    `BN_WIDTHS` wide, and the width gather over d = 2."""
    from feature_point_cnn_tpu_torch.models.blocks import BatchNorm2d
    from feature_point_cnn_tpu_torch.parallel.collectives import all_sum_

    out = {}
    mesh = M.make_spatial_mesh(len(BN_WIDTHS))
    if mesh.member:
        bn_in = inputs["bn"]
        a = sum(BN_WIDTHS[:rank])
        cols = slice(a, a + BN_WIDTHS[rank])
        bn = BatchNorm2d(bn_in["x"].shape[1]).double().train()
        bn.load_state_dict(bn_in["state"])
        x = bn_in["x"][..., cols].clone().requires_grad_(True)
        with spatial.width_group(mesh.group):
            y = bn(x)
            (y * bn_in["r"][..., cols]).sum().backward()
        out.update({"bn/y": y.detach().numpy(), "bn/dx": x.grad.numpy(),
                    "bn/dw": all_sum_(bn.weight.grad, mesh.group).numpy(),
                    "bn/db": all_sum_(bn.bias.grad, mesh.group).numpy(),
                    "bn/mean": bn.running_mean.numpy(), "bn/var": bn.running_var.numpy()})
    mesh = M.make_spatial_mesh(GATHER_D)
    if mesh.member:
        whole, r = inputs["gather"]["x"], inputs["gather"]["r"]
        x = M.shard_images_spatial(whole, mesh).requires_grad_(True)
        with spatial.width_group(mesh.group):
            g = spatial.gather_width(x, 2)
        mine = slice(rank, None, GATHER_D)       # the descriptor loss's item split
        (g[mine] * r[mine]).sum().backward()
        out.update({"gather/y": g.detach().numpy(), "gather/dx": x.grad.numpy()})
    return out


def _worker(port, rank, work):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from feature_point_cnn_tpu_torch.parallel import collectives, distributed
    from feature_point_cnn_tpu_torch.train import loss as L

    assert distributed.initialize(f"localhost:{port}", RANKS, rank, device="cpu")
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    # the loss's kernel entry point (on the CPU the plain version), recorded
    entry, calls = L.hinge_descriptor_loss_cuda, []

    def recording(d, wd, warped_centers, *rest):
        calls.append(warped_centers.detach().clone())
        return entry(d, wd, warped_centers, *rest)

    L.hinge_descriptor_loss_cuda = recording

    def save(name, **arrays):
        np.savez(work / f"{name}_{rank}.npz", **arrays)

    for name, (_, d, *_rest) in STEPS.items():
        mesh = M.make_spatial_mesh(d)       # collective: every rank makes it
        if not mesh.member:
            continue
        calls.clear()
        metrics, state = _run_step(inputs, name, mesh)
        save(name, **{f"m/{k}": v for k, v in metrics.items()}, **_state_arrays(state),
             **{f"call/{i}": c.numpy() for i, c in enumerate(calls)})
    for kind, (_, d, _, _) in EVALS.items():
        mesh = M.make_spatial_mesh(d)
        if mesh.member:
            save(f"eval_{kind}", **_run_eval(inputs, kind, mesh))
    save("parts", **_parts(inputs, rank))
    mesh = M.make_spatial_mesh(2)
    if mesh.member:
        cfg, state = _state(inputs["state_dict"], 64, "magicpoint", {})
        batch = inputs["batches"]["mp_jax"]
        try:
            with collectives.data_group(mesh.group), spatial.width_group(mesh.group):
                S.magicpoint_train_step(state, dict(batch, image=M.shard_images_spatial(
                    batch["image"], mesh)), torch.Generator().manual_seed(0), config=cfg)
            refused = ""
        except ValueError as e:
            refused = str(e)
        (work / f"refused_{rank}.txt").write_text(refused)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the job and its references

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Job:
    """The ranks, started at once; `result` waits for them."""

    def __init__(self, work):
        self.work = work
        port = _free_port()
        repo = str(Path(__file__).resolve().parents[1])
        env = {**os.environ, "PYTHONPATH": repo}
        env.pop("RANK", None)
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, str(port), str(r), str(work)], cwd=repo,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(RANKS)]
        self.done = False

    def wait(self):
        if self.done:
            return
        for r, p in enumerate(self.procs):
            try:
                out, _ = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                pytest.fail("a rank timed out")
            assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        self.done = True

    def result(self, name, rank):
        self.wait()
        return dict(np.load(self.work / f"{name}_{rank}.npz"))


def _inputs():
    """The JAX-initialised weights, every scenario's whole batch, JAX's
    encoded data for ``sp_encoded_jax`` and the parts' tensors."""
    import jax
    import jax.numpy as jnp

    from feature_point_cnn_tpu.config import HomographyConfig as JaxHomographyConfig
    from feature_point_cnn_tpu.train import steps as jsteps
    from tests.test_torch_train_step import _jax_init
    from feature_point_cnn_tpu_torch.utils.weights import state_dict_from_jax_variables

    jcfg, _, variables = _jax_init()
    batches = {name: _batch(s[4], s[0]) for name, s in STEPS.items()}
    encoded = jax.jit(jsteps._augment_and_encode, static_argnums=(2, 3))(
        {k: jnp.asarray(v.numpy()) for k, v in batches["sp_encoded_jax"].items()},
        jax.random.PRNGKey(STEPS["sp_encoded_jax"][5]), jcfg, JaxHomographyConfig())
    encoded = {k: torch.from_numpy(np.array(v)) for k, v in zip(
        ("warped", "labels", "wlabels", "cell_mask", "homog", "images"), encoded)}
    encoded["labels"], encoded["wlabels"] = encoded["labels"].long(), encoded["wlabels"].long()
    rng = np.random.default_rng(3)
    c, w = 5, sum(BN_WIDTHS)

    def f64(*shape):
        return torch.from_numpy(rng.standard_normal(shape))

    bn_state = {"weight": 1 + 0.2 * f64(c), "bias": 0.2 * f64(c),
                "running_mean": 0.2 * f64(c), "running_var": (1 + 0.2 * f64(c)).abs(),
                "num_batches_tracked": torch.tensor(0)}
    return {"state_dict": state_dict_from_jax_variables(
                jax.tree_util.tree_map(np.asarray, variables)),
            "batches": batches, "encoded": encoded,
            "evals": {k: _batch(s[2], s[0]) for k, s in EVALS.items()},
            "bn": {"x": 3 + 2 * f64(B, c, 4, w), "r": f64(B, c, 4, w), "state": bn_state},
            "gather": {"x": f64(3, 2, 16, 3), "r": f64(3, 2, 16, 3)}}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    work = tmp_path_factory.mktemp("spatial_train")
    inputs = _inputs()
    torch.save(inputs, work / "inputs.pt")
    j = Job(work)
    j.inputs = inputs
    yield j
    for p in j.procs:
        if p.poll() is None:
            p.kill()


@functools.lru_cache(maxsize=None)
def _one_process(job, name):
    return _run_step(job.inputs, name)


def _assert_state_close(state, got, rtol, atol):
    for k, v in state.model.state_dict().items():
        if v.is_floating_point():
            np.testing.assert_allclose(got[f"sd/{k}"], v.numpy(), rtol=rtol, atol=atol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[f"sd/{k}"], v.numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# the job's cases

@pytest.mark.parametrize("name", ["mp_jax", "sp_encoded_jax"])
def test_sharded_step_equals_jax_gspmd_step(job, name):
    """JAX's jitted step on its 2-device width mesh (GSPMD partitions it):
    losses, metrics and gradient norms rtol 2e-4, every parameter atol
    2e-6 + rtol 1e-4 with each tensor's update within 1e-2 of JAX's, the
    BatchNorm statistics atol 2e-5 + rtol 1e-4."""
    import jax

    from feature_point_cnn_tpu.parallel import mesh as JM
    from feature_point_cnn_tpu.train import steps as jsteps
    from tests.test_torch_train_step import _assert_step_matches, _jax_state, _to_jax

    w, d, step, _, _, gseed = STEPS[name]
    frozen = "descriptor" if step == "magicpoint" else None
    jcfg, jmodel, tx, jstate = _jax_state(frozen=frozen)
    m = JM.make_spatial_mesh(d)
    jstate = JM.replicate_state(jstate, m)
    batch = {k: jax.device_put(v, JM.replicated(m))
             for k, v in _to_jax({k: v.numpy() for k, v in job.inputs["batches"][name].items()
                                  }).items()}
    batch["image"] = JM.shard_images_spatial(batch["image"], m)
    fn = jsteps.magicpoint_train_step if step == "magicpoint" else jsteps.superpoint_train_step
    jstate, jmetrics = jax.jit(functools.partial(fn, model=jmodel, tx=tx, config=jcfg))(
        jstate, batch, jax.random.PRNGKey(gseed))
    got = job.result(name, 0)
    _, tstate = _state(job.inputs["state_dict"], w, step, {})
    tstate.model.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in got.items()
                                  if k.startswith("sd/")})
    tstate.step = 1
    heads = ("encoder", "detector") + (() if frozen else ("descriptor",))
    _assert_step_matches(tstate, {k[2:]: v for k, v in got.items() if k.startswith("m/")},
                         jstate, jmetrics, heads)


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_step_equals_the_one_process_step(job, name):
    """The same generator seed: metrics rtol 1e-6, parameters and BatchNorm
    statistics atol 1e-12 with the model in float64 (1e-6 for the JAX
    cases' float32), on rank 0."""
    want, state = _one_process(job, name)
    got = job.result(name, 0)
    assert {k[2:] for k in got if k.startswith("m/")} == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[f"m/{k}"], v, rtol=1e-6, atol=1e-9, err_msg=k)
    _assert_state_close(state, got, 0, 1e-6 if "jax" in name else 1e-12)


@pytest.mark.parametrize("name", list(STEPS))
def test_ranks_end_the_step_bit_identical(job, name):
    """Parameters, BatchNorm statistics, Adam's moments and the metrics."""
    d = STEPS[name][1]
    outs = [{k: v for k, v in job.result(name, r).items() if not k.startswith("call/")}
            for r in range(d)]
    for out in outs[1:]:
        assert out.keys() == outs[0].keys()
        for k, v in out.items():
            assert np.array_equal(v, outs[0][k]), k


@pytest.mark.parametrize("kind", list(EVALS))
def test_sharded_eval_step_equals_the_one_process_eval_step(job, kind):
    """float32, on every rank: metrics rtol 1e-6."""
    want = _run_eval(job.inputs, kind)
    d = EVALS[kind][1]
    for r in range(d):
        got = job.result(f"eval_{kind}", r)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("name", DESC_STEPS)
def test_each_rank_runs_the_plain_loss_on_its_items(job, name):
    """On the CPU the plain version, once a microbatch on each rank that has
    items: items ``r, r + d, ...`` of the microbatch, whose warped cell
    centers it is given; a rank with none calls nothing."""
    from feature_point_cnn_tpu_torch.geometry.homography import warp_points
    from feature_point_cnn_tpu_torch.train.loss import _cell_centers

    w, d, step, over, _, gseed = STEPS[name]
    k = over.get("microbatch_steps", 1)
    if step == "encoded":
        homog = job.inputs["encoded"]["homog"]
    else:
        cfg = SuperPointConfig(**KW)
        homog = S._augment_and_encode(job.inputs["batches"][name],
                                      torch.Generator().manual_seed(gseed), cfg,
                                      HomographyConfig())[4]
    centers = _cell_centers(H // 8, w // 8, 8, "cpu")
    for r in range(d):
        got = job.result(name, r)
        calls = [got[f"call/{i}"] for i in range(sum(c.startswith("call/") for c in got))]
        want = [warp_points(centers, homog[i::k][r::d]).numpy() for i in range(k)]
        want = [c for c in want if len(c)]
        assert len(calls) == len(want), (r, len(calls))
        for c, wc in zip(calls, want):
            np.testing.assert_array_equal(c, wc)


def test_group_batchnorm_over_a_width_group_with_an_empty_block(job):
    """float64, blocks 3, 0 and 4 columns wide: ``y`` (each rank's columns),
    the running statistics (Flax's: the biased variance), the input
    gradient and the width-summed weight and bias gradients of ``sum(r y)``
    against `F.batch_norm` on the whole tensor, within 1e-12 of each
    tensor's largest entry."""
    bn = job.inputs["bn"]
    x = bn["x"].clone().requires_grad_(True)
    weight = bn["state"]["weight"].clone().requires_grad_(True)
    bias = bn["state"]["bias"].clone().requires_grad_(True)
    y = F.batch_norm(x, None, None, weight, bias, True, 0.0, 1e-5)
    (y * bn["r"]).sum().backward()
    mean = bn["state"]["running_mean"] * 0.9 + 0.1 * bn["x"].mean(dim=(0, 2, 3))
    var = (bn["state"]["running_var"] * 0.9
           + 0.1 * bn["x"].var(dim=(0, 2, 3), unbiased=False))

    def close(got, want, what):
        want = want.detach().numpy()
        assert got.shape == want.shape, what
        if want.size:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max(),
                                       err_msg=what)

    a = 0
    for r, n in enumerate(BN_WIDTHS):
        got = job.result("parts", r)
        assert got["bn/y"].shape[-1] == n
        close(got["bn/y"], y[..., a:a + n], f"rank {r} y")
        close(got["bn/dx"], x.grad[..., a:a + n], f"rank {r} dx")
        for k, want in (("dw", weight.grad), ("db", bias.grad), ("mean", mean), ("var", var)):
            close(got[f"bn/{k}"], want, f"rank {r} {k}")
        a += n


def test_width_gather_forward_and_backward_are_exact(job):
    """The gathered tensor is the whole one, and each rank's gradient (its
    loss: its items of the gathered tensor) is its columns of the one-process
    gradient, bit for bit."""
    x, r = job.inputs["gather"]["x"], job.inputs["gather"]["r"]
    n = x.shape[2] // GATHER_D
    for rank in range(GATHER_D):
        got = job.result("parts", rank)
        assert np.array_equal(got["gather/y"], x.numpy())
        assert np.array_equal(got["gather/dx"], r[:, :, rank * n:(rank + 1) * n].numpy())


def test_a_data_group_inside_a_width_group_raises(job):
    job.wait()
    for r in range(2):
        assert "one axis" in (job.work / f"refused_{r}.txt").read_text()


def test_without_a_width_group_gather_and_blocks_are_the_identity():
    x = torch.arange(24.0).reshape(1, 2, 12)
    assert spatial.gather_width(x, 2) is x and spatial.own_block(x, 2) is x
    assert spatial.split() == (0, 1)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
