"""PyTorch port: a real two-rank `torch.distributed` job on the CPU (gloo
over loopback) against the port's one-process path and the JAX package.

One module-scoped job runs every scenario: two ranks of this file's
``__main__`` (no JAX in them), each writing an npz a scenario.  The ranks
hold the rows ``[r B/2, (r+1) B/2)`` of each global batch.  What the tests
hold, at 48x64:

* the MagicPoint step and the joint step with ``microbatch_steps`` 1 and 2
  against the port's one-process step on the global batch with the same
  generator (loss rtol 1e-5, every gradient entry atol 1e-5), with the
  model in float64: the ranks' BatchNorm statistics are not computed as
  `F.batch_norm` computes them, and at float32 one activation within 1e-6
  of a ReLU's kink flips its mask and moves gradient entries by ~1e-3
  (measured on these inputs: one flip in the detector's first block; the
  one-process float32 step equals a float64 one to 7e-7 of a tensor's
  largest entry, the ranks' to 7% near that flip).  The same steps at float32 on JAX's encoded views
  against JAX's step on the global batch with the same carried-over
  weights, at `tests/test_torch_train_step.py`'s tolerances; parameters
  and statistics bit-identical across the ranks;
* `extract_sharded` against `extract` of the whole batch (keypoints exact,
  descriptors 1e-6), each rank's rows bit-equal to `extract` of those rows
  alone, and against JAX's `extract_sharded` on a 2-device mesh (keypoint
  sets overlap >= 99%, descriptors where both keep a keypoint 1e-5);
* `preprocess_folder(use_mesh=True)` files equal to a single run's, array
  bytes for array bytes, also when one rank's block was written before the
  other rank lists the folder;
* landmark-sharded bundle adjustment against one rank (costs rtol 1e-5,
  poses and points 1e-4) and against JAX's on a 2-device mesh (rtol 1e-4,
  atol 2e-4, `tests/test_bundle.py`'s);
* a `Trainer` epoch on the item-sharded loader (rank 0 alone writes);
* the indivisible microbatch split and ``train_steps_per_call > 1`` under
  gloo raise.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

H, W, D = 48, 64, 32
KW = dict(train_image_size=(H, W), descriptor_dim=D, compute_dtype="float32",
          lr_schedule="constant", adam_eps=1.0, max_points=16)
RANKS = 2
STEPS = ("magicpoint", "joint_k1", "joint_k2", "magicpoint_jax", "joint_jax_k1",
         "joint_jax_k2")


# ---------------------------------------------------------------------------
# the ranks (no JAX here)

class _Items:
    """A packed split's arrays, as `DeviceBatchLoader` reads them."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, H, W, 1), dtype=np.uint8)
        self.points = np.stack([rng.random((16, 2)) * [H - 1, W - 1]
                                for _ in range(n)]).astype(np.float32)
        self.counts = rng.integers(4, 17, n).astype(np.int32)
        self.index = rng.permutation(n)


def _state(state_dict, frozen=None, double=False, **over):
    from feature_point_cnn_tpu_torch.config import SuperPointConfig
    from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
    from feature_point_cnn_tpu_torch.train import steps as S
    from feature_point_cnn_tpu_torch.train.optimizer import make_optimizer

    cfg = SuperPointConfig(**{**KW, **over})
    model = SuperPoint(cfg, float32_params=True)
    model.load_state_dict(state_dict)
    if double:      # the model in float64 (the losses stay float32)
        model.double()
        model.compute_dtype = torch.float64
    return cfg, S.create_train_state(model, make_optimizer(
        cfg, model.named_parameters(), frozen_subtree=frozen))


def _step_outputs(state, metrics):
    out = {f"metric/{k}": float(v) for k, v in metrics.items()}
    for name, p in state.model.named_parameters():
        if p.grad is not None:
            out[f"grad/{name}"] = p.grad.numpy()
    for name, v in state.model.state_dict().items():
        out[f"state/{name}"] = v.numpy()
    return out


def run_step(name, inputs, rows, full=False):
    """One scenario's step on ``rows`` of its global batch (``full``: the
    whole batch, the one-process reference)."""
    from feature_point_cnn_tpu_torch.train import steps as S

    sd = inputs["state_dict"]
    take = (lambda d: d) if full else (lambda d: {k: v[rows] for k, v in d.items()})
    double = "jax" not in name
    if name.startswith("magicpoint"):
        cfg, state = _state(sd, frozen="descriptor", double=double)
        state, m = S.magicpoint_train_step(state, take(inputs["mp_batch"]),
                                           torch.Generator().manual_seed(1), config=cfg)
    elif name.startswith("joint_jax"):
        cfg, state = _state(sd, microbatch_steps=int(name[-1]))
        state, m = S.superpoint_train_step_encoded(state, take(inputs["encoded"]),
                                                   config=cfg)
    else:
        cfg, state = _state(sd, microbatch_steps=int(name[-1]), double=True)
        state, m = S.superpoint_train_step(state, take(inputs["sp_batch"]),
                                           torch.Generator().manual_seed(5), config=cfg)
    return _step_outputs(state, m)


def _worker(port, rank, work):
    torch.set_num_threads(2)
    import torch.distributed as dist

    from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
    from feature_point_cnn_tpu_torch.data.device_store import DeviceBatchLoader
    from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
    from feature_point_cnn_tpu_torch.parallel import distributed
    from feature_point_cnn_tpu_torch.parallel.mesh import batch_sharding
    from feature_point_cnn_tpu_torch.selflabel.coco import preprocess_folder
    from feature_point_cnn_tpu_torch.slam import bundle
    from feature_point_cnn_tpu_torch.train import steps as S
    from feature_point_cnn_tpu_torch.train.trainer import Trainer
    from feature_point_cnn_tpu_torch.utils.weights import released_path

    assert distributed.initialize(f"localhost:{port}", RANKS, rank, device="cpu")
    mesh = distributed.global_mesh()
    assert (mesh.size, mesh.rank) == (RANKS, rank)
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    rows = batch_sharding(mesh, 4)

    def save(name, **arrays):
        np.savez(work / f"{name}_{rank}.npz", **arrays)

    for name in STEPS:
        save(name, **run_step(name, inputs, rows))

    # serving: extract_sharded, and extract of this rank's rows alone
    fe = SuperPointFrontend(SuperPointConfig(compute_dtype="float32", max_keypoints=64),
                            weights_path=released_path(), device="cpu")
    images = inputs["scenes"]
    kp, desc = fe.extract_sharded(images, mesh)
    lkp, ldesc = fe.extract(images[rows])
    wkp, wdesc = fe.extract(images)
    save("extract", **{f"sharded/{f}": getattr(kp, f).numpy() for f in kp._fields},
         **{f"local/{f}": getattr(lkp, f).numpy() for f in kp._fields},
         **{f"whole/{f}": getattr(wkp, f).numpy() for f in kp._fields},
         **{"sharded/desc": desc.numpy(), "local/desc": ldesc.numpy(),
            "whole/desc": wdesc.numpy()})

    # self-labeling over the mesh, and (rank 0) the single run
    lfe = SuperPointFrontend(SuperPointConfig(compute_dtype="float32",
                                              train_image_size=(H, W), max_keypoints=64),
                             weights_path=released_path(), device="cpu")
    homo = HomographyConfig(num=3, valid_border_margin=4)
    n = preprocess_folder(lfe, str(work / "bmp"), str(work / "mesh"), homo, batch_size=4)
    single = (preprocess_folder(lfe, str(work / "bmp"), str(work / "single"), homo,
                                batch_size=4, use_mesh=False) if rank == 0 else 0)
    # a resumed run in which rank 0's block was written before rank 1 lists
    # the folder: rank 1 still takes its own block, rank 0 writes nothing
    if rank == 0:
        (work / "resume").mkdir()
        for i in range(4):
            (work / "resume" / f"im{i}.npz").write_bytes(
                (work / "single" / f"im{i}.npz").read_bytes())
    dist.barrier()
    resumed = preprocess_folder(lfe, str(work / "bmp"), str(work / "resume"), homo,
                                batch_size=4)
    save("selflabel", written=n, single=single, resumed=resumed)

    problem, _, _ = bundle.synthetic_ba_problem(np.random.default_rng(0), n_poses=5,
                                                n_points=37, device="cpu")
    poses, points, costs = bundle.bundle_adjust(problem, mesh, iters=6)
    save("ba", poses=poses.numpy(), points=points.numpy(), costs=costs.numpy())

    # the trainer on the item-sharded loader: 9 items, 8 kept, 2 steps
    cfg, _ = _state(inputs["state_dict"], batch_size=4, epochs=1)
    loader = DeviceBatchLoader(_Items(9, 3), 4, 16, device="cpu",
                               items_placement="sharded")
    trainer = Trainer(cfg, "magicpoint", loader, None, str(work / "ck"), device="cpu",
                      log_every=1)
    trainer.train()
    save("trainer", steps=trainer.state.step,
         **{f"state/{k}": v.numpy() for k, v in trainer.state.model.state_dict().items()})

    # the launch layer: rank 0's values replicated, each rank's rows fed
    raised = {}
    mine = {"t": torch.full((3,), float(rank + 1))}
    distributed.replicate_global(mine, mesh)
    fed = distributed.make_global_batch({"x": np.full((2, 3), rank)}, mesh, device="cpu")
    raised["replicated"] = mine["t"].tolist() + fed["x"][:, 0].tolist()
    from feature_point_cnn_tpu_torch.parallel.collectives import all_sum
    x = torch.tensor([rank + 1.0], requires_grad=True)
    (all_sum(x) * (rank + 1)).sum().backward()     # d/dx_r sum_q (q+1) (x_0 + x_1)
    raised["all_sum"] = [float(all_sum(x.detach())), float(x.grad)]
    # a batch of 3 splits over one rank: rank 1 is left out, says so and
    # joins no collective of that mesh (rank 0 sums over its own subgroup)
    from feature_point_cnn_tpu_torch.parallel.collectives import all_sum_
    from feature_point_cnn_tpu_torch.parallel.mesh import make_mesh
    left = make_mesh(batch_size=3)
    raised["left_out"] = [left.size, left.rank] + (
        [float(all_sum_(torch.ones(1), left.group))] if left.member else [])
    cfg3, state = _state(inputs["state_dict"], microbatch_steps=2)
    try:   # 3 rows a rank: the global batch of 6 splits, each rank's rows do not
        S.magicpoint_train_step(state, {k: v[3 * rank:3 * rank + 3] for k, v in
                                        inputs["mp6_batch"].items()},
                                torch.Generator().manual_seed(1), config=cfg3)
    except ValueError as e:
        raised["microbatch"] = str(e)
    try:
        Trainer(cfg.replace(train_steps_per_call=2), "magicpoint", loader, None,
                str(work / "ck2"), device="cpu")
    except ValueError as e:
        raised["graph"] = str(e)
    (work / f"raised_{rank}.json").write_text(json.dumps(raised))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the job and its references

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Job:
    """The two ranks, started at once; `result` waits for them."""

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


def _weights():
    """Seeded port weights with every BatchNorm's scale, bias and statistics
    jittered off 1 / 0 (as `tests/test_torch_train_step.py` jitters JAX's)."""
    from feature_point_cnn_tpu_torch.config import SuperPointConfig
    from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint

    model = SuperPoint(SuperPointConfig(**KW), generator=torch.Generator().manual_seed(0),
                       float32_params=True)
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in model.state_dict().items():
        if v.dim() == 1:
            r = rng.standard_normal(v.shape).astype(np.float32) * 0.2
            v = torch.from_numpy(np.abs(1 + r) if k.endswith(("weight", "var")) else r)
        sd[k] = v
    return sd


def _jax_config(**over):
    from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig

    return JaxConfig(use_pallas_desc_loss="off", **KW, **over)


def _inputs():
    """The weights and the global batches; the joint steps' views,
    labels, mask and homographies encoded by JAX's `_augment_and_encode`."""
    import functools

    import jax
    from tests.test_torch_train_step import _batch, _to_jax, _to_torch

    from chip_smoke import polygon_scene
    from feature_point_cnn_tpu.config import HomographyConfig as JaxHomographyConfig
    from feature_point_cnn_tpu.train import steps as jsteps

    encode = jax.jit(functools.partial(jsteps._augment_and_encode, config=_jax_config(),
                                       homo_config=JaxHomographyConfig()))
    names = ("warped", "labels", "wlabels", "cell_mask", "homog", "images")
    encoded = _to_torch({n: np.asarray(v) for n, v in zip(
        names, encode(_to_jax(_batch(2, 4)), jax.random.PRNGKey(3)))})
    encoded["labels"], encoded["wlabels"] = encoded["labels"].long(), encoded["wlabels"].long()
    rng = np.random.default_rng(4)
    gray = np.stack([polygon_scene(rng, H, W, n_polygons=12) for _ in range(4)])
    return {"state_dict": _weights(),
            "mp_batch": _to_torch(_batch(6, 4, u8_gray=True)),
            "mp6_batch": _to_torch(_batch(6, 6, u8_gray=True)),
            "sp_batch": _to_torch(_batch(7, 4)),
            "encoded": encoded,
            "scenes": torch.from_numpy(np.repeat(gray[..., None], 3, axis=-1))}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    from chip_smoke import polygon_scene, write_bmp

    work = tmp_path_factory.mktemp("job")
    inputs = _inputs()
    torch.save(inputs, work / "inputs.pt")
    (work / "bmp").mkdir()
    rng = np.random.default_rng(11)
    for i in range(6):
        g = (polygon_scene(rng, H, W, n_polygons=10) * 255).astype(np.uint8)
        write_bmp(work / "bmp" / f"im{i}.bmp", np.repeat(g[..., None], 3, axis=-1))
    j = Job(work)
    j.inputs = inputs
    yield j
    for p in j.procs:
        if p.poll() is None:
            p.kill()


def _split(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def _assert_ranks_bit_identical(job, name):
    """The all-reduced gradients (where the scenario keeps them), then the
    parameters and statistics, bit for bit across the ranks; a difference
    is reported with its extent, so that a failure tells the gradient's sum
    from the update."""
    a, b = job.result(name, 0), job.result(name, 1)
    for part in ("grad/", "state/"):
        for k, v in _split(a, part).items():
            w = b[f"{part}{k}"]
            if not np.array_equal(v, w):
                off = v != w
                pytest.fail(f"{name}: {k} differs across ranks ({part[:-1]}: "
                            f"{int(off.sum())} of {v.size} entries, at most "
                            f"{float(np.abs(v - w).max()):.3g})")


def _jax_step(name, variables):
    """JAX's step on the global batch (jitted), with its initial state."""
    import functools

    import jax
    from tests.test_torch_train_step import _batch, _to_jax

    from feature_point_cnn_tpu.models.superpoint import SuperPoint as JaxSuperPoint
    from feature_point_cnn_tpu.train import steps as jsteps
    from feature_point_cnn_tpu.train.optimizer import make_optimizer as jax_make_optimizer

    mp = name == "magicpoint_jax"
    jcfg = _jax_config(microbatch_steps=1 if mp else int(name[-1]))
    model = JaxSuperPoint(config=jcfg)
    tx = jax_make_optimizer(jcfg, variables["params"],
                            frozen_subtree="descriptor" if mp else None)
    step = jsteps.magicpoint_train_step if mp else jsteps.superpoint_train_step
    fn = jax.jit(functools.partial(step, model=model, tx=tx, config=jcfg))
    batch = _batch(6, 4, u8_gray=True) if mp else _batch(2, 4)
    return fn(jsteps.create_train_state(variables, tx), _to_jax(batch),
              jax.random.PRNGKey(1 if mp else 3))


@pytest.mark.parametrize("name", ["magicpoint_jax", "joint_jax_k1", "joint_jax_k2"])
def test_two_ranks_compute_jax_step_on_the_global_batch(job, name):
    """The MagicPoint step on u8 gray scenes with at most one point a cell
    (so no label noise decides anything), and the joint steps on JAX's
    encoded views of the global batch, held as `tests/test_torch_train_step.py`
    holds the one-process port: metrics rtol 2e-4, parameters atol 2e-6 +
    rtol 1e-4, each tensor's update within 1e-2 of JAX's by norm (a tensor
    JAX leaves alone stays), statistics atol 2e-5 + rtol 1e-4."""
    import jax
    from tests.test_torch_train_step import _assert_tree_close

    from feature_point_cnn_tpu_torch.utils.weights import jax_variables_from_state_dict

    variables = jax.tree_util.tree_map(
        jax.numpy.asarray, jax_variables_from_state_dict(job.inputs["state_dict"]))
    jstate, jmetrics = _jax_step(name, variables)
    got = job.result(name, 0)
    tmetrics = _split(got, "metric/")
    if name.endswith("k2"):    # JAX pairs microbatch-ordered logits with unsplit labels
        jmetrics = {k: v for k, v in jmetrics.items() if k != "f1"}
        tmetrics.pop("f1")
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(tmetrics[k], float(jmetrics[k]), rtol=2e-4, atol=1e-6,
                                   err_msg=k)
    heads = ("encoder", "detector") if name == "magicpoint_jax" else (
        "encoder", "detector", "descriptor")
    assert all(tmetrics[f"grad_norm/{h}"] > 0 for h in heads)
    sd = {k: torch.from_numpy(v) for k, v in _split(got, "state/").items()}
    _assert_tree_close(sd, jstate.params, "params", 1e-4, 2e-6, "param")
    _assert_tree_close(sd, jstate.batch_stats, "batch_stats", 1e-4, 2e-5, "stat")
    start = dict(jax.tree_util.tree_flatten_with_path(variables["params"])[0])
    want = dict(jax.tree_util.tree_flatten_with_path(jstate.params)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(
            jax_variables_from_state_dict(sd)["params"])[0]:
        s0 = np.asarray(start[path])
        delta = np.asarray(want[path]) - s0
        miss = np.linalg.norm((g - s0) - delta)
        assert miss <= 1e-2 * np.linalg.norm(delta) + np.linalg.norm(
            np.spacing(np.abs(s0))), jax.tree_util.keystr(path)
    _assert_ranks_bit_identical(job, name)


@pytest.mark.parametrize("name", ["magicpoint", "joint_k1", "joint_k2"])
def test_two_ranks_compute_the_one_process_step(job, name):
    """float64 model: the data-parallel algebra (global draws, group
    BatchNorm, global divisors, the summed gradient) against the plain
    one-process step, with no ReLU at its kink to decide the result."""
    want = run_step(name, job.inputs, slice(None), full=True)
    got = job.result(name, 0)
    np.testing.assert_allclose(got["metric/loss"], want["metric/loss"], rtol=1e-5)
    wg, gg = _split(want, "grad/"), _split(got, "grad/")
    assert wg.keys() == gg.keys() and len(gg) > 10
    for k in wg:
        np.testing.assert_allclose(gg[k], wg[k], atol=1e-5, err_msg=k)
    for k, v in _split(want, "metric/").items():
        np.testing.assert_allclose(got[f"metric/{k}"], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    _assert_ranks_bit_identical(job, name)


def _kp_set(kp, b):
    return {(int(y), int(x)) for y, x, v in zip(kp["y"][b], kp["x"][b], kp["valid"][b])
            if v}


def test_extract_sharded_matches_extract_and_jax(job):
    from tests.test_torch_model import released_jax_variables

    from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
    from feature_point_cnn_tpu.inference.wrapper import SuperPointFrontend as JaxFrontend
    from feature_point_cnn_tpu.parallel.mesh import make_mesh as jax_make_mesh

    outs = [job.result("extract", r) for r in range(RANKS)]
    for r, out in enumerate(outs):
        sharded, local, whole = (_split(out, p) for p in ("sharded/", "local/", "whole/"))
        rows = slice(2 * r, 2 * r + 2)
        for f in ("y", "x", "score", "valid", "desc"):
            assert np.array_equal(sharded[f][rows], local[f]), f"rank {r} {f}"
            assert np.array_equal(sharded[f], outs[0][f"sharded/{f}"]), f
        for f in ("y", "x", "valid"):
            np.testing.assert_array_equal(sharded[f], whole[f], err_msg=f)
        np.testing.assert_allclose(sharded["desc"], whole["desc"], atol=1e-6)
    assert outs[0]["sharded/valid"].sum() >= 20

    jfe = JaxFrontend(JaxConfig(compute_dtype="float32", max_keypoints=64),
                      variables=released_jax_variables())
    jkp, jdesc = jfe.extract_sharded(job.inputs["scenes"].numpy(), jax_make_mesh(2))
    want = {f: np.asarray(getattr(jkp, f)) for f in ("y", "x", "valid")}
    got = _split(outs[0], "sharded/")
    total = both = 0
    for b in range(4):
        js, ts = _kp_set(want, b), _kp_set(got, b)
        total += len(js)
        both += len(js & ts)
    assert total >= 20 and both / total >= 0.99
    agree = (want["valid"] & got["valid"] & (want["y"] == got["y"])
             & (want["x"] == got["x"]))
    np.testing.assert_allclose(got["desc"][agree], np.asarray(jdesc)[agree], atol=1e-5)


def _assert_same_items(want_dir, got_dir, names):
    """The npz items hold the same arrays, byte for byte."""
    for name in names:
        a, b = np.load(want_dir / name), np.load(got_dir / name)
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (name, k)
            assert a[k].tobytes() == b[k].tobytes(), (name, k)


def test_use_mesh_labels_equal_the_single_run(job):
    written = [int(job.result("selflabel", r)["written"]) for r in range(RANKS)]
    assert written == [4, 2]           # blocks of 4: items 0-3 to rank 0, 4-5 to rank 1
    assert int(job.result("selflabel", 0)["single"]) == 6
    mesh, single = job.work / "mesh", job.work / "single"
    names = sorted(p.name for p in single.glob("*.npz"))
    assert names == sorted(p.name for p in mesh.glob("*.npz")) == [
        f"im{i}.npz" for i in range(6)]
    _assert_same_items(single, mesh, names)
    assert sum(np.load(mesh / n)["points"].shape[1] for n in names) > 0


def test_use_mesh_resume_keeps_each_ranks_blocks(job):
    """Rank 0's block (items 0-3) is in the folder before rank 1 lists it:
    the blocks come from the whole list, so rank 1 labels items 4-5 and
    rank 0 nothing, and every file equals the single run's."""
    assert [int(job.result("selflabel", r)["resumed"]) for r in range(RANKS)] == [0, 2]
    single, resume = job.work / "single", job.work / "resume"
    names = sorted(p.name for p in resume.glob("*.npz"))
    assert names == [f"im{i}.npz" for i in range(6)]
    _assert_same_items(single, resume, names)


def test_sharded_ba_matches_one_rank_and_jax(job):
    import jax.numpy as jnp

    from feature_point_cnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from feature_point_cnn_tpu.slam import bundle as jax_bundle
    from feature_point_cnn_tpu_torch.slam import bundle

    got = [job.result("ba", r) for r in range(RANKS)]
    for k in ("poses", "points", "costs"):
        assert np.array_equal(got[0][k], got[1][k]), k
    problem, _, _ = bundle.synthetic_ba_problem(np.random.default_rng(0), n_poses=5,
                                                n_points=37, device="cpu")
    poses, points, costs = bundle.bundle_adjust(problem, iters=6)
    assert got[0]["points"].shape == (37, 2)
    np.testing.assert_allclose(got[0]["costs"], costs.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got[0]["poses"], poses.numpy(), atol=1e-4)
    np.testing.assert_allclose(got[0]["points"], points.numpy(), atol=1e-4)

    jproblem, _, _ = jax_bundle.synthetic_ba_problem(np.random.default_rng(0), n_poses=5,
                                                     n_points=37)
    jp, jx, jc = jax_bundle.bundle_adjust(jproblem, mesh=jax_make_mesh(2), iters=6)
    np.testing.assert_allclose(got[0]["costs"], np.asarray(jc), rtol=1e-4)
    np.testing.assert_allclose(got[0]["poses"], np.asarray(jp), atol=2e-4)
    np.testing.assert_allclose(got[0]["points"], np.asarray(jx), atol=2e-4)
    assert float(jnp.max(jc)) > 0


def test_trainer_on_the_item_sharded_loader(job):
    """Two steps (8 of 9 items at batch 4): the same parameters on both
    ranks, one checkpoint and one line a logged scalar, written by rank 0."""
    outs = [job.result("trainer", r) for r in range(RANKS)]
    assert [int(o["steps"]) for o in outs] == [2, 2]
    _assert_ranks_bit_identical(job, "trainer")
    assert [p.name for p in (job.work / "ck").glob("ckpt_*.pt")] == ["ckpt_0.pt"]
    lines = (job.work / "ck" / "runs" / "metrics.jsonl").read_text().splitlines()
    assert sum("train/loss" in ln for ln in lines) == 2


def test_indivisible_microbatch_and_graphed_steps_under_gloo_raise(job):
    """Also the launch layer's `replicate_global` (rank 0's values on every
    rank) and `make_global_batch` (each rank keeps the rows it fed), the
    differentiable `all_sum` (its backward sums every rank's gradient), and
    a mesh that leaves rank 1 out without hanging either rank."""
    job.wait()
    for r in range(RANKS):
        raised = json.loads((job.work / f"raised_{r}.json").read_text())
        assert raised["replicated"] == [1.0, 1.0, 1.0, r, r]
        assert raised["all_sum"] == [3.0, 3.0]
        assert raised["left_out"] == ([1, 0, 1.0] if r == 0 else [1, -1])
        assert "microbatch" in raised.get("microbatch", ""), raised
        assert "gloo" in raised.get("graph", "") and "NCCL" in raised["graph"], raised


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
