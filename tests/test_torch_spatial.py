"""PyTorch port: one image W-sharded over a width mesh of d ranks
(`parallel/spatial.py`), on the CPU over gloo, against the port's
one-process forward and JAX's W-sharded forward and extract.

One module-scoped job of 4 ranks of this file's ``__main__`` (no JAX in
them) runs every scenario on width meshes of 2, 3 and 4 ranks (the job's
group or a subgroup of its first ranks), each writing an npz a scenario.
Eval-mode float32; the ResNet at ``descriptor_dim=32`` with weights made by
JAX's `init_superpoint`, every BatchNorm jittered off 1 / 0, carried over
by `state_dict_from_jax_variables`; the VGG family with JAX's
`init_vgg_superpoint` weights.  Each case is chosen for its geometry:

* 48x48, d = 2: 3 cells a rank at 1/8, an odd block, so the 1/16 blocks
  are uneven (2 and 1 columns);
* 48x72, d = 3: Wc = 9 is odd, so the transposed convolution overshoots the
  embedding grid by a column on the last rank, which alone crops it;
* 48x64, d = 4: 16 px a shard, one 1/16 column a rank, the per-shard
  geometry of JAX's own test (`tests/test_parallel.py:171`);
* 48x48, d = 2 with ``fold_bn``;
* 8 px a shard, one 1/8 column a rank: 48x16, d = 2 (rank 1's 1/16 block
  is empty); 48x24, d = 3 (the 1/16 columns lie on ranks 0 and 2, and
  rank 1's transposed convolution reads both); 48x32, d = 4 (rank 2's
  stride-1 convolution at 1/16 reads rank 0's column, two ranks away);
* VGG at 48x64, d = 2 and 48x32, d = 4.

What the tests hold: the gathered outputs against the one-process forward
at atol 1e-5, and against JAX's W-sharded forward at the frontend tests'
float32 tolerance (atol 1e-5 + rtol 1e-4); each rank's block against the
matching slice of the one-process output; the ranks' gathered outputs bit
for bit; the exchanged buffers halo-sized; at d = 2 (48x48 and 48x16) in
float64 the input gradient and the width-summed weight gradients of ``sum(r
* outputs)`` against the one-process gradients within 1e-9 of each
tensor's largest entry; `SuperPointFrontend.extract_spatial` with the
released weights at 48x64 and 48x16 over d = 2, subpixel refinement off
and on, against JAX's ``extract_fn`` on the W-sharded image; a width group
of one rank bit-equal to the plain forward and `extract`; the refusals.
Without a process group: the ownership rule and the exchange's plan over
d = 2..8 (every output column has one owner, every window arrives whole),
the mesh functions and the modules' plain route.
"""

import functools
import json
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
from feature_point_cnn_tpu_torch.models.blocks import Conv2d, ConvTranspose2d
from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
from feature_point_cnn_tpu_torch.models.vgg_superpoint import VGG_CONFIG, VGGSuperPoint
from feature_point_cnn_tpu_torch.parallel import mesh as M
from feature_point_cnn_tpu_torch.parallel import spatial
from feature_point_cnn_tpu_torch.utils.weights import released_path

RANKS = 4
B, D = 2, 32
CASES = {            # name: (H, W, d, model: "live", "fold" (fold_bn) or "vgg")
    "w48_d2": (48, 48, 2, "live"),
    "w72_d3": (48, 72, 3, "live"),
    "w64_d4": (48, 64, 4, "live"),
    "w48_d2_fold": (48, 48, 2, "fold"),
    "w16_d2": (48, 16, 2, "live"),
    "w24_d3": (48, 24, 3, "live"),
    "w32_d4": (48, 32, 4, "live"),
    "vgg_w64_d2": (48, 64, 2, "vgg"),
    "vgg_w32_d4": (48, 32, 4, "vgg"),
}
GRAD_CASES = ("w48_d2", "w16_d2")
# extract_spatial over d = 2 with the released weights: (H, W); threshold 0
# keeps every NMS survivor, as many as K
EXTRACT = {"x64": (48, 64), "x16": (48, 16)}
EXTRACT_K = 64
OUTPUTS = ("prob", "desc", "logits")
KP_FIELDS = ("y", "x", "score", "valid")


# ---------------------------------------------------------------------------
# the ranks (no JAX here)

def _model(state_dict, kind, double=False):
    if kind == "vgg":
        model = VGGSuperPoint(VGG_CONFIG.replace(compute_dtype="float32"))
    else:
        model = SuperPoint(SuperPointConfig(descriptor_dim=D, compute_dtype="float32",
                                            fold_bn=kind == "fold"))
    model.load_state_dict(state_dict)
    if double:
        model.double()
        model.compute_dtype = torch.float64
    return model.eval()


def _blocks(global_tensors, mesh):
    """This rank's equal blocks along W (dim 2) of one-process-shaped
    tensors."""
    out = []
    for t in global_tensors:
        n = t.shape[2] // mesh.size
        out.append(t[:, :, mesh.rank * n:(mesh.rank + 1) * n])
    return out


def _gradients(inputs, mesh, name):
    """float64 input gradient (this rank's block) and the weight gradients
    summed over the width group, of ``sum(r * outputs)``."""
    from feature_point_cnn_tpu_torch.parallel.collectives import all_sum_

    model = _model(inputs["live"], "live", double=True)
    x = M.shard_images_spatial(inputs["images"][name].double(), mesh)
    x.requires_grad_(True)
    with spatial.width_group(mesh.group):
        outs = model(x)
        loss = sum((o * r).sum() for o, r in zip(outs, _blocks(inputs["grad_r"][name], mesh)))
        loss.backward()
    return {"input": x.grad.numpy(),
            **{f"w/{n}": all_sum_(p.grad, mesh.group).numpy()
               for n, p in model.named_parameters()}}


def _refusals(inputs, mesh):
    """What a width group refuses, each message (every rank of it raises)."""
    from feature_point_cnn_tpu_torch.parallel import collectives

    out = {}
    model = _model(inputs["live"], "live")
    images = inputs["images"]["w48_d2"]
    for name, fn in (
        ("indivisible", lambda: M.shard_images_spatial(images[:, :, :40], mesh)),
        ("data_and_width", lambda: model.train()(M.shard_images_spatial(images, mesh))),
    ):
        try:
            with torch.no_grad(), spatial.width_group(None if name == "indivisible"
                                                      else mesh.group), \
                    collectives.data_group(None if name == "indivisible" else mesh.group):
                fn()
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    return out


def _frontend(refine):
    return SuperPointFrontend(
        SuperPointConfig(compute_dtype="float32", max_keypoints=EXTRACT_K,
                         confidence_thresh=0.0, subpixel_refine=refine),
        weights_path=released_path(), device="cpu")


def _keypoint_arrays(prefix, kp, desc):
    return {**{f"{prefix}/{f}": getattr(kp, f).numpy() for f in KP_FIELDS},
            f"{prefix}/desc": desc.numpy()}


def _worker(port, rank, work):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from feature_point_cnn_tpu_torch.parallel import distributed

    assert distributed.initialize(f"localhost:{port}", RANKS, rank, device="cpu")
    inputs = torch.load(work / "inputs.pt", weights_only=False)

    def save(name, **arrays):
        np.savez(work / f"{name}_{rank}.npz", **arrays)

    for name, (h, w, d, kind) in CASES.items():
        mesh = M.make_spatial_mesh(d)       # collective: every rank makes it
        if not mesh.member:
            continue
        model = _model(inputs[kind], kind)
        local = M.shard_images_spatial(inputs["images"][name], mesh)
        spatial.reset_counts()
        with torch.no_grad(), spatial.width_group(mesh.group):
            outs = model(local)
        counts = dict(spatial.counts)
        gathered = [spatial.gather_width(t, 2, mesh.group) for t in outs]
        save(name, **{f"local/{k}": t.numpy() for k, t in zip(OUTPUTS, outs)},
             **{f"gathered/{k}": t.numpy() for k, t in zip(OUTPUTS, gathered)},
             **{f"count/{k}": v for k, v in counts.items()})

    mesh = M.make_spatial_mesh(2)
    if mesh.member:
        for name in GRAD_CASES:
            save(f"grad_{name}", **_gradients(inputs, mesh, name))
        (work / f"refusals_{rank}.json").write_text(json.dumps(_refusals(inputs, mesh)))
        for refine in (False, True):
            fe = _frontend(refine)
            for name in EXTRACT:
                kp, desc = fe.extract_spatial(inputs["extract"][name], mesh)
                save(f"extract_{name}_{int(refine)}", **_keypoint_arrays("got", kp, desc))

    one = M.make_spatial_mesh(1)            # a subgroup of rank 0 alone
    if one.member:
        model = _model(inputs["live"], "live")
        images = inputs["images"]["w48_d2"]
        spatial.reset_counts()
        with torch.no_grad():
            plain = model(images)
            with spatial.width_group(one.group):
                got = model(M.shard_images_spatial(images, one))
        fe = _frontend(True)
        scene = inputs["extract"]["x64"]
        save("one", **{f"plain/{k}": t.numpy() for k, t in zip(OUTPUTS, plain)},
             **{f"got/{k}": t.numpy() for k, t in zip(OUTPUTS, got)},
             **_keypoint_arrays("extract", *fe.extract(scene)),
             **_keypoint_arrays("extract_spatial", *fe.extract_spatial(scene, one)),
             exchanges=spatial.counts["exchanges"])
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


def _jax_variables():
    """JAX's initial variables with every BatchNorm's scale, bias and
    statistics jittered off 1 / 0, as numpy."""
    import jax

    from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
    from feature_point_cnn_tpu.models.superpoint import init_superpoint

    _, variables = init_superpoint(jax.random.PRNGKey(0),
                                   JaxConfig(descriptor_dim=D, compute_dtype="float32"),
                                   (48, 48))
    rng = np.random.default_rng(0)

    def jitter(path, v):
        v = np.asarray(v, np.float32)
        leaf = getattr(path[-1], "key", "")
        if leaf in ("scale", "var"):
            return np.abs(1 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
        if leaf in ("mean",) or (leaf == "bias" and v.ndim == 1):
            return (0.2 * rng.standard_normal(v.shape)).astype(np.float32)
        return v

    return jax.tree_util.tree_map_with_path(jitter, variables)


def _jax_vgg_variables():
    import jax

    from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
    from feature_point_cnn_tpu.models.vgg_superpoint import init_vgg_superpoint

    _, variables = init_vgg_superpoint(
        jax.random.PRNGKey(0),
        JaxConfig(image_channels=1, descriptor_dim=256, compute_dtype="float32"), (48, 64))
    return jax.tree_util.tree_map(np.asarray, variables)


def _inputs(variables, vgg_variables):
    from chip_smoke import polygon_scene
    from feature_point_cnn_tpu.models.fold import fold_batchnorm as jax_fold_batchnorm
    from feature_point_cnn_tpu_torch.utils.weights import (
        state_dict_from_jax_variables,
        vgg_state_dict_from_jax_variables,
    )

    rng = np.random.default_rng(1)
    images = {name: torch.from_numpy(rng.random(
        (B, h, w, 1 if kind == "vgg" else 3)).astype(np.float32))
        for name, (h, w, _, kind) in CASES.items()}
    grad_r = {}
    for name in GRAD_CASES:
        h, w = CASES[name][:2]
        grad_r[name] = [torch.from_numpy(rng.standard_normal(s)) for s in
                        ((B, h, w), (B, h // 8, w // 8, D), (B, h // 8, w // 8, 65))]
    extract = {}
    for name, (h, w) in EXTRACT.items():
        gray = np.stack([polygon_scene(rng, h, w, n_polygons=12) for _ in range(B)])
        extract[name] = np.repeat(gray[..., None], 3, axis=-1).astype(np.float32)
    return {"live": state_dict_from_jax_variables(variables),
            "fold": state_dict_from_jax_variables(jax_fold_batchnorm(variables)),
            "vgg": vgg_state_dict_from_jax_variables(vgg_variables),
            "images": images, "grad_r": grad_r, "extract": extract}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    work = tmp_path_factory.mktemp("spatial")
    variables, vgg_variables = _jax_variables(), _jax_vgg_variables()
    inputs = _inputs(variables, vgg_variables)
    torch.save(inputs, work / "inputs.pt")
    j = Job(work)
    j.inputs, j.variables, j.vgg_variables = inputs, variables, vgg_variables
    yield j
    for p in j.procs:
        if p.poll() is None:
            p.kill()


def _one_process(job, name):
    kind = CASES[name][3]
    with torch.no_grad():
        outs = _model(job.inputs[kind], kind)(job.inputs["images"][name])
    return dict(zip(OUTPUTS, (t.numpy() for t in outs)))


def _split(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def _jax_mesh_inputs(images, d, variables):
    """``images`` W-sharded on JAX's d-device width mesh and ``variables``
    replicated on it."""
    import jax

    from feature_point_cnn_tpu.parallel import mesh as JM

    m = JM.make_spatial_mesh(d)
    v = jax.tree_util.tree_map(lambda a: jax.device_put(a, JM.replicated(m)), variables)
    return v, JM.shard_images_spatial(images, m)


# ---------------------------------------------------------------------------
# the job's cases

@pytest.mark.parametrize("name", list(CASES))
def test_sharded_forward_equals_the_one_process_forward(job, name):
    """Gathered outputs at atol 1e-5; each rank's block equals the matching
    slice of the one-process output (blocks of equal width W/d)."""
    h, w, d, _ = CASES[name]
    want = _one_process(job, name)
    for r in range(d):
        out = job.result(name, r)
        got, local = _split(out, "gathered/"), _split(out, "local/")
        for k in OUTPUTS:
            assert got[k].shape == want[k].shape, (k, got[k].shape)
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)
            n = want[k].shape[2] // d
            assert local[k].shape[2] == n, (k, local[k].shape)
            np.testing.assert_allclose(local[k], want[k][:, :, r * n:(r + 1) * n],
                                       atol=1e-5, rtol=0, err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_forward_equals_jax_sharded_forward(job, name):
    """JAX's own W-sharded forward (GSPMD's halos) on a d-device width mesh,
    as `tests/test_parallel.py:171` runs it; the ResNet's outputs come back
    sharded along W."""
    import jax

    from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
    from feature_point_cnn_tpu.models.fold import fold_batchnorm as jax_fold_batchnorm
    from feature_point_cnn_tpu.models.superpoint import SuperPoint as JaxSuperPoint
    from feature_point_cnn_tpu.models.vgg_superpoint import VGGSuperPoint as JaxVGG

    h, w, d, kind = CASES[name]
    if kind == "vgg":
        variables = job.vgg_variables
        model = JaxVGG(config=JaxConfig(image_channels=1, descriptor_dim=256,
                                        compute_dtype="float32"))
    else:
        fold = kind == "fold"
        variables = jax_fold_batchnorm(job.variables) if fold else job.variables
        model = JaxSuperPoint(config=JaxConfig(descriptor_dim=D, compute_dtype="float32",
                                               fold_bn=fold))
    v, x = _jax_mesh_inputs(job.inputs["images"][name].numpy(), d, variables)
    want = jax.jit(lambda v_, x_: model.apply(v_, x_, train=False))(v, x)
    if kind != "vgg":
        assert all(t.sharding.spec[2] == "width" for t in want), [t.sharding for t in want]
    got = _split(job.result(name, 0), "gathered/")
    for k, t in zip(OUTPUTS, want):
        np.testing.assert_allclose(got[k], np.asarray(t), atol=1e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_gather_bit_identical_outputs_through_halo_sized_buffers(job, name):
    """Every rank gathers the same bits.  One exchange a 3x3 or 7x7
    convolution, pool of stride 2 over odd windows and transposed
    convolution (13 a ResNet forward: the 1x1 convolutions, strided or not,
    exchange nothing; 10 a VGG forward: its 2x2 pools neither), whatever
    the blocks, empty ones included.  The largest buffer is the max pool's
    ``(d, 2, B, 64, H/2, 1)`` strips (VGG: the second convolution's ``(d,
    2, B, 64, H, 1)``): 2 d halo columns, less than half of that op's
    full-width input, and exactly half for the ResNet at 8 px a shard."""
    h, w, d, kind = CASES[name]
    outs = [job.result(name, r) for r in range(d)]
    for out in outs[1:]:
        for k in OUTPUTS:
            assert np.array_equal(out[f"gathered/{k}"], outs[0][f"gathered/{k}"]), k
    exchanges, rows, cols = (10, h, w) if kind == "vgg" else (13, h // 2, w // 2)
    for out in outs:
        assert int(out["count/exchanges"]) == exchanges
        strips = d * 2 * B * 64 * rows * 4
        half = B * 64 * rows * cols * 4 / 2
        assert int(out["count/largest_bytes"]) == strips
        assert strips < half or (kind != "vgg" and w == 8 * d and strips == half)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_float64_gradients_equal_the_one_process_gradients(job, name):
    """d = 2, 48x48 and 48x16 (rank 1's 1/16 block empty): the input
    gradient (gathered from the blocks) and the weight gradients summed
    over the width group, of ``sum(r * outputs)``, within 1e-9 of each
    tensor's largest entry."""
    model = _model(job.inputs["live"], "live", double=True)
    x = job.inputs["images"][name].double().requires_grad_(True)
    outs = model(x)
    sum((o * r).sum() for o, r in zip(outs, job.inputs["grad_r"][name])).backward()
    got = [job.result(f"grad_{name}", r) for r in range(2)]
    gx = np.concatenate([g["input"] for g in got], axis=2)
    want = x.grad.numpy()
    np.testing.assert_allclose(gx, want, atol=1e-9 * np.abs(want).max(), rtol=0)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) > 50 and set(_split(got[0], "w/")) == set(names)
    for n, p in model.named_parameters():
        want = p.grad.numpy()
        assert np.abs(want).max() > 0, n
        for g in got:
            np.testing.assert_allclose(g[f"w/{n}"], want, atol=1e-9 * np.abs(want).max(),
                                       rtol=0, err_msg=n)


@functools.lru_cache(maxsize=None)
def _jax_extract(job, name):
    """JAX's ``extract_fn`` on the image W-sharded over 2 devices, refinement
    off and on (one program)."""
    import jax

    from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
    from feature_point_cnn_tpu.inference.wrapper import extract_fn
    from feature_point_cnn_tpu.models.superpoint import SuperPoint as JaxSuperPoint
    from tests.test_torch_model import released_jax_variables

    cfg = JaxConfig(compute_dtype="float32", max_keypoints=EXTRACT_K, confidence_thresh=0.0)
    model = JaxSuperPoint(config=cfg)
    v, x = _jax_mesh_inputs(job.inputs["extract"][name], 2, released_jax_variables())
    outs = jax.jit(lambda v_, x_: [extract_fn(v_, x_, model=model, config=cfg.replace(
        subpixel_refine=refine)) for refine in (False, True)])(v, x)
    return [({f: np.asarray(getattr(kp, f)) for f in KP_FIELDS}, np.asarray(desc))
            for kp, desc in outs]


@pytest.mark.parametrize("refine", [False, True], ids=["plain", "subpixel"])
@pytest.mark.parametrize("name", list(EXTRACT))
def test_extract_spatial_equals_jax_extract_of_the_sharded_image(job, name, refine):
    """`SuperPointFrontend.extract_spatial` over d = 2 (48x64, and 48x16 at
    8 px a shard) against JAX's ``extract_fn`` on the W-sharded image,
    released weights, threshold 0: ``valid`` exactly, the keypoint
    positions exactly (refined: within 1e-4 px, the parabola through
    float32 logs of probabilities that agree to rtol 1e-4), scores at the
    frontend tests' float32 tolerance, descriptors within 1e-5; every rank
    holds the same outputs bit for bit."""
    want, want_desc = _jax_extract(job, name)[refine]
    outs = [_split(job.result(f"extract_{name}_{int(refine)}", r), "got/") for r in range(2)]
    for out in outs[1:]:
        for k in (*KP_FIELDS, "desc"):
            assert np.array_equal(out[k], outs[0][k]), k
    got = outs[0]
    assert got["desc"].shape == (B, EXTRACT_K, 128)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].sum() >= 10
    for k in ("y", "x"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4 if refine else 0, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(got["score"], want["score"], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got["desc"], want_desc, atol=1e-5, rtol=0)


def test_a_width_group_of_one_rank_is_the_plain_forward(job):
    """The forward, and `extract_spatial` (refinement on) against
    `extract`, bit for bit."""
    out = job.result("one", 0)
    assert int(out["exchanges"]) == 0
    for k in OUTPUTS:
        assert np.array_equal(out[f"got/{k}"], out[f"plain/{k}"]), k
    for k in (*KP_FIELDS, "desc"):
        assert np.array_equal(out[f"extract_spatial/{k}"], out[f"extract/{k}"]), k


@pytest.mark.parametrize("what,match", [
    ("indivisible", "mesh size x the total stride"),
    ("data_and_width", "meshes have one axis"),
])
def test_a_width_group_refuses_what_it_cannot_split(job, what, match):
    """A width that is not a multiple of d x 8 (GSPMD would quietly
    replicate it) and a train-mode forward inside a data group as well as
    a width group (the JAX package's meshes have one axis): each a
    ValueError on every rank."""
    job.wait()
    for r in range(2):
        raised = json.loads((job.work / f"refusals_{r}.json").read_text())
        assert match in raised[what], raised[what]


# ---------------------------------------------------------------------------
# no process group: the geometry, the mesh functions and the plain route

def _exchanged_windows(x, bounds, windows, h, pad):
    """Every rank's window of ``x`` (global, ``(1, C, 1, W)``) as its
    exchange assembles it: each rank's strips written as `_Exchange`
    writes them, the all-reduce's sum taken by one shared buffer, then
    `halo_plan` and `assemble` on each rank."""
    d = len(bounds)
    strips = x.new_zeros((d, 2, *x.shape[:-1], h))
    blocks = [x[..., a:b] for a, b in bounds]
    held = [spatial.put_strips(strips[r], blk) for r, blk in enumerate(blocks)]
    out = []
    for r, (blk, win) in enumerate(zip(blocks, windows)):
        left, right = spatial.halo_need(win, blk.shape[-1])
        plan = spatial.halo_plan(r, left, right, held, h)
        wide = spatial.assemble(blk, strips, plan, left, right, pad)
        out.append(wide[..., win[0] + left:win[1] + left])
    return out


def _padded(x, a, b, pad):
    """Global columns ``[a, b)`` of ``x``, ``pad`` outside ``[0, W)``."""
    w = x.shape[-1]
    left, right = max(0, -a), max(0, b - w)
    return F.pad(x[..., max(a, 0):min(b, w)], (left, right), value=pad)


def _check_op(x, bounds, k, s, p, pool=False):
    """One op of kernel extent ``k``, stride ``s``, padding ``p`` over the
    blocks ``bounds`` of ``x`` (a stride-1 op over any blocks, a strided one
    over equal ones): its output columns have one owner each, every rank's
    exchanged window equals the padded global columns it covers, and the op
    on the windows gives the global op's columns (float64, within 1e-12).
    Returns the output and its blocks."""
    d, width = len(bounds), x.shape[-1]
    pad = -math.inf if pool else 0.0
    wts = torch.randn(1, 1, 1, k, dtype=torch.float64)
    op = (lambda t, q: F.max_pool2d(t, (1, k), (1, s), (0, q))) if pool else \
        (lambda t, q: F.conv2d(t, wts, None, (1, s), (0, q)))
    want = op(x, p)
    if s == 1:
        owned = list(bounds)
    else:
        n = width // d
        assert all(b - a == n for a, b in bounds)
        owned = spatial.ownership(n, d, s, want.shape[-1])
    assert [j for j0, j1 in owned for j in range(j0, j1)] == list(range(want.shape[-1]))
    widths = [b - a for a, b in bounds]
    got = [spatial.op_window(widths, r, k, s, p) for r in range(d)]
    assert len({h for _, h, _ in got}) == 1         # one strip width on every rank
    assert all(out == [j1 - j0 for j0, j1 in owned] for _, _, out in got)
    wins = [win for win, _, _ in got]
    for r, ((a, _), win, cut) in enumerate(zip(bounds, wins, _exchanged_windows(
            x, bounds, wins, got[0][1], pad))):
        j0, j1 = owned[r]
        if j1 == j0:
            assert cut.shape[-1] == 0
            continue
        assert torch.equal(cut, _padded(x, a + win[0], a + win[1], pad)), r
        # a convolution's sums may take another order on a narrower input
        assert torch.allclose(op(cut, 0), want[..., j0:j1], rtol=0, atol=1e-12), r
    return want, owned


@pytest.mark.parametrize("d", range(2, 9))
@pytest.mark.parametrize("cells", [1, 2, 3, 4])
def test_ownership_and_exchange_plan_cover_every_window(d, cells):
    """The models' ops at widths 8 d .. 32 d (``cells`` 8-px cells a shard),
    with no process group: the ResNet's stem, pool, strided and 3x3
    convolutions down to 1/16 (uneven or empty blocks there), a 3x3
    convolution over those blocks, and the transposed convolution back to
    1/8, whose input blocks are the strided convolution's output blocks
    and whose windows arrive whole; the VGG's 3x3 convolutions and 2x2
    pools."""
    g = torch.Generator().manual_seed(d * 10 + cells)

    def equal(x):
        n = x.shape[-1] // d
        return [(r * n, (r + 1) * n) for r in range(d)]

    x = torch.randn(1, 1, 1, 8 * d * cells, dtype=torch.float64, generator=g)
    y, _ = _check_op(x, equal(x), 7, 2, 3)                  # stem
    y, _ = _check_op(y, equal(y), 3, 2, 1, pool=True)       # max pool
    _check_op(y, equal(y), 3, 1, 1)                         # layer1
    y, _ = _check_op(y, equal(y), 3, 2, 1)                  # layer2 -> 1/8
    _check_op(y, equal(y), 1, 2, 0)                         # its projection
    z, owned = _check_op(y, equal(y), 3, 2, 1)              # layer_in -> 1/16
    _check_op(y, equal(y), 1, 2, 0)
    _check_op(z, owned, 3, 1, 1)                            # 3x3 at 1/16
    blocks, outs, windows = spatial.transposed_windows(cells, d, 3, 2, 1, 1)
    assert blocks == owned
    assert outs[0][0] == 0 and outs[-1][1] >= d * cells
    h = max(max(spatial.halo_need(win, b - a)) for win, (a, b) in zip(windows, blocks))
    for (a, _), win, cut in zip(blocks, windows,
                                _exchanged_windows(z, blocks, windows, h, 0.0)):
        assert torch.equal(cut, _padded(z, a + win[0], a + win[1], 0.0))
    x = torch.randn(1, 1, 1, 8 * d * cells, dtype=torch.float64, generator=g)
    for _ in range(3):                                      # VGG
        _check_op(x, equal(x), 3, 1, 1)
        x, _ = _check_op(x, equal(x), 2, 2, 0, pool=True)
    _check_op(x, equal(x), 3, 1, 1)


def test_the_ops_refuse_blocks_they_cannot_take():
    """A strided op over unequal blocks, a halo of a block that is not its
    layout's, and a strided op that keeps the height (which names the
    blocks): each a ValueError, with no process group."""
    with pytest.raises(ValueError, match="equal blocks"):
        spatial.op_window([2, 1], 0, 3, 2, 1)
    w = spatial.Width(None, 0, 2, {6: [3, 2]})
    with pytest.raises(ValueError, match="that the op before it returned"):
        spatial._layout(torch.zeros(1, 1, 6, 2), w)
    assert spatial._layout(torch.zeros(1, 1, 6, 3), w) == [3, 2]
    assert spatial._layout(torch.zeros(1, 1, 12, 4), w) == [4, 4]
    with pytest.raises(ValueError, match="shrink the height"):
        spatial._record(w, 1, [1, 0], 1, True)


@pytest.mark.parametrize("rank,d,want", [(0, 2, slice(0, 24)), (1, 2, slice(24, 48)),
                                         (2, 3, slice(48, 72))])
def test_spatial_sharding_takes_the_ranks_columns(rank, d, want):
    assert M.spatial_sharding(M.DataMesh(d, rank, "width"), d * 24) == want


@pytest.mark.parametrize("width,d", [(40, 2), (48, 4), (72, 2)])
def test_a_width_that_does_not_split_raises_jax_rule(width, d):
    """JAX's rule, `feature_point_cnn_tpu/parallel/mesh.py:76-78`."""
    if width % (8 * d) == 0:
        M.spatial_sharding(M.DataMesh(d, 0, "width"), width)
        width += 8
    with pytest.raises(ValueError, match="mesh size x the total stride"):
        M.spatial_sharding(M.DataMesh(d, 0, "width"), width)
    with pytest.raises(ValueError, match="outside"):
        M.spatial_sharding(M.DataMesh(d, -1, "width"), 8 * d)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_shard_images_spatial_is_a_compact_block(kind):
    images = np.arange(2 * 3 * 32 * 3, dtype=np.float32).reshape(2, 3, 32, 3)
    if kind == "torch":
        images = torch.from_numpy(images)
    block = M.shard_images_spatial(images, M.DataMesh(2, 1, "width"))
    assert tuple(block.shape) == (2, 3, 16, 3)
    assert np.array_equal(np.asarray(block), np.asarray(images)[:, :, 16:])
    if kind == "torch":
        assert block.is_contiguous() and block.untyped_storage().nbytes() == block.numel() * 4
    else:
        assert block.flags["C_CONTIGUOUS"] and block.base is None


def test_make_spatial_mesh_without_a_process_group_is_this_process():
    mesh = M.make_spatial_mesh(4)
    assert (mesh.size, mesh.rank, mesh.axis, mesh.group) == (1, 0, "width", None)
    assert spatial.group() is None


def test_without_a_width_group_the_modules_are_the_plain_calls():
    """Bit for bit: `Conv2d`, `ConvTranspose2d` (its block width unused) and
    `spatial`'s ops are `F.conv2d` / `F.conv_transpose2d` / `F.max_pool2d`;
    the forward inside ``width_group(None)`` is the forward."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 12, 20, generator=g)
    conv = Conv2d(8, 6, 3, 2, 1, bias=True)
    assert torch.equal(conv(x), F.conv2d(x, conv.weight, conv.bias, 2, 1))
    assert torch.equal(spatial.conv2d(x, conv.weight, conv.bias, 2, 1),
                       F.conv2d(x, conv.weight, conv.bias, 2, 1))
    up = ConvTranspose2d(8, 4, 3, stride=2, padding=1, output_padding=1)
    want = F.conv_transpose2d(x, up.weight, up.bias, 2, 1, 1)
    assert torch.equal(up(x), want) and torch.equal(up(x, 7), want)
    assert torch.equal(spatial.max_pool2d(x, 3, 2, 1), F.max_pool2d(x, 3, 2, 1))
    model = SuperPoint(SuperPointConfig(descriptor_dim=D, compute_dtype="float32"),
                       generator=torch.Generator().manual_seed(1)).eval()
    img = torch.rand(1, 48, 40, 3, generator=g)
    with torch.no_grad():
        want = model(img)
        with spatial.width_group(None):
            got = model(img)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="width group"):
        spatial.halo(x, 1, 1)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
