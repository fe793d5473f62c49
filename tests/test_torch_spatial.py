"""PyTorch port: one image W-sharded over a width mesh of d ranks
(`parallel/spatial.py`), on the CPU over gloo, against the port's
one-process forward and JAX's W-sharded forward.

One module-scoped job of 4 ranks of this file's ``__main__`` (no JAX in
them) runs every scenario on width meshes of 2, 3 and 4 ranks (the job's
group or a subgroup of its first ranks), each writing an npz a scenario.
Eval-mode float32, ``descriptor_dim=32``, weights made by JAX's
`init_superpoint` with every BatchNorm jittered off 1 / 0 and carried over
by `state_dict_from_jax_variables`.  Each case is chosen for its geometry:

* 48x48, d = 2: 3 cells a rank at 1/8, an odd block, so the 1/16 blocks
  are uneven (2 and 1 columns);
* 48x72, d = 3: Wc = 9 is odd, so the transposed convolution overshoots the
  embedding grid by a column on the last rank, which alone crops it;
* 48x64, d = 4: 16 px a shard, one 1/16 column a rank, the per-shard
  geometry of JAX's own test (`tests/test_parallel.py:171`);
* 48x48, d = 2 with ``fold_bn``.

What the tests hold: the gathered outputs against the one-process forward
at atol 1e-5, and against JAX's W-sharded forward at the frontend tests'
float32 tolerance (atol 1e-5 + rtol 1e-4); each rank's block against the
matching slice of the one-process output; the ranks' gathered outputs bit
for bit; the exchanged buffers halo-sized; at d = 2 in float64 the input
gradient and the width-summed weight gradients of ``sum(r * outputs)``
against the one-process gradients within 1e-9 of each tensor's largest
entry; a width group of one rank bit-equal to the plain forward; the
refusals.  Without a process group, the mesh functions and the modules'
plain route.
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
import torch.nn.functional as F

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.models.blocks import Conv2d, ConvTranspose2d
from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
from feature_point_cnn_tpu_torch.parallel import mesh as M
from feature_point_cnn_tpu_torch.parallel import spatial

RANKS = 4
B, D = 2, 32
CASES = {            # name: (H, W, d, fold_bn)
    "w48_d2": (48, 48, 2, False),
    "w72_d3": (48, 72, 3, False),
    "w64_d4": (48, 64, 4, False),
    "w48_d2_fold": (48, 48, 2, True),
}
OUTPUTS = ("prob", "desc", "logits")


# ---------------------------------------------------------------------------
# the ranks (no JAX here)

def _model(state_dict, fold, double=False):
    model = SuperPoint(SuperPointConfig(descriptor_dim=D, compute_dtype="float32",
                                        fold_bn=fold))
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


def _gradients(inputs, mesh):
    """float64 input gradient (this rank's block) and the weight gradients
    summed over the width group, of ``sum(r * outputs)``."""
    from feature_point_cnn_tpu_torch.parallel.collectives import all_sum_

    model = _model(inputs["live"], False, double=True)
    x = M.shard_images_spatial(inputs["images"]["w48_d2"].double(), mesh)
    x.requires_grad_(True)
    with spatial.width_group(mesh.group):
        outs = model(x)
        loss = sum((o * r).sum() for o, r in zip(outs, _blocks(inputs["grad_r"], mesh)))
        loss.backward()
    return {"input": x.grad.numpy(),
            **{f"w/{n}": all_sum_(p.grad, mesh.group).numpy()
               for n, p in model.named_parameters()}}


def _refusals(inputs, mesh):
    """What a width group refuses, each message (every rank of it raises)."""
    from feature_point_cnn_tpu_torch.models.vgg_superpoint import VGGSuperPoint
    from feature_point_cnn_tpu_torch.ops.detection import extract_keypoints

    out = {}
    model = _model(inputs["live"], False)
    images = inputs["images"]["w48_d2"]
    for name, fn in (
        ("indivisible", lambda: M.shard_images_spatial(images[:, :, :40], mesh)),
        ("train", lambda: model.train()(M.shard_images_spatial(images, mesh))),
        ("narrow", lambda: model.eval()(M.shard_images_spatial(images[:, :, :16], mesh))),
        ("vgg", lambda: VGGSuperPoint(SuperPointConfig(compute_dtype="float32"))(
            M.shard_images_spatial(images, mesh))),
        ("extract", lambda: extract_keypoints(torch.zeros(1, 48, 24), SuperPointConfig())),
    ):
        try:
            with torch.no_grad(), spatial.width_group(None if name == "indivisible"
                                                      else mesh.group):
                fn()
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    return out


def _worker(port, rank, work):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from feature_point_cnn_tpu_torch.parallel import distributed

    assert distributed.initialize(f"localhost:{port}", RANKS, rank, device="cpu")
    inputs = torch.load(work / "inputs.pt", weights_only=False)

    def save(name, **arrays):
        np.savez(work / f"{name}_{rank}.npz", **arrays)

    for name, (h, w, d, fold) in CASES.items():
        mesh = M.make_spatial_mesh(d)       # collective: every rank makes it
        if not mesh.member:
            continue
        model = _model(inputs["fold" if fold else "live"], fold)
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
        save("grad", **_gradients(inputs, mesh))
        (work / f"refusals_{rank}.json").write_text(json.dumps(_refusals(inputs, mesh)))

    one = M.make_spatial_mesh(1)            # a subgroup of rank 0 alone
    if one.member:
        model = _model(inputs["live"], False)
        images = inputs["images"]["w48_d2"]
        spatial.reset_counts()
        with torch.no_grad():
            plain = model(images)
            with spatial.width_group(one.group):
                got = model(M.shard_images_spatial(images, one))
        save("one", **{f"plain/{k}": t.numpy() for k, t in zip(OUTPUTS, plain)},
             **{f"got/{k}": t.numpy() for k, t in zip(OUTPUTS, got)},
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


def _inputs(variables):
    from feature_point_cnn_tpu.models.fold import fold_batchnorm as jax_fold_batchnorm
    from feature_point_cnn_tpu_torch.utils.weights import state_dict_from_jax_variables

    rng = np.random.default_rng(1)
    images = {name: torch.from_numpy(rng.random((B, h, w, 3)).astype(np.float32))
              for name, (h, w, _, _) in CASES.items()}
    hc, wc = 48 // 8, 48 // 8
    grad_r = [torch.from_numpy(rng.standard_normal(s)) for s in
              ((B, 48, 48), (B, hc, wc, D), (B, hc, wc, 65))]
    return {"live": state_dict_from_jax_variables(variables),
            "fold": state_dict_from_jax_variables(jax_fold_batchnorm(variables)),
            "images": images, "grad_r": grad_r}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    work = tmp_path_factory.mktemp("spatial")
    variables = _jax_variables()
    inputs = _inputs(variables)
    torch.save(inputs, work / "inputs.pt")
    j = Job(work)
    j.inputs, j.variables = inputs, variables
    yield j
    for p in j.procs:
        if p.poll() is None:
            p.kill()


def _one_process(job, name):
    h, w, d, fold = CASES[name]
    with torch.no_grad():
        outs = _model(job.inputs["fold" if fold else "live"], fold)(job.inputs["images"][name])
    return dict(zip(OUTPUTS, (t.numpy() for t in outs)))


def _split(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


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
    as `tests/test_parallel.py:171` runs it; its outputs come back sharded
    along W."""
    import jax

    from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
    from feature_point_cnn_tpu.models.fold import fold_batchnorm as jax_fold_batchnorm
    from feature_point_cnn_tpu.models.superpoint import SuperPoint as JaxSuperPoint
    from feature_point_cnn_tpu.parallel import mesh as JM

    h, w, d, fold = CASES[name]
    variables = jax_fold_batchnorm(job.variables) if fold else job.variables
    model = JaxSuperPoint(config=JaxConfig(descriptor_dim=D, compute_dtype="float32",
                                           fold_bn=fold))
    m = JM.make_spatial_mesh(d)
    x = JM.shard_images_spatial(job.inputs["images"][name].numpy(), m)
    v = jax.tree_util.tree_map(lambda a: jax.device_put(a, JM.replicated(m)), variables)
    want = jax.jit(lambda v_, x_: model.apply(v_, x_, train=False))(v, x)
    assert all(t.sharding.spec[2] == "width" for t in want), [t.sharding for t in want]
    got = _split(job.result(name, 0), "gathered/")
    for k, t in zip(OUTPUTS, want):
        np.testing.assert_allclose(got[k], np.asarray(t), atol=1e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_gather_bit_identical_outputs_through_halo_sized_buffers(job, name):
    """Every rank gathers the same bits.  One exchange a 3x3 or 7x7
    convolution, the pool and the transposed convolution (13 a forward; the
    1x1 convolutions, strided or not, exchange nothing), and the largest
    buffer is the max pool's ``(d, 2, B, 64, H/2, 1)``: its halo columns,
    2 d / (W/2) of the pool's full-width input."""
    h, w, d, _ = CASES[name]
    outs = [job.result(name, r) for r in range(d)]
    for out in outs[1:]:
        for k in OUTPUTS:
            assert np.array_equal(out[f"gathered/{k}"], outs[0][f"gathered/{k}"]), k
    for out in outs:
        assert int(out["count/exchanges"]) == 13
        assert int(out["count/largest_bytes"]) == d * 2 * B * 64 * (h // 2) * 4
        assert int(out["count/largest_bytes"]) < B * 64 * (h // 2) * (w // 2) * 4 / 2


def test_float64_gradients_equal_the_one_process_gradients(job):
    """d = 2, 48x48: the input gradient (gathered from the blocks) and the
    weight gradients summed over the width group, of ``sum(r * outputs)``,
    within 1e-9 of each tensor's largest entry."""
    model = _model(job.inputs["live"], False, double=True)
    x = job.inputs["images"]["w48_d2"].double().requires_grad_(True)
    outs = model(x)
    sum((o * r).sum() for o, r in zip(outs, job.inputs["grad_r"])).backward()
    got = [job.result("grad", r) for r in range(2)]
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


def test_a_width_group_of_one_rank_is_the_plain_forward(job):
    out = job.result("one", 0)
    assert int(out["exchanges"]) == 0
    for k in OUTPUTS:
        assert np.array_equal(out[f"got/{k}"], out[f"plain/{k}"]), k


@pytest.mark.parametrize("what,match", [
    ("indivisible", "mesh size x the total stride"),
    ("train", "train-mode BatchNorm"),
    ("narrow", "at least 2 columns"),
    ("vgg", "VGG"),
    ("extract", "not local"),
])
def test_a_width_group_refuses_what_it_cannot_split(job, what, match):
    """A width that is not a multiple of d x 8 (GSPMD would quietly
    replicate it), train-mode BatchNorm, 8 px a shard (a 1/16 block would
    be empty), the VGG family and keypoints of a sharded map: each a
    ValueError on every rank."""
    job.wait()
    for r in range(2):
        raised = json.loads((job.work / f"refusals_{r}.json").read_text())
        assert match in raised[what], raised[what]


# ---------------------------------------------------------------------------
# no process group: the mesh functions and the plain route

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
