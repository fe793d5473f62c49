"""PyTorch port: the CUDA kernels against their plain versions, on the card.

This file imports neither JAX nor the JAX package and defines its own
fixtures, so it runs on a CUDA machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

Without a card every test skips.  NMS runs small maps (a few listed
(row, strip) pairs a pass: the direct mode), dense 480x642 and 1081x1922
maps (the ring mode, scalar loads for W % 4 != 0), 1080x1920 (the state in
device memory), 33 frames, and r = 0..7; its rounds a frame, a device
tensor, are held against the plain loop's.  Tolerances: decode within 1e-6
of its plain version (``expf`` against PyTorch's ``exp``, same float32
order of the 65-way sum up to a few ulps), NMS exactly (float compare and
max only),
the descriptor loss as the JAX package's own kernel test
(`tests/test_pallas.py:49-62`): value rtol 2e-5, gradients atol 2e-6 +
rtol 2e-4 (the D-long dot products and the N-long sums run in another order
than cuBLAS's and PyTorch's reductions; each product is three TF32
products of split operands on the tensor cores, float32-grade).  The shapes
cross every edge of the kernels' tiling (N = 195 is 128 + 64 + 3, D = 8 is
one k-step, D = 128 the widest, N = 4800 is a 480x640 image's cells; D = 12,
100 and 5 are widths the wrapper zero-pads to whole k-steps); D = 136 is
beyond the kernels' limit and raises.  The training data path: k = 3
steps a call as replays of the captured CUDA graph of the step against
eager steps, float32, TF32 off, deterministic cuDNN, parameters within
rtol 2e-4 + atol 2e-5 (measured equal); the folded frontend against live
BatchNorm, prob maps within 1e-5 and the same keypoints.  The ``fpc`` ops
and a frame program exported on the card: the plain versions' outputs
exactly, the eager frame's at the frontend tests' tolerances.  The VGG's
convolution epilogue: bit for bit its plain passes at each of the VGG's
twelve layer shapes at B = 32, 480x640, at odd and ragged shapes and on
NaN, infinities, signed zeros and subnormals; the VGG forward through it
bit for bit the forward through the plain passes, for a channels-last
module and a plain one, 12 kernel calls a forward (10 without
descriptors).
"""

import itertools

import numpy as np
import pytest
import torch

from chip_smoke import VGG_EPILOGUES
from feature_point_cnn_tpu_torch.ops.kernels.conv_epilogue import (
    conv_epilogue,
    conv_epilogue_plain,
)
from feature_point_cnn_tpu_torch.ops.kernels.decode import (
    decode_threshold_cuda,
    decode_threshold_plain,
)
from feature_point_cnn_tpu_torch.ops.kernels.descriptor_loss import (
    hinge_descriptor_loss_cuda,
    hinge_descriptor_loss_plain,
)
from feature_point_cnn_tpu_torch.ops.kernels.nms import (
    grid_nms_cuda,
    grid_nms_plain,
    nms_layout,
    plain_rounds,
)
from feature_point_cnn_tpu_torch.utils import profiling


@pytest.fixture
def rng():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return np.random.default_rng(0)


def _cuda(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 60, 80), (1, 9, 11), (32, 60, 80)])
def test_decode_kernel_matches_plain(rng, shape):
    logits = _cuda(rng.standard_normal((*shape, 65)) * 4)
    logits[0, 0, 0] = 300.0          # extreme but finite logits
    logits[0, 0, 0, 3] = 400.0
    n0 = profiling.COUNTERS["kernel.decode_threshold"]
    got = decode_threshold_cuda(logits, 8, 0.015)
    assert profiling.COUNTERS["kernel.decode_threshold"] == n0 + 1
    want = decode_threshold_plain(logits, 8, 0.015)
    prob = decode_threshold_plain(logits, 8, 0.0)
    flip = (got > 0) != (want > 0)
    assert bool(((prob[flip] - 0.015).abs() <= 1e-6).all())
    assert (got - want).abs()[~flip].max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.01, 0.3, 1.0])
def test_nms_kernel_matches_plain_exactly(rng, density):
    vals = rng.random((3, 120, 168)).astype(np.float32) * 0.9 + 0.05
    vals[rng.random(vals.shape) >= density] = 0.0
    scores = _cuda(vals)
    n0 = profiling.COUNTERS["kernel.grid_nms"]
    got = grid_nms_cuda(scores, 4)
    assert profiling.COUNTERS["kernel.grid_nms"] == n0 + 1
    assert torch.equal(got, grid_nms_plain(scores, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1080, 1920), (33, 64, 96), (2, 37, 50)],
                         ids=lambda s: "x".join(map(str, s)))
def test_nms_kernel_large_and_many_frames(rng, shape):
    """1080x1920 keeps its bands in the device-memory scratch; 33 frames are
    more clusters than some launches hold at once; 37x50 has uneven bands
    and rows that are not whole 16 B."""
    vals = rng.random(shape).astype(np.float32) * 0.9 + 0.05
    vals[rng.random(shape) >= 0.05] = 0.0
    scores = _cuda(vals)
    assert nms_layout(shape[1], shape[2], 4).band_in_shared == (shape[1] < 1000)
    got = grid_nms_cuda(scores, 4)
    assert torch.equal(got, grid_nms_plain(scores, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dist", [((1, 480, 642), 0), ((1, 480, 642), 1),
                                        ((1, 480, 642), 7), ((1, 1081, 1922), 4)],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_nms_kernel_dense_maps_walk_the_ring(rng, shape, dist):
    """Dense maps list more active (row, strip) pairs than the direct mode
    takes, so the passes walk the register ring; W % 4 == 2 takes the
    scalar loads, in shared memory and in the device-memory scratch."""
    vals = rng.random(shape).astype(np.float32) * 0.9 + 0.05
    vals[rng.random(shape) >= 0.3] = 0.0
    scores = _cuda(vals)
    got = grid_nms_cuda(scores, dist)
    rounds = grid_nms_cuda.last_rounds
    assert torch.equal(got, grid_nms_plain(scores, dist))
    torch.cuda.synchronize()
    assert rounds.tolist() == plain_rounds(scores, dist)


@pytest.mark.cuda
@pytest.mark.parametrize("dist", list(range(8)))
def test_nms_kernel_ramp_and_plateaus(rng, dist):
    h, w = 64, 96
    ramp = np.arange(h * w, dtype=np.float32).reshape(h, w) / (h * w) * 0.9 + 0.05
    plate = np.zeros((h, w), np.float32)
    plate[8:40, 8:40] = 0.25
    plate[::2, 50::2] = 0.9
    scores = _cuda(np.stack([ramp, plate, np.full((h, w), 0.015, np.float32)]))
    got = grid_nms_cuda(scores, dist)
    rounds = grid_nms_cuda.last_rounds
    assert torch.equal(got, grid_nms_plain(scores, dist))
    # the rounds are a device tensor, read after a synchronise
    assert rounds.is_cuda and rounds.dtype == torch.int32
    torch.cuda.synchronize()
    assert rounds.tolist() == plain_rounds(scores, dist)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(rng):
    """On a CUDA tensor a wrapper launches its kernel or raises; it never
    hands the tensor to its plain version.  The checks are the ops' own, so
    a direct ``torch.ops.fpc`` call raises as the wrappers do."""
    for decode in (decode_threshold_cuda, torch.ops.fpc.decode_threshold):
        with pytest.raises(ValueError):
            decode(_cuda(np.zeros((1, 2, 2, 65))).half(), 8, 0.015)
        with pytest.raises(ValueError):
            decode(_cuda(np.zeros((1, 2, 2, 65))), 4, 0.015)
    for nms in (grid_nms_cuda, torch.ops.fpc.grid_nms):
        with pytest.raises(ValueError):
            nms(_cuda(np.zeros((1, 8, 8))), 8)
        with pytest.raises(ValueError):
            nms(_cuda(np.zeros((8, 8))), 4)


def _desc_loss_inputs(rng, b, hc, wc, dim, zero=False):
    """Unit descriptors, cell centers moved by a mild affine map, and a
    mask with ~15% zeros, on the card."""
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
    return (_cuda(d[0]), _cuda(d[1]), _cuda(warped), _cuda(centers),
            _cuda(mask.astype(np.float32)))


def _value_and_grads(fn, d, wd, rest, scale):
    d = d.clone().requires_grad_(True)
    wd = wd.clone().requires_grad_(True)
    v = fn(d, wd, *rest, 250.0, 1.0, 0.2, 8) * scale
    v.backward()
    return v.detach(), d.grad, wd.grad


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(2, 6, 8, 32), (1, 8, 16, 16), (2, 10, 14, 8), (3, 9, 15, 128),
              (2, 13, 15, 128), (2, 13, 15, 8), (1, 60, 80, 64), (2, 10, 14, 12),
              (1, 9, 15, 100), (2, 6, 8, 5)],
    ids=lambda s: "x".join(map(str, s)))
def test_descriptor_loss_kernels_match_plain(rng, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    _, hc, wc, _ = shape
    d, wd, *rest = _desc_loss_inputs(rng, *shape)
    scale = 1.0 / (float(rest[2].sum()) * hc * wc)   # the loss's normalisation
    before = profiling.counters()
    got = _value_and_grads(hinge_descriptor_loss_cuda, d, wd, rest, scale)
    torch.cuda.synchronize()
    assert profiling.counted_since(before) == {"kernel.desc_loss_fwd": 1,
                                               "kernel.desc_loss_bwd": 1}
    want = _value_and_grads(hinge_descriptor_loss_plain, d, wd, rest, scale)
    torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=0.0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-6)
    # fixed-order sums: a second run repeats bit for bit
    again = _value_and_grads(hinge_descriptor_loss_cuda, d, wd, rest, scale)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_descriptor_loss_kernels_zero_descriptors_finite(rng):
    d, wd, *rest = _desc_loss_inputs(rng, 1, 4, 4, 8, zero=True)
    v, gd, gw = _value_and_grads(hinge_descriptor_loss_cuda, d, wd, rest, 1.0)
    assert bool(torch.isfinite(v)) and bool(torch.isfinite(gd).all())
    assert bool(torch.isfinite(gw).all())


@pytest.mark.cuda
def test_descriptor_loss_kernel_rejects_what_it_does_not_take(rng):
    d, wd, *rest = _desc_loss_inputs(rng, 1, 4, 4, 8)
    with pytest.raises(ValueError):
        hinge_descriptor_loss_cuda(d.half(), wd, *rest, 250.0, 1.0, 0.2, 8)
    with pytest.raises(ValueError):
        hinge_descriptor_loss_cuda(d, wd[:, :8], *rest, 250.0, 1.0, 0.2, 8)
    with pytest.raises(ValueError):
        hinge_descriptor_loss_cuda(d, wd, rest[0], rest[1].cpu(), rest[2],
                                   250.0, 1.0, 0.2, 8)
    wide = _desc_loss_inputs(rng, 1, 4, 4, 136)     # D beyond the kernels' 128
    with pytest.raises(ValueError):
        hinge_descriptor_loss_cuda(*wide, 250.0, 1.0, 0.2, 8)


# ---------------------------------------------------------------------------
# the training data path: k steps a call as CUDA graph replays, and the
# BatchNorm fold of the serving model
# ---------------------------------------------------------------------------

def _packed_split(tmp_path, n: int, h: int, w: int, seed: int = 0):
    """``n`` polygon scenes with their corners, written as npz items and
    packed; returns the `PackedPointDataset`."""
    from chip_smoke import write_scene_items
    from feature_point_cnn_tpu_torch.data.packed import PackedPointDataset, pack_split

    write_scene_items(tmp_path / "npz", seed, n, h, w)
    pack_split(str(tmp_path / "npz"), str(tmp_path / "packed" / "train"))
    return PackedPointDataset(str(tmp_path / "packed"), "train")


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["magicpoint", "superpoint"])
def test_graphed_steps_equal_eager_steps(rng, tmp_path, phase):
    """k = 3 steps a call as replays of the captured step (7 batches: two
    calls and a tail of one) against k = 1 eager steps, float32 with TF32
    off: parameters within rtol 2e-4 + atol 2e-5; the descriptor-loss
    launches counted, replays included."""
    from feature_point_cnn_tpu_torch.config import SuperPointConfig
    from feature_point_cnn_tpu_torch.data.device_store import DeviceBatchLoader
    from feature_point_cnn_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # cuDNN's deterministic algorithms: both runs then take the same
    # arithmetic, and what is compared is the graph, not atomics' order
    torch.backends.cudnn.deterministic = True
    ds = _packed_split(tmp_path, 14, 48, 64)
    cfg = SuperPointConfig(compute_dtype="float32", train_image_size=(48, 64),
                           batch_size=2, max_points=32, epochs=1,
                           lr_schedule="constant")
    loader = DeviceBatchLoader(ds, 2, cfg.max_points, device="cuda")
    got = {}
    for k in (1, 3):
        t = Trainer(cfg.replace(train_steps_per_call=k), phase, loader, None,
                    str(tmp_path / f"ck{k}"), device="cuda", log_every=1,
                    write_statistics=False)
        before = profiling.counters()
        t.train_epoch(0)
        torch.cuda.synchronize()
        assert t.state.step == 7 and int(t.state.optimizer.count) == 7
        assert (t._graph is not None) == (k > 1)
        counted = profiling.counted_since(before)
        assert counted["train.steps"] == 7
        if phase == "superpoint":
            # eager: once a step; graphed: 2 warm-up steps, the 6 replays
            # (each credited with what the capture counted), the tail
            want = 7 if k == 1 else 2 + 6 + 1
            assert counted["kernel.desc_loss_fwd"] == counted["kernel.desc_loss_bwd"] == want
        got[k] = {n: v.detach().clone() for n, v in t.state.model.state_dict().items()}
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    diff = {n: float((got[3][n].float() - v.float()).abs().max())
            for n, v in got[1].items()}
    print("max |graphed - eager| by tensor:", diff)
    for name, v in got[1].items():
        torch.testing.assert_close(got[3][name], v, rtol=2e-4, atol=2e-5, msg=name)


@pytest.mark.cuda
def test_replays_credit_the_captured_launches(rng, tmp_path):
    """A training call of 4 replays counts what 4 eager steps count: 4
    launches of each descriptor-loss direction and 4 steps.  The first
    call adds the capture's 2 eager warm-up steps; the capture itself
    runs nothing and counts nothing."""
    from feature_point_cnn_tpu_torch.config import SuperPointConfig
    from feature_point_cnn_tpu_torch.data.device_store import DeviceBatchLoader
    from feature_point_cnn_tpu_torch.train.trainer import Trainer

    ds = _packed_split(tmp_path, 8, 48, 64)
    cfg = SuperPointConfig(compute_dtype="float32", train_image_size=(48, 64),
                           batch_size=2, max_points=32, epochs=1,
                           lr_schedule="constant", train_steps_per_call=4)
    loader = DeviceBatchLoader(ds, 2, cfg.max_points, device="cuda")
    t = Trainer(cfg, "superpoint", loader, None, str(tmp_path / "ck"), device="cuda",
                write_statistics=False)
    idxs = list(loader.epoch_index_arrays(0))
    assert len(idxs) == 4
    counted = []
    for first in (0, 4):
        before = profiling.counters()
        t.train_steps(idxs, 0, first)
        torch.cuda.synchronize()
        counted.append(profiling.counted_since(before))
    assert t._graph is not None and t.state.step == 8
    assert counted == [{"kernel.desc_loss_fwd": 6, "kernel.desc_loss_bwd": 6, "train.steps": 4},
                       {"kernel.desc_loss_fwd": 4, "kernel.desc_loss_bwd": 4, "train.steps": 4}]


@pytest.mark.cuda
def test_folded_frontend_equals_live_bn_on_the_card(rng):
    """The released weights folded at load against live BatchNorm, float32
    with TF32 off: prob maps within 1e-5, the same keypoints."""
    from chip_smoke import polygon_scene
    from feature_point_cnn_tpu_torch.config import SuperPointConfig
    from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
    from feature_point_cnn_tpu_torch.utils.weights import released_path

    torch.backends.cudnn.allow_tf32 = False
    cfg = SuperPointConfig(compute_dtype="float32")
    live = SuperPointFrontend(cfg, weights_path=released_path(), device="cuda")
    fold = SuperPointFrontend(cfg.replace(fold_bn=True), weights_path=released_path(),
                              device="cuda")
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in fold.model.modules())
    imgs = np.stack([np.repeat(polygon_scene(rng, 240, 320)[..., None], 3, -1)
                     for _ in range(2)])
    x = torch.from_numpy(imgs).cuda()
    with torch.inference_mode():
        p_live, p_fold = live.model(x)[0], fold.model(x)[0]
    torch.testing.assert_close(p_fold, p_live, rtol=0.0, atol=1e-5)
    kl, _ = live.extract(x)
    kf, _ = fold.extract(x)
    assert torch.equal(kl.valid, kf.valid)
    assert torch.equal(kl.y[kl.valid], kf.y[kf.valid])
    assert torch.equal(kl.x[kl.valid], kf.x[kf.valid])
    torch.backends.cudnn.allow_tf32 = True


@pytest.mark.cuda
def test_fpc_ops_and_the_exported_frame_program(rng):
    """The ``fpc`` ops launch the kernels (counted) and return what the
    plain versions return, the NMS op with its rounds a frame; a frame
    program exported on the card holds both ops, and its module gives the
    eager frame's outputs (float32, at `tests/test_torch_frontend.py`'s
    tolerances: its BatchNorm may run another kernel than eager's) through
    one decode and one NMS launch a call."""
    from feature_point_cnn_tpu_torch.config import SuperPointConfig
    from feature_point_cnn_tpu_torch.inference.wrapper import (
        KERNEL_OPS,
        SuperPointFrontend,
        graph_ops,
    )

    scores = _cuda(rng.random((3, 48, 64)) * (rng.random((3, 48, 64)) < 0.2))
    n0 = profiling.COUNTERS["kernel.grid_nms"]
    kept, rounds = torch.ops.fpc.grid_nms(scores, 4)
    assert profiling.COUNTERS["kernel.grid_nms"] == n0 + 1
    assert torch.equal(kept, grid_nms_plain(scores, 4))
    assert rounds.tolist() == plain_rounds(scores, 4)

    fe = SuperPointFrontend(SuperPointConfig(max_keypoints=64, compute_dtype="float32"),
                            device="cuda")
    ep, meta = fe.native_program((48, 64), top_n=32)
    assert KERNEL_OPS <= graph_ops(ep)
    image = _cuda(rng.random((1, 48, 64, 3)))
    key = (torch.zeros((32, 128), dtype=torch.float16, device="cuda"),
           torch.zeros((), dtype=torch.int32, device="cuda"))
    before = profiling.counters()
    with torch.no_grad():
        got = ep.module()(image, *key)
    assert profiling.counted_since(before) == {"kernel.decode_threshold": 1,
                                               "kernel.grid_nms": 1}
    num, packed, match, desc = (t.cpu().numpy() for t in fe.frame(image, *key, top_n=32))
    assert int(got[0]) == int(num[0])
    same = (got[1].cpu().numpy()[..., :2] == packed[0, :, :2]).all(-1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got[1].cpu().numpy()[same], packed[0][same], atol=1e-5)
    np.testing.assert_allclose(got[3].cpu().numpy()[same].astype(np.float32),
                               desc[0][same].astype(np.float32), atol=1e-3)
    assert (got[2].cpu().numpy() == match[0]).mean() >= 0.99


SPECIAL = (float("nan"), float("inf"), float("-inf"), -0.0, 0.0, 1e30, -1e30, 2 ** -130)


def _conv_output(b, c, h, w, seed):
    """A channels-last bf16 'convolution output' drawn on the card, with
    NaN, infinities, signed zeros, huge values and bf16 subnormals at
    drawn places, and a float32 bias whose channel 1 is NaN."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    nhwc = (torch.randn((b, h, w, c), generator=g, device="cuda") * 3).to(torch.bfloat16)
    flat = nhwc.view(-1)
    if flat.numel():
        at = torch.randint(0, flat.numel(), (64 * len(SPECIAL),), generator=g, device="cuda")
        flat[at] = torch.tensor(SPECIAL * 64, dtype=torch.bfloat16, device="cuda")
    bias = torch.randn((c,), generator=g, device="cuda") * 0.5
    if c > 1:
        bias[1] = float("nan")
    return nhwc.permute(0, 3, 1, 2), bias


def _assert_same_bits(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.is_contiguous(memory_format=torch.channels_last), what
    view = torch.int16 if got.element_size() == 2 else torch.int32
    same = got.contiguous().view(view) == want.contiguous().view(view)
    assert bool(same.all()), f"{what}: {int((~same).sum())} elements differ"


@pytest.mark.cuda
@pytest.mark.parametrize("layer", list(VGG_EPILOGUES))
@torch.inference_mode()
def test_conv_epilogue_equals_plain_at_the_vgg_shapes(rng, layer):
    """Each of the VGG's layers at B = 32, 480x640: one kernel call, bit for
    bit the plain passes on the same card inputs."""
    c, h, w, relu, pool, f32 = VGG_EPILOGUES[layer]
    y, bias = _conv_output(32, c, h, w, seed=len(layer))
    want = conv_epilogue_plain(y, bias, relu, pool, f32)
    before = profiling.counters()
    got = conv_epilogue(y, bias, relu, pool, f32)
    torch.cuda.synchronize()
    assert profiling.counted_since(before) == {"kernel.conv_epilogue": 1}
    _assert_same_bits(got, want, layer)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 64, 37, 51), (2, 16, 5, 7), (1, 8, 2, 3),
                                   (2, 65, 9, 11), (1, 5, 3, 3), (0, 16, 4, 4)],
                         ids=lambda s: "x".join(map(str, s)))
@torch.inference_mode()
def test_conv_epilogue_odd_and_ragged_maps(rng, shape):
    """Odd pooled maps (a last row and column dropped; 2x3 pools to one
    pixel), C = 65 and 5 (vectors across pixels, a partial last vector)
    and an empty batch, over every switch the kernel takes."""
    c = shape[1]
    y, bias = _conv_output(*shape, seed=sum(shape))
    for relu, pool, f32 in itertools.product((True, False), repeat=3):
        if pool and c % 8:
            continue
        want = conv_epilogue_plain(y, bias, relu, pool, f32)
        _assert_same_bits(conv_epilogue(y, bias, relu, pool, f32), want,
                          f"{shape} relu={relu} pool={pool} f32={f32}")


def _vgg(layout: str):
    from feature_point_cnn_tpu_torch.models.vgg_superpoint import VGG_CONFIG, VGGSuperPoint

    model = VGGSuperPoint(VGG_CONFIG, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():      # nonzero biases, so that the bias add shows
        g = torch.Generator().manual_seed(1)
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.normal_(0.0, 0.1, generator=g)
    if layout == "channels_last":     # as the frontend moves it
        return model.to("cuda", memory_format=torch.channels_last).eval()
    return model.to("cuda").eval()     # as the benchmark's driver moves it


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_vgg_forward_through_the_epilogue_equals_the_plain_passes(rng, layout):
    """The bf16 VGG at 480x640: under inference mode 12 kernel calls a
    forward (10 without descriptors); with autograd on the plain passes and
    no kernel call; the three outputs bit for bit the same."""
    model = _vgg(layout)
    image = torch.rand((8, 480, 640, 1), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.inference_mode():
        before = profiling.counters()
        fused = model(image)
        torch.cuda.synchronize()
        assert profiling.counted_since(before) == {"kernel.conv_epilogue": 12}
        before = profiling.counters()
        logits_only = model.features(image, enable_descriptor=False)
        torch.cuda.synchronize()
        assert profiling.counted_since(before) == {"kernel.conv_epilogue": 10}
    before = profiling.counters()
    plain = model(image)
    torch.cuda.synchronize()
    assert profiling.counted_since(before) == {}
    for name, f, p in zip(("prob", "desc", "logits"), fused, plain):
        assert torch.equal(f, p.detach()), name
    assert torch.equal(logits_only[0], fused[2])
