"""PyTorch port: SuperGlue (`models/superglue.py`) and the serving frame's
SuperGlue mode, held to the plain reference `tests/plain_superglue.py`
(one pair at a time, float32, as the published code computes it) at the
published widths (D = 256, 4 heads, 18 layers, encoder 32-64-128-256) on
a few keypoints, with seeded random weights and BatchNorm statistics.

The Sinkhorn kernel (`ops/kernels/sinkhorn.py`) is held to the plain loop:
its band schedule emulated on the CPU, the kernel itself on the card at
the benchmark's (32, 1024, 1024) and at small ragged shapes.

This file imports neither JAX nor the JAX package.  The ``cuda`` cases
run on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_superglue.py -q
"""

import copy
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import shifted_pair, transport_close
from feature_point_cnn_tpu_torch.config import SuperGlueConfig, SuperPointConfig
from feature_point_cnn_tpu_torch.inference.wrapper import (
    FrameProgram,
    SuperPointFrontend,
    frame_signature,
)
from feature_point_cnn_tpu_torch.models.superglue import SuperGlue, assign
from feature_point_cnn_tpu_torch.ops import kernels
from feature_point_cnn_tpu_torch.ops.kernels import sinkhorn
from feature_point_cnn_tpu_torch.utils import profiling
from tests.plain_superglue import match_pair

ROOT = Path(__file__).resolve().parents[1]
H, W = 64, 96
REF_CFG = {"descriptor_dim": 256, "keypoint_encoder": [32, 64, 128, 256],
           "GNN_layers": ["self", "cross"] * 9, "sinkhorn_iterations": 100,
           "match_threshold": 0.2, "num_heads": 4, "bn_eps": 1e-5}


def _device(name: str) -> str:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return name


@torch.no_grad()
def _exercise_batchnorm(model: torch.nn.Module, seed: int) -> None:
    """BatchNorm affine parameters and running statistics drawn from
    ``seed`` (variances kept positive), so the normalisation does work."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            c = m.num_features
            m.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
            m.bias.copy_(0.1 * torch.randn(c, generator=g))
            m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
            m.running_var.copy_(0.5 + torch.rand(c, generator=g))


@functools.lru_cache(maxsize=None)
def _superglue(dtype: str) -> SuperGlue:
    sg = SuperGlue(SuperGlueConfig(compute_dtype=dtype),
                   generator=torch.Generator().manual_seed(1)).eval()
    _exercise_batchnorm(sg, 2)
    return sg


def _side(g: torch.Generator, b: int, n: int):
    """``(b, n, 3)`` ``[y, x, score]`` and ``(b, n, 256)`` unit f16
    descriptors."""
    kp = torch.stack([torch.rand(b, n, generator=g) * (H - 1),
                      torch.rand(b, n, generator=g) * (W - 1),
                      torch.rand(b, n, generator=g) * 0.5], -1)
    desc = torch.nn.functional.normalize(torch.randn(b, n, 256, generator=g), dim=-1)
    return kp, desc.half()


def _reference(sg, kp0, desc0, kp1, desc1):
    return match_pair(dict(sg.state_dict()), REF_CFG, kp0, desc0, kp1, desc1, (H, W))


def _valid_block(z: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """A padded ``Z``'s valid rows and columns with the dustbins."""
    rows = torch.cat([torch.arange(n), torch.tensor([z.shape[0] - 1])])
    cols = torch.cat([torch.arange(m), torch.tensor([z.shape[1] - 1])])
    return z[rows][:, cols]


def test_state_dict_has_the_published_names():
    sd = SuperGlue().state_dict()
    shapes = {k: tuple(v.shape) for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    assert shapes["bin_score"] == ()
    assert shapes["kenc.encoder.0.weight"] == (32, 3, 1)
    assert shapes["kenc.encoder.1.running_var"] == (32,)
    assert shapes["kenc.encoder.12.weight"] == (256, 256, 1)
    assert shapes["final_proj.weight"] == (256, 256, 1)
    for i in range(18):
        for j in range(3):
            assert shapes[f"gnn.layers.{i}.attn.proj.{j}.weight"] == (256, 256, 1)
        assert shapes[f"gnn.layers.{i}.attn.merge.bias"] == (256,)
        assert shapes[f"gnn.layers.{i}.mlp.0.weight"] == (512, 512, 1)
        assert shapes[f"gnn.layers.{i}.mlp.1.running_mean"] == (512,)
        assert shapes[f"gnn.layers.{i}.mlp.3.weight"] == (256, 512, 1)
    # encoder: 5 convs, 4 BatchNorms; a layer: 4 attention convs, 2 MLP
    # convs and a BatchNorm
    convs = 5 + 18 * 6 + 1
    assert len(shapes) == 1 + 2 * convs + 4 * (4 + 18)
    assert not any("head_major" in k for k in sd)


@pytest.mark.parametrize("counts", [(0, 1, 7, 16)])
def test_padded_batch_equals_the_unpadded_pairs(counts):
    """Four pairs padded to N = 16 rows against a keyframe of 11 valid rows
    padded to 20: each pair's valid rows equal the reference on that
    pair's valid keypoints alone.  float32 on both sides; the tolerance is
    float32 summation order (matrix products against convolutions, the
    padded log-sum-exp), 1e-5 of Z's largest magnitude, through 18 layers
    and 100 iterations."""
    sg = _superglue("float32")
    g = torch.Generator().manual_seed(5)
    b, n, m, key = len(counts), 16, 20, 11
    kp0, d0 = _side(g, b, n)
    kp1, d1 = _side(g, 1, m)
    num0 = torch.tensor(counts)
    args = (kp0, d0, num0, kp1.expand(b, -1, -1), d1.expand(b, -1, -1),
            torch.full((b,), key), (H, W))
    with torch.no_grad():
        z = sg.log_assignment(*args)
        index, score = sg(*args)
    assert not z.isnan().any()
    for i, c in enumerate(counts):
        want = _reference(sg, kp0[i, :c], d0[i, :c], kp1[0, :key], d1[0, :key])
        assert torch.equal(index[i, c:], torch.full((n - c,), -1))
        assert torch.equal(score[i, c:], torch.zeros(n - c))
        if want["Z"] is None:
            assert torch.equal(index[i], torch.full((n,), -1))
            continue
        got = _valid_block(z[i], c, key)
        tol = 1e-5 * float(want["Z"].abs().max())
        torch.testing.assert_close(got, want["Z"], rtol=0, atol=tol)
        assert torch.isinf(z[i, c:n]).all() and torch.isinf(z[i, :, key:m]).all()
        assert torch.equal(index[i, :c], want["index"])
        # a gap of Z is the score's relative gap
        torch.testing.assert_close(score[i, :c], want["score"], rtol=tol, atol=0)


def test_transport_has_the_marginals():
    """``exp(Z)`` of a pair with N valid rows and M valid columns: each
    valid row and column sums to 1 (Z is scaled by M + N), the dustbin row
    to M and the dustbin column to N.  The column sums hold exactly after
    the last half-iteration; the row sums to the Sinkhorn's convergence.
    Random weights give scores of tens, at which 100 iterations leave rows
    a quarter off (the reference too); ``final_proj`` scaled by 1/16
    brings them to order one, where the rows converge to 1e-3."""
    sg = copy.deepcopy(_superglue("float32"))
    with torch.no_grad():
        sg.final_proj.weight.mul_(1 / 16)
    g = torch.Generator().manual_seed(7)
    kp0, d0 = _side(g, 2, 12)
    kp1, d1 = _side(g, 2, 12)
    num0, num1 = torch.tensor([12, 5]), torch.tensor([9, 12])
    with torch.no_grad():
        z = sg.log_assignment(kp0, d0, num0, kp1, d1, num1, (H, W))
    for i in range(2):
        n, m = int(num0[i]), int(num1[i])
        p = _valid_block(z[i], n, m).exp().double()
        torch.testing.assert_close(p[:, :-1].sum(0), torch.ones(m, dtype=torch.float64),
                                   rtol=0, atol=1e-5)
        assert abs(float(p[:, -1].sum()) - n) < 1e-4 * n
        torch.testing.assert_close(p[:-1].sum(1), torch.ones(n, dtype=torch.float64),
                                   rtol=0, atol=1e-3)
        assert abs(float(p[-1].sum()) - m) < 1e-3 * m


def test_bfloat16_follows_the_reference():
    """The configuration's precision split (bf16 products, float32 residual
    stream, BatchNorm and Sinkhorn) against the float32 reference.  bf16
    keeps 8 bits of each operand, and 18 residual layers carry each
    layer's rounding on, so the log row maxima move by a few per cent of
    their spread and near-tied row argmaxes can flip: the mean gap is
    held under 10% of the spread and at most a third of the argmaxes
    move (float32 reads ~1e-6 and none)."""
    sg = _superglue("bfloat16")
    g = torch.Generator().manual_seed(9)
    n = 48
    kp0, d0 = _side(g, 1, n)
    kp1, d1 = _side(g, 1, n)
    num = torch.tensor([n])
    with torch.no_grad():
        z = sg.log_assignment(kp0, d0, num, kp1, d1, num, (H, W))[0]
    want = _reference(sg, kp0[0], d0[0], kp1[0], d1[0])["Z"]
    got_max, got_arg = z[:-1, :-1].max(1)
    ref_max, ref_arg = want[:-1, :-1].max(1)
    spread = float(ref_max.max() - ref_max.min())
    assert float((got_max - ref_max).abs().mean()) < 0.1 * spread
    assert float((got_arg != ref_arg).float().mean()) < 1 / 3


def test_reference_copies_agree():
    """The benchmark's copy of the reference is this file's, and computes
    the same."""
    from port_bench.reference import superglue as bench_copy

    assert (ROOT / "port_bench" / "reference" / "superglue.py").read_text() == \
        (ROOT / "tests" / "plain_superglue.py").read_text()
    sg = _superglue("float32")
    g = torch.Generator().manual_seed(11)
    kp0, d0 = _side(g, 1, 9)
    kp1, d1 = _side(g, 1, 6)
    p = dict(sg.state_dict())
    a = match_pair(p, REF_CFG, kp0[0], d0[0], kp1[0], d1[0], (H, W))
    b = bench_copy.match_pair(p, REF_CFG, kp0[0], d0[0], kp1[0], d1[0], (H, W))
    assert torch.equal(a["Z"], b["Z"]) and torch.equal(a["index"], b["index"])


def _config(**over) -> SuperPointConfig:
    return SuperPointConfig(backbone="vgg", matcher="superglue", image_channels=1,
                            descriptor_dim=256, confidence_thresh=0.005, nms_dist=4,
                            border_remove=4, max_keypoints=32, **over)


@functools.lru_cache(maxsize=None)
def _frontend(device: str, dtype: str) -> SuperPointFrontend:
    cfg = _config(compute_dtype=dtype, superglue=SuperGlueConfig(compute_dtype=dtype))
    fe = SuperPointFrontend(cfg, seed=3, device=device)
    _exercise_batchnorm(fe.matcher, 4)
    return fe


def _frames(calls: int = 3, b: int = 2) -> list:
    return [torch.from_numpy(np.stack([shifted_pair(13, H, W, 4 * (i + j))[1]
                                       for j in range(b)])) for i in range(calls)]


def _empty_key(n: int, device: str):
    return (torch.zeros((n, 256), dtype=torch.float16, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros((n, 3), device=device))


@torch.no_grad()
def test_eager_frame_is_reference_detect_describe_match():
    """The eager SuperGlue frame program, float32, over chained calls with
    the keyframe fed back: its keypoints are the plain reference's detect
    (forward, decode, threshold, exact greedy NMS, border, top N), its
    descriptors the reference's sampling to f16 rounding, and its matches
    and scores the plain SuperGlue's on the program's own keypoints and
    f16 descriptors."""
    from port_bench.reference import models
    from port_bench.reference.frame import keypoints
    from port_bench.reference.precision import QUANT

    fe = _frontend("cpu", "float32")
    cfg = fe.config
    n = cfg.max_keypoints
    weights = {k[:-len(".weight")]: (v, fe.model.state_dict()[k[:-len("weight")] + "bias"])
               for k, v in fe.model.state_dict().items() if k.endswith(".weight")}
    ref_cfg = {"encoder_channels": [64, 64, 128, 128], "cell": 8,
               "confidence_thresh": cfg.confidence_thresh, "nms_dist": cfg.nms_dist,
               "border_remove": cfg.border_remove, "top_n": n, "max_keypoints": n}
    key = _empty_key(n, "cpu")
    p = dict(fe.matcher.state_dict())
    matched = 0
    for x in _frames():
        num, kp, index, desc16, score = fe.frame(x, *key[:2], top_n=n, key_kp=key[2])
        logits, dmap = models.vgg_forward(weights, ref_cfg, x.permute(0, 3, 1, 2).float() / 255,
                                          QUANT["float32"])
        ref = keypoints(models.prob_map(logits, 8), dmap, ref_cfg)
        for b in range(len(x)):
            c = int(num[b])
            assert c == int(ref["valid"][b].sum()) > 0
            assert torch.equal(kp[b, :c, 0], ref["y"][b, :c])
            assert torch.equal(kp[b, :c, 1], ref["x"][b, :c])
            torch.testing.assert_close(kp[b, :c, 2], ref["score"][b, :c], rtol=1e-5, atol=1e-7)
            torch.testing.assert_close(desc16[b, :c].float(), ref["desc"][b, :c],
                                       rtol=0, atol=1e-3)
            kc = int(key[1])
            want = match_pair(p, REF_CFG, kp[b, :c], desc16[b, :c], key[2][:kc],
                              key[0][:kc], (H, W))
            assert torch.equal(index[b, :c].long(), want["index"])
            # float32 summation order moves Z by ~1e-5 of its tens: the
            # score's relative gap
            torch.testing.assert_close(score[b, :c], want["score"], rtol=1e-3, atol=0)
            matched += int((index[b] >= 0).sum())
        key = (desc16[0], num[0], kp[0])
    assert matched > 0


def test_frame_signature_tells_the_matchers_apart():
    x = torch.zeros((2, H, W, 1), dtype=torch.uint8)
    assert frame_signature(x, 32, "superglue") != frame_signature(x, 32)
    assert frame_signature(x, 32, "mnn") == frame_signature(x, 32)


def test_keyframe_keypoints_go_with_the_matcher():
    fe = _frontend("cpu", "float32")
    key = _empty_key(32, "cpu")
    with pytest.raises(ValueError):
        fe.frame(_frames(1)[0], *key[:2], top_n=32)
    mnn = SuperPointFrontend(SuperPointConfig(backbone="vgg", image_channels=1,
                                              descriptor_dim=256, max_keypoints=32),
                             device="cpu")
    with pytest.raises(ValueError):
        mnn.frame(_frames(1)[0], *key[:2], top_n=32, key_kp=key[2])


def test_vgg_extract_and_run():
    """The VGG family through `extract` and `run`, not only `frame`."""
    fe = _frontend("cpu", "float32")
    x = _frames(1, 1)[0][0].float().numpy() / 255.0
    kp, desc = fe.extract(x[None])
    assert desc.shape == (1, 32, 256) and int(kp.valid.sum()) > 0
    pts, d = fe.run(x)
    assert pts.shape[0] == 3 and d.shape == (256, pts.shape[1])


@pytest.mark.cuda
def test_graph_replay_credits_superglue_counts():
    """On the card a SuperGlue frame is one graph replay a call, bit for bit
    the eager program, and each replay credits its pairs and their
    Sinkhorn iterations."""
    device = _device("cuda")
    fe = _frontend(device, "bfloat16")
    n, frames = 32, _frames(4)
    program = FrameProgram(fe.model, fe.config, "packed", n, 2, matcher=fe.matcher).to(device)
    key, want = _empty_key(n, device), []
    with torch.inference_mode():
        for x in frames:
            out = [t.clone() for t in program(x.to(device), *key)]
            want.append(out)
            key = (out[3][0], out[0][0], out[1][0])
    key = _empty_key(n, device)
    fe.frame(frames[0], *key[:2], top_n=n, key_kp=key[2])       # the capture
    before = profiling.counters()
    for i, x in enumerate(frames):
        out = fe.frame(x, *key[:2], top_n=n, key_kp=key[2])
        for o, w in zip(out, want[i]):
            assert torch.equal(o, w), i
        key = (out[3][0], out[0][0], out[1][0])
    gained = profiling.counted_since(before)
    iters = fe.config.superglue.sinkhorn_iterations
    assert gained["frame.replays"] == len(frames)
    assert gained["superglue.pairs"] == 2 * len(frames)
    assert gained["superglue.sinkhorn_iters"] == 2 * len(frames) * iters
    assert gained["kernel.sinkhorn"] == len(frames)


# (B, N, M, valid rows, valid columns): ragged sides, N != M, 0, 1, ragged and
# full counts on both sides, empty sides, bands of padded rows only (N = 200
# with 3 valid), and every columns-a-thread layout of the kernel (M = 9 ...
# 4096: 1, 2, 4, 8 and 16 columns a thread)
RAGGED = [
    (4, 16, 20, (0, 1, 7, 16), (20, 0, 13, 1)),
    (3, 37, 300, (37, 5, 0), (300, 257, 1)),
    (2, 200, 9, (200, 3), (9, 9)),
    (2, 70, 1000, (70, 33), (1000, 999)),
    (2, 33, 1600, (33, 1), (1600, 1024)),
    (1, 5, 4096, (5,), (4096,)),
    (1, 0, 7, (0,), (7,)),
    (1, 6, 0, (6,), (0,)),
]


def _transport_inputs(b, n, m, num0, num1, device, seed=0):
    """Scores at SuperGlue's scale with random weights (a background of
    sd 4, each of the first min(N, M) rows planted at +15 on a column of
    a random permutation), ``bin_score`` 1, prefix masks."""
    g = torch.Generator().manual_seed(seed)
    scores = 4 * torch.randn(b, n, m, generator=g)
    k = min(n, m)
    if k:
        cols = torch.stack([torch.randperm(m, generator=g)[:k] for _ in range(b)])
        scores[:, :k].scatter_add_(2, cols[:, :, None], torch.full((b, k, 1), 15.0))
    valid0 = torch.arange(n) < torch.tensor(num0)[:, None]
    valid1 = torch.arange(m) < torch.tensor(num1)[:, None]
    return (scores.to(device), torch.tensor(1.0, device=device), valid0.to(device),
            valid1.to(device))


def _lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.logsumexp``'s arithmetic, written out: the max, 0 where it is
    infinite, then log(sum(exp(x - max))) + max."""
    mx = x.amax(dim, keepdim=True)
    sh = torch.where(mx.isinf(), 0.0, mx)
    return (x - sh).exp().sum(dim).log() + sh.squeeze(dim)


def _band_schedule(scores, alpha, valid0, valid1, iters):
    """The kernel's schedule in plain float32: u from whole rows; each band
    of `band_layout`'s rows (the last padded past the dustbin with rows at
    u = -inf) takes its columns' logsumexp, and the bands' partials fold
    into v; Z from the last u and v."""
    b, n, m = scores.shape
    rows = sinkhorn.band_layout(m)[1]
    bands = -(-(n + 1) // rows)
    c = torch.cat([torch.cat([scores, alpha.expand(b, n, 1)], 2),
                   alpha.expand(b, 1, m + 1)], 1)
    pad = bands * rows - (n + 1)
    c_pad = torch.cat([c, c.new_zeros(b, pad, m + 1)], 1)
    norm, log_mu, log_nu, v = sinkhorn.marginals(valid0, valid1)
    log_mu_pad = torch.cat([log_mu, log_mu.new_full((b, pad), float("-inf"))], 1)
    for _ in range(iters):
        u = log_mu_pad - _lse(c_pad + v[:, None, :], 2)
        partial = _lse((c_pad + u[:, :, None]).view(b, bands, rows, m + 1), 2)
        v = log_nu - _lse(partial, 1)
    return c + u[:, :n + 1, None] + v[:, None, :] - norm[:, None, None]


def _assert_same_matches(got, want, num0, threshold=0.2):
    """`assign`'s indices agree on every valid row, but where the plain Z
    leaves the choice within the tolerance: its row's or a column's top
    two entries, or its best and log(threshold)."""
    tol = 1e-5 * float(want[want.isfinite()].abs().max())
    i_got, _ = assign(got, num0, threshold)
    i_want, _ = assign(want, num0, threshold)
    core = want[:, :-1, :-1]
    for b, i in (i_got != i_want).nonzero().tolist():
        row = core[b, i]
        near = abs(float(row.max()) - float(np.log(threshold))) <= tol
        if row.numel() > 1:
            top = row.topk(2).values
            near |= float(top[0] - top[1]) <= tol
        for j in {int(i_got[b, i]), int(i_want[b, i]), int(row.argmax())} - {-1}:
            if core.shape[1] > 1:
                top = core[b, :, j].topk(2).values
                near |= float(top[0] - top[1]) <= tol
        assert near, (b, i, int(i_got[b, i]), int(i_want[b, i]))


@pytest.mark.parametrize("case", RAGGED, ids=lambda c: "x".join(map(str, c[:3])))
def test_band_schedule_equals_the_plain_loop(case):
    """The kernel's decomposition (row logsumexps, band partials of the
    column logsumexps folded over the bands, shifts at 0 where a band holds
    only padded rows) gives the plain loop's Z, to
    `chip_smoke.transport_close`'s tolerance."""
    args = _transport_inputs(*case, "cpu")
    want = sinkhorn.log_optimal_transport_plain(*args, 100)
    transport_close(_band_schedule(*args, 100), want, str(case[:3]))


def test_cpu_transport_never_loads_the_kernel(monkeypatch):
    """On the CPU `superglue.log_optimal_transport` is the plain loop: no
    library is loaded (on a card, earlier tests may have loaded it) and
    ``kernel.sinkhorn`` stays where it was."""
    from feature_point_cnn_tpu_torch.models import superglue

    def refuse(name, signatures):
        raise AssertionError(f"{name} loaded on the CPU")

    monkeypatch.setattr(sinkhorn, "load_library", refuse)
    args = _transport_inputs(*RAGGED[0], "cpu")
    before, libs = profiling.counters(), dict(kernels._libs)
    z = superglue.log_optimal_transport(*args, 100)
    assert "kernel.sinkhorn" not in profiling.counted_since(before)
    assert kernels._libs == libs
    assert torch.equal(z, sinkhorn.log_optimal_transport_plain(*args, 100))


# the benchmark's shape: 16 full pairs, then ragged, single and empty sides
CELL = (32, 1024, 1024, (1024,) * 16 + (1000, 731, 1, 0) * 4,
        (1024,) * 16 + (999, 0, 512, 1) * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [CELL] + RAGGED, ids=lambda c: "x".join(map(str, c[:3])))
@torch.inference_mode()
def test_sinkhorn_kernel_equals_the_plain_loop(case):
    """The kernel against the plain loop on the same card inputs, 100
    iterations: `chip_smoke.transport_close`, `assign`'s indices equal but at
    near ties, one ``kernel.sinkhorn`` a call, and the same bits again on
    a second call."""
    device = _device("cuda")
    args = _transport_inputs(*case, device)
    want = sinkhorn.log_optimal_transport_plain(*args, 100)
    before = profiling.counters()
    got = sinkhorn.log_optimal_transport(*args, 100)
    torch.cuda.synchronize()
    assert profiling.counted_since(before) == {"kernel.sinkhorn": 1}
    transport_close(got, want, str(case[:3]))
    if min(case[1], case[2]):     # `assign` takes no empty side
        _assert_same_matches(got, want, args[2].sum(1))
    assert torch.equal(sinkhorn.log_optimal_transport(*args, 100), got)
