"""PyTorch port: the serving frame's CUDA graphs (`inference/wrapper.py::
FrameGraph`), held to the eager `FrameProgram`, and the frame's seams: the
export's packed ABI over the program, the graph's keyframe buffers and
the mnn matcher.

This file imports neither JAX nor the JAX package, so it runs on a CUDA
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_frame_graph.py -q

On the card `SuperPointFrontend.frame` replays one graph a signature: over
four chained calls, each fed the call before's frame 0 as its keyframe, it
returns what the eager program returns bit for bit, for u8 gray and float
RGB batches of 1 and 3; what a call returned is unchanged after the next;
a signature is captured once; a replay counts one decode and one NMS
launch.  On the CPU (the ``cpu`` cases, and every case here without a
card) ``frame`` captures nothing and returns the eager program's outputs.

On the CPU: `PackedExport` (JAX's packed ABI) returns the batched
program's frame 0 at B = 1 and appends frame 0's keyframe at B > 1; a
`FrameGraph` allocates one static buffer a keyframe tensor its matcher
declares; `MnnMatcher` is `mnn_match` on a frame's rows.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import shifted_pair
from feature_point_cnn_tpu_torch.config import SuperGlueConfig, SuperPointConfig
from feature_point_cnn_tpu_torch.inference.wrapper import (
    FrameGraph,
    FrameProgram,
    PackedExport,
    SuperPointFrontend,
    frame_signature,
)
from feature_point_cnn_tpu_torch.models.superglue import SuperGlue
from feature_point_cnn_tpu_torch.ops.matching import FrameRows, MnnMatcher, mnn_match
from feature_point_cnn_tpu_torch.utils import profiling
from feature_point_cnn_tpu_torch.utils.weights import released_path

H, W, N = 64, 96, 64
CONFIG = SuperPointConfig(max_keypoints=128)


def _device(name: str) -> str:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return name


@functools.lru_cache(maxsize=None)
def _frontend(device: str) -> SuperPointFrontend:
    """One frontend a device for the file, with the released weights."""
    return SuperPointFrontend(CONFIG, weights_path=released_path(), device=device)


def _batches(b: int, kind: str, calls: int = 4) -> list:
    """``calls`` host batches of ``b`` shifted views of one scene: u8 gray,
    or float32 RGB in [0, 1]."""
    out = []
    for i in range(calls):
        frames = np.stack([shifted_pair(7, H, W, 4 * (i + j))[1] for j in range(b)])
        if kind == "f32_rgb":
            frames = np.repeat(frames.astype(np.float32) / 255.0, 3, -1)
        out.append(torch.from_numpy(frames))
    return out


def _zero_key(device: str):
    return (torch.zeros((N, CONFIG.descriptor_dim), dtype=torch.float16, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def _eager(fe: SuperPointFrontend, batches: list, device: str) -> list:
    """The chained calls through a fresh `FrameProgram`, eagerly."""
    program = FrameProgram(fe.model, fe.config, N, fe.matcher)
    key, outs = _zero_key(device), []
    with torch.inference_mode():
        for x in batches:
            out = program(x.to(device), *key)
            outs.append([t.clone() for t in out])
            key = (out[3][0], out[0][0])
    return outs


@pytest.mark.parametrize("kind", ["u8_gray", "f32_rgb"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_frame_equals_the_eager_program(device, b, kind):
    """Chained calls, keyframe fed back: outputs equal bit for bit, held
    by the caller across the next call; one capture on the card and a
    replay a call, none on the CPU."""
    device = _device(device)
    fe = _frontend(device)
    batches = _batches(b, kind)
    want = _eager(fe, batches, device)
    before = profiling.counters()
    key, held = _zero_key(device), []
    for i, x in enumerate(batches):
        out = fe.frame(x, *key, top_n=N)
        for j, (o, w) in enumerate(zip(out, want[i])):
            assert o.dtype == w.dtype and o.shape == w.shape, (i, j)
            assert torch.equal(o, w), (i, j)
        for was, snapshot in held:
            assert all(torch.equal(t, s) for t, s in zip(was, snapshot)), i
        held.append((out, [t.clone() for t in out]))
        key = (out[3][0], out[0][0])
    assert int(want[-1][0].sum()) > 0 and bool((want[-1][2] >= 0).any())
    gained = profiling.counted_since(before)
    graphed = device == "cuda"
    assert gained.get("frame.captures", 0) == (1 if graphed else 0)
    assert gained.get("frame.replays", 0) == (len(batches) if graphed else 0)


def test_frame_signature_tells_inputs_apart():
    """Batch, height, width, channels, image dtype and top_n each give
    another signature; the same input gives the same one."""
    base = torch.zeros((2, H, W, 1), dtype=torch.uint8)
    sig = frame_signature(base, N)
    assert frame_signature(torch.zeros_like(base), N) == sig
    others = [frame_signature(torch.zeros((3, H, W, 1), dtype=torch.uint8), N),
              frame_signature(torch.zeros((2, H + 8, W, 1), dtype=torch.uint8), N),
              frame_signature(torch.zeros((2, H, W + 8, 1), dtype=torch.uint8), N),
              frame_signature(torch.zeros((2, H, W, 3), dtype=torch.uint8), N),
              frame_signature(base.float(), N),
              frame_signature(base, N // 2)]
    assert len({sig, *others}) == 1 + len(others)


@pytest.mark.cuda
def test_signatures_capture_once_and_replays_count_their_kernels():
    """A new signature captures anew and a repeated one replays; each
    replay credits one decode and one NMS launch and one replay."""
    _device("cuda")
    fe = SuperPointFrontend(CONFIG, weights_path=released_path(), device="cuda")
    one, three = _batches(1, "u8_gray", 1)[0], _batches(3, "u8_gray", 1)[0]
    key = _zero_key("cuda")

    def call(x, top_n=N):
        before = profiling.counters()
        fe.frame(x, key[0][:top_n], key[1], top_n=top_n)
        torch.cuda.synchronize()
        return profiling.counted_since(before)

    replay = {"kernel.decode_threshold": 1, "kernel.grid_nms": 1, "frame.replays": 1}
    first = call(one)
    assert first["frame.captures"] == 1 and first["frame.replays"] == 1
    assert call(one) == replay
    assert call(three)["frame.captures"] == 1
    assert call(one, N // 2)["frame.captures"] == 1
    for x in (one, three, one):
        assert call(x) == replay


@pytest.mark.parametrize("kind", ["u8_gray", "f32_rgb"])
@pytest.mark.parametrize("b", [1, 3])
def test_packed_export_is_the_batched_program(b, kind):
    """JAX's packed ABI over the program: at B = 1 the program's frame 0,
    unbatched; at B = 3 the program's outputs and then frame 0's
    ``(desc16, num_valid)``, the next call's keyframe."""
    fe = _frontend("cpu")
    program = FrameProgram(fe.model, fe.config, N, fe.matcher)
    first, x = _batches(b, kind, 2)
    with torch.inference_mode():
        out = program(first, *_zero_key("cpu"))
        key = (out[3][0], out[0][0])
        want = program(x, *key)
        got = PackedExport(program, b)(x, *key)
    assert int(want[0][0]) > 0 and bool((want[2][0] >= 0).any())
    if b == 1:
        assert len(got) == 4
        assert all(torch.equal(g, w[0]) for g, w in zip(got, want))
    else:
        assert len(got) == 6
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert torch.equal(got[4], want[3][0]) and torch.equal(got[5], want[0][0])


@pytest.mark.parametrize("matcher", ["mnn", "superglue"])
def test_graph_keyframe_buffers_follow_the_matcher(matcher):
    """A `FrameGraph` holds one static buffer a keyframe tensor its
    program's matcher declares, of its shape and dtype, beside the image
    buffer (allocated here on the CPU; nothing is captured)."""
    fe = _frontend("cpu")
    d = CONFIG.descriptor_dim
    want = [((N, d), torch.float16), ((), torch.int32)]
    m = fe.matcher
    if matcher == "superglue":
        m = SuperGlue(SuperGlueConfig(descriptor_dim=d, keypoint_encoder=(8,),
                                      gnn_layers=("self",), num_heads=1))
        want.append(((N, 3), torch.float32))
    images = torch.zeros((2, H, W, 1), dtype=torch.uint8)
    graph = FrameGraph(FrameProgram(fe.model, CONFIG, N, m), images, torch.device("cpu"))
    assert [(tuple(t.shape), t.dtype) for t in graph.key] == want
    assert graph.image.shape == images.shape and graph.image.dtype == torch.uint8
    assert graph.graph is None


@pytest.mark.parametrize("key_num", [0, 5, N])
def test_mnn_matcher_is_mnn_match_on_the_rows(key_num):
    """`MnnMatcher.match_frame` is `mnn_match` of the frame's float32 rows
    against the keyframe's float16 descriptors, of which the first
    ``key_num`` are valid, with -1 for no match; the keyframe is frame 0's
    rows, so frame 0 matches exactly when some keyframe row is valid."""
    g = torch.Generator().manual_seed(key_num)
    valid = torch.rand(2, N, generator=g) > 0.3
    valid[0, 0] = True
    desc = F.normalize(torch.randn(2, N, 16, generator=g), dim=-1)
    desc = torch.where(valid[..., None], desc, 0.0)
    rows = FrameRows(valid, torch.zeros(2, N, 3), desc, desc.half(),
                     valid.sum(-1, dtype=torch.int32))
    key = (desc[0].half(), torch.tensor(key_num, dtype=torch.int32))
    (got,) = MnnMatcher(CONFIG.max_keypoints, CONFIG.nn_thresh).match_frame(rows, key, (H, W))
    m = mnn_match(desc, valid, key[0].float(), torch.arange(N) < key_num,
                  max_l2_dist=CONFIG.nn_thresh)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.where(m.valid, m.index, -1))
    assert bool((got[0] >= 0).any()) == (key_num > 0)
