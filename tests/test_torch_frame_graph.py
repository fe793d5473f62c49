"""PyTorch port: the serving frame's CUDA graphs (`inference/wrapper.py::
FrameGraph`), held to the eager `FrameProgram`.

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
"""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import shifted_pair
from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.inference.wrapper import (
    FrameProgram,
    SuperPointFrontend,
    frame_signature,
)
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
    b = len(batches[0])
    program = FrameProgram(fe.model, fe.config, "packed", N, b).to(device)
    key, outs = _zero_key(device), []
    with torch.inference_mode():
        for x in batches:
            out = program(x.to(device), *key)[:4]
            out = tuple(t[None] for t in out) if b == 1 else out
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
