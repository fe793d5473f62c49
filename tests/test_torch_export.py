"""PyTorch port parity: export and native serving against the JAX export, on
the CPU.

A tiny configuration (48x64, K = 32, top-N 16, float32) with seeded weights
that JAX draws and `utils/weights.py` carries to the port.  For the full,
packed and packed B = 4 ABIs, `SuperPointFrontend.native_program`'s meta
equals JAX's ``export_pjrt`` meta key by key, its specs are the exported
program's own inputs and outputs, and the exported program (`FullExport`,
or `PackedExport` over `FrameProgram`) gives the JAX bundle's outputs on
the same images and keyframe; the bundle runs through the XLA CPU client as
`tests/test_export.py` runs it.  Tolerances: integer outputs equal; >= 99%
of keypoints at the same pixel; coordinates and scores there within 1e-5
(the convolutions sum in another order); descriptors within 1e-3 (one f16
ulp near 1 in the packed ABI).  The u8 gray program is bit-identical to the
f32 RGB one; a program exported from CPU tensors holds no ``fpc`` op (the
native host implements them for CUDA alone).  One AOTInductor compile of
the packed program serves two tests: the loaded package against the
exported module, and the native host built with g++ against the CPU torch
(``--device cpu``) replaying three raw frames, whose ``exec`` lines equal
Python's run of the package.  The op schemas and the NMS layout of the
host's op library equal the Python ones.
"""

import json
import os
import re
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
from feature_point_cnn_tpu.inference.wrapper import SuperPointFrontend as JaxFrontend
from feature_point_cnn_tpu.models.superpoint import init_superpoint
from feature_point_cnn_tpu.utils.weights import save_weights as jax_save_weights

from chip_smoke import host_exec_lines, polygon_scene, replay_exec_lines, shifted_pair
from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.inference import native
from feature_point_cnn_tpu_torch.inference.wrapper import (
    DTYPES,
    ExtractProgram,
    SuperPointFrontend,
    graph_ops,
)
from feature_point_cnn_tpu_torch.ops.kernels import decode, nms

H, W, K, N = 48, 64, 32, 16
JCFG = JaxConfig(train_image_size=(H, W), max_keypoints=K, compute_dtype="float32")
CFG = SuperPointConfig(max_keypoints=K, compute_dtype="float32")
ABIS = [("full", 1), ("packed", 1), ("packed", 4)]
NP_DTYPES = {"f32": np.float32, "f16": np.float16, "s32": np.int32,
             "s16": np.int16, "u8": np.uint8, "pred": np.bool_}
SERVE = native.SERVE_SRC


def _run_bundle(bundle, args):
    """Compile a JAX bundle's StableHLO with the XLA CPU client and execute
    it on ``args``; returns outputs by name (`tests/test_export.py::
    _run_bundle`, with every input given)."""
    from jax._src.lib import _jax, xla_client

    meta = json.loads((bundle / "meta.json").read_text())
    backend = jax.devices("cpu")[0].client
    device_list = _jax.DeviceList(tuple(backend.devices()[:1]))
    executable = backend.compile_and_load(
        (bundle / "module.mlir").read_bytes(), device_list,
        xla_client.CompileOptions(),
    )
    for a, spec in zip(args, meta["inputs"]):
        assert list(a.shape) == spec["shape"] and a.dtype == NP_DTYPES[spec["dtype"]]
    outs = executable.execute_sharded(
        [backend.buffer_from_pyval(a) for a in args]
    ).disassemble_into_single_device_arrays()
    return {spec["name"]: np.asarray(out[0]) for out, spec in zip(outs, meta["outputs"])}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's seeded initialisation, as a `utils/weights.py` snapshot."""
    _, variables = init_superpoint(jax.random.PRNGKey(3), JCFG, (H, W))
    path = tmp_path_factory.mktemp("weights") / "seeded.npz"
    jax_save_weights(str(path), variables)
    return path, variables


@pytest.fixture(scope="module")
def frontend(weights):
    return SuperPointFrontend(CFG, weights_path=str(weights[0]), device="cpu")


def _images(batch, channels=3):
    """The keyframe ``(1, H, W, C)`` and ``batch`` frames, float32: the
    first frame is the keyframe's scene shifted by 8 px, the others other
    scenes."""
    key, moved = shifted_pair(11, H, W, 8)
    frames = [moved] + [shifted_pair(20 + i, H, W, 0)[0] for i in range(batch - 1)]
    f32 = lambda u8: np.repeat(u8.astype(np.float32) / 255.0, channels, -1)
    return f32(key[None]), f32(np.stack(frames))


def _zero_key(meta):
    return [np.zeros(s["shape"], NP_DTYPES[s["dtype"]]) for s in meta["inputs"][1:]]


def _feedback(meta, outs):
    """A bundle's keyframe outputs by name, as the next call's key inputs."""
    if meta["abi"] == "full":
        return [outs["desc"], outs["valid"]]
    if meta["batch"] > 1:
        return [outs["key_desc_out"], outs["key_num_out"]]
    return [outs["desc"], outs["num_valid"]]


def _port_run(ep, meta, args):
    with torch.no_grad():
        outs = ep.module()(*(torch.from_numpy(np.asarray(a)) for a in args))
    return {spec["name"]: t.numpy() for t, spec in zip(outs, meta["outputs"])}


def _assert_frame_outputs(got, want):
    """Integers equal, >= 99% of keypoints the same, coordinates and scores
    there to 1e-5, descriptors to 1e-3."""
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
    ints = [n for n in want if want[n].dtype.kind in "biu"]
    for name in ints:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    if "kp_packed" in want:
        coords, want_c = got["kp_packed"], want["kp_packed"]
    else:
        coords = np.stack([got["y"], got["x"], got["score"]], -1)
        want_c = np.stack([want["y"], want["x"], want["score"]], -1)
    same = (coords[..., :2] == want_c[..., :2]).all(-1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(coords[same], want_c[same], atol=1e-5)
    np.testing.assert_allclose(got["desc"][same].astype(np.float32),
                               want["desc"][same].astype(np.float32), atol=1e-3)


@pytest.fixture(scope="module", params=ABIS, ids=["full", "packed", "packed_b4"])
def abi_pair(request, weights, frontend, tmp_path_factory):
    """The JAX bundle and the port's exported program of one ABI."""
    abi, batch = request.param
    out = tmp_path_factory.mktemp(f"jax_{abi}_b{batch}")
    JaxFrontend(JCFG, variables=weights[1]).export_pjrt(
        str(out), (H, W), abi=abi, top_n=N, batch=batch)
    ep, meta = frontend.native_program((H, W), abi=abi, top_n=N, batch=batch)
    return out, ep, meta


def test_native_meta_equals_jax_meta(abi_pair):
    bundle, _, meta = abi_pair
    want = json.loads((bundle / "meta.json").read_text())
    assert meta.keys() == want.keys()
    for key in want:
        assert meta[key] == want[key], key


def test_exported_frame_program_matches_jax_bundle(abi_pair):
    bundle, ep, meta = abi_pair
    key_img, frames = _images(meta["batch"])
    # the keyframe call at batch B takes the keyframe B times
    key_in = np.repeat(key_img, meta["batch"], 0)
    jkey = _run_bundle(bundle, [key_in] + _zero_key(meta))
    pkey = _port_run(ep, meta, [key_in] + _zero_key(meta))
    _assert_frame_outputs(pkey, jkey)
    feedback = _feedback(meta, jkey)
    want = _run_bundle(bundle, [frames] + feedback)
    got = _port_run(ep, meta, [frames] + feedback)
    _assert_frame_outputs(got, want)
    if meta["abi"] == "packed":
        first = got["match_index"] if meta["batch"] == 1 else got["match_index"][0]
        assert (first >= 0).sum() >= 3   # the shifted frame matches its keyframe


def test_u8_gray_program_matches_f32(frontend):
    """`test_export.py::test_u8_gray_export_matches_f32` for the port: the
    u8 gray program on raw pixels equals the f32 RGB program on the same
    pixels / 255, bit for bit."""
    ep8, meta8 = frontend.native_program((H, W), top_n=N, input_dtype="u8",
                                         input_channels=1)
    ep32, meta32 = frontend.native_program((H, W), top_n=N)
    assert meta8["inputs"][0] == {"name": "image", "shape": [1, H, W, 1], "dtype": "u8"}
    assert meta8["channels"] == 1 and meta8["input_dtype"] == "u8"
    img_u8 = shifted_pair(5, H, W, 0)[0][None]
    img_f32 = np.broadcast_to(img_u8.astype(np.float32) * (1.0 / 255.0), (1, H, W, 3)).copy()
    got8 = _port_run(ep8, meta8, [img_u8] + _zero_key(meta8))
    got32 = _port_run(ep32, meta32, [img_f32] + _zero_key(meta32))
    for name in got32:
        np.testing.assert_array_equal(got8[name], got32[name], err_msg=name)


def test_meta_specs_are_the_exported_signature(abi_pair):
    """``meta.json``'s inputs are the exported program's user inputs, in
    order, and its outputs the names, shapes and dtypes of what the
    program returns on zeros of those inputs."""
    _, ep, meta = abi_pair
    assert [s["name"] for s in meta["inputs"]] == list(ep.graph_signature.user_inputs)
    args = [torch.zeros(s["shape"], dtype=DTYPES[s["dtype"]]) for s in meta["inputs"]]
    with torch.no_grad():
        outs = ep.module()(*args)
    assert len(outs) == len(meta["outputs"])
    for t, spec in zip(outs, meta["outputs"]):
        assert (list(t.shape), t.dtype) == (spec["shape"], DTYPES[spec["dtype"]]), spec["name"]


@pytest.mark.parametrize("program", ["extract", "frame"])
def test_cpu_export_holds_no_kernel_op(frontend, program):
    """A program exported from CPU tensors calls the kernels' plain versions
    (the NMS loop as a ``while_loop``) and no ``fpc`` op, which the native
    host implements for CUDA alone."""
    if program == "extract":
        with torch.no_grad():
            ep = torch.export.export(ExtractProgram(frontend.model, CFG).eval(),
                                     (torch.zeros((1, H, W, 3)),))
    else:
        ep, _ = frontend.native_program((H, W), top_n=N)
    ops = graph_ops(ep)
    assert not [o for o in ops if o.startswith("fpc.")]
    assert any("while_loop" in o for o in ops)


def test_op_schemas_equal_the_op_library():
    """The schemas `torch.library` registers are the strings the native op
    library (`csrc/serve/fpc_ops.cc`) defines, letter for letter."""
    src = (SERVE / "fpc_ops.cc").read_text()
    defs = dict(re.findall(r'm\.def\("(\w+)(\(.*?\) -> .*?)"\);', src))
    assert defs == {"decode_threshold": decode.SCHEMA, "grid_nms": nms.SCHEMA}
    for name, schema in defs.items():
        assert str(getattr(torch.ops.fpc, name).default._schema) == f"fpc::{name}{schema}"


def test_exported_batchnorm_form_is_batchnorm():
    """`BatchNorm2d._exported_eval`, the form a program exported on CUDA
    carries, computes eval BatchNorm: float32 within 1e-5 of the module,
    bf16 activations in and out.  A CPU export keeps BatchNorm itself."""
    from feature_point_cnn_tpu_torch.models.blocks import BatchNorm2d

    g = torch.Generator().manual_seed(3)
    bn = BatchNorm2d(16).eval()
    with torch.no_grad():
        for t, lo in ((bn.weight, 0.1), (bn.running_var, 1e-3)):
            t.copy_(torch.rand(16, generator=g) * 2 + lo)
        bn.bias.copy_(torch.randn(16, generator=g))
        bn.running_mean.copy_(torch.randn(16, generator=g))
        x = (torch.randn(2, 16, 6, 10, generator=g) * 3).contiguous(
            memory_format=torch.channels_last)
        np.testing.assert_allclose(bn._exported_eval(x).numpy(), bn(x).numpy(),
                                   rtol=1e-6, atol=1e-5)
        y = bn._exported_eval(x.to(torch.bfloat16))
        assert y.dtype == torch.bfloat16
        np.testing.assert_allclose(y.float().numpy(), bn(x).numpy(), rtol=2 ** -7, atol=2e-2)
    ep = torch.export.export(bn, (x,))
    assert any("batch_norm" in o for o in graph_ops(ep))
    assert "aten.addcmul.default" not in graph_ops(ep)


@pytest.mark.cuda
def test_cuda_export_carries_the_kernels_batchnorm_arithmetic():
    """On CUDA the exported model holds no BatchNorm operator: every
    BatchNorm is `_exported_eval`'s fused multiply-add."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint

    model = SuperPoint(CFG, generator=torch.Generator().manual_seed(0)).cuda().eval()
    with torch.no_grad():
        ep = torch.export.export(model, (torch.zeros((1, H, W, 3), device="cuda"),))
    ops = graph_ops(ep)
    assert "aten.addcmul.default" in ops
    assert not any("batch_norm" in o for o in ops)


@pytest.fixture(scope="module")
def package(frontend, tmp_path_factory):
    """The packed program compiled once by AOTInductor for the CPU."""
    out = tmp_path_factory.mktemp("native_packed")
    frontend.export_native(str(out), (H, W), top_n=N)
    return out


def test_aoti_package_equals_exported_module(package, frontend):
    from torch._inductor import aoti_load_package

    meta = json.loads((package / "meta.json").read_text())
    ep, want_meta = frontend.native_program((H, W), top_n=N)
    assert meta == want_meta
    loaded = aoti_load_package(str(package / "model.pt2"))
    key_img, frames = _images(1)
    args = [key_img] + _zero_key(meta)
    for _ in range(2):      # the keyframe call, then a frame against it
        with torch.no_grad():
            outs = loaded(*(torch.from_numpy(np.asarray(a)) for a in args))
        got = {spec["name"]: t.numpy() for t, spec in zip(outs, meta["outputs"])}
        _assert_frame_outputs(got, _port_run(ep, meta, args))
        args = [frames, got["desc"], got["num_valid"]]


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    return native.build("cpu")


def test_native_host_replays_python(host, package, tmp_path):
    """The host on three raw frames (``--source frames.raw``) prints the
    exec lines of Python's run of the same package on them."""
    from torch._inductor import aoti_load_package

    meta = json.loads((package / "meta.json").read_text())
    rng = np.random.default_rng(7)
    wide = polygon_scene(rng, H, W + 8)
    frames = np.stack([np.repeat(wide[:, 4 * i:4 * i + W, None], 3, -1)
                       for i in range(3)]).astype(np.float32)
    raw = tmp_path / "frames.raw"
    frames.tofile(raw)
    out = subprocess.run(
        [str(host["superpoint_serve"]), "--model", str(package), "--device", "cpu",
         "--source", str(raw), "--frames", "3"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "steady-state" in out.stdout
    want = replay_exec_lines(aoti_load_package(str(package / "model.pt2")), meta,
                             frames, "cpu")
    assert host_exec_lines(out.stdout) == want
    assert len(want) == 3 and want[1][2] > 0      # the panned frame matches


def test_camera_selftest(host, tmp_path):
    """The frame sources' checks pass; the raw-file round trip writes a file
    of its own under ``$TMPDIR`` and removes it."""
    out = subprocess.run([str(host["camera_selftest"])], capture_output=True,
                         text=True, timeout=60, env={**os.environ, "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert "camera selftest OK" in out.stdout
    assert list(tmp_path.iterdir()) == []


def test_serve_usage_missing_model_and_device(host, package):
    """A bad flag prints usage (exit 2); a missing model directory is a clean
    fatal error (exit 1); the default ``--device cuda`` exits non-zero in a
    host built for the CPU."""
    serve = str(host["superpoint_serve"])
    usage = subprocess.run([serve, "--bogus"], capture_output=True, text=True, timeout=60)
    assert usage.returncode == 2 and "--source" in usage.stderr
    missing = subprocess.run([serve, "--model", "/nonexistent", "--device", "cpu"],
                             capture_output=True, text=True, timeout=60)
    assert missing.returncode == 1 and "FATAL" in missing.stderr
    cuda = subprocess.run([serve, "--model", str(package)], capture_output=True,
                          text=True, timeout=60)
    assert cuda.returncode == 1 and "FATAL" in cuda.stderr


def test_nms_layout_of_the_op_library_equals_python(tmp_path):
    """`csrc/serve/nms_layout.h` (the op library's launch layout) gives
    `nms_layout`'s answers."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    cases = [(480, 640, 4), (240, 320, 4), (1080, 1920, 4), (48, 64, 7), (9, 11, 0),
             (16, 16, 3), (8, 640, 7), (72, 88, 2)]
    src = tmp_path / "layout.cc"
    src.write_text(
        '#include <cstdio>\n#include "nms_layout.h"\nint main() {\n' + "".join(
            f'  {{ auto l = fpc::nms_layout({h}, {w}, {r}); std::printf("%d %ld %ld %d\\n", '
            f'l.cluster, (long)l.rows, (long)l.smem_bytes, (int)l.band_in_shared); }}\n'
            for h, w, r in cases) + "}\n")
    exe = tmp_path / "layout"
    subprocess.run(["g++", "-std=c++20", f"-I{SERVE}", str(src), "-o", str(exe)],
                   check=True, timeout=120)
    got = subprocess.run([str(exe)], capture_output=True, text=True, check=True,
                         timeout=60).stdout.split("\n")
    for (h, w, r), line in zip(cases, got):
        want = nms.nms_layout(h, w, r)
        assert line.split() == [str(want.cluster), str(want.rows_per_band),
                                str(want.smem_bytes), str(int(want.band_in_shared))]
