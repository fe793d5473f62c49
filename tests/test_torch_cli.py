"""PyTorch port parity: the command line, the demo, the camera and
checkpoint-directory loading against the JAX package, on the CPU.

The parser has JAX's subcommands, option strings, defaults, types,
choices and required flags (help texts are the port's own);
`config_from_args` gives JAX's config on the same argv.  The demo runs
headless as `tests/test_inference.py::test_demo_headless` does;
`SyntheticCamera` frames equal JAX's exactly at a pinned clock.  A
frontend loaded from a checkpoint directory gives the keypoints of one
loaded from the same weights as ``.npz`` exactly.  The ``train`` and
``export --raw-weights`` subcommand functions run on a tiny packed split
with ``device="cpu"``; ``export --out`` writes the `torch.export` extract
program and ``export --pjrt-out`` the native bundle, as
`tests/test_export.py::test_cli_export_fold_bn_with_raw_weights` runs it.
"""

import argparse
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from feature_point_cnn_tpu import main as jax_main
from feature_point_cnn_tpu.inference import camera as jax_camera

from chip_smoke import write_scene_items
from feature_point_cnn_tpu_torch import main as port_main
from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.data.packed import pack_split
from feature_point_cnn_tpu_torch.inference import camera
from feature_point_cnn_tpu_torch.inference.demo import make_query_image, run_demo
from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend, load_state
from feature_point_cnn_tpu_torch.utils import checkpoint as ckpt
from feature_point_cnn_tpu_torch.utils.weights import load_variables, released_path

CFG = SuperPointConfig(train_image_size=(48, 64), max_keypoints=64,
                       compute_dtype="float32")


def _actions(parser):
    """``{subcommand or "": {dest: (option strings, default, type, choices,
    required)}}``."""
    out = {"": {}}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            for name, sub in a.choices.items():
                out[name] = _actions(sub)[""]
        elif not isinstance(a, argparse._HelpAction):
            out[""][a.dest] = (tuple(a.option_strings), a.default, a.type,
                               a.choices, a.required)
    return out


def test_parser_has_jax_subcommands_flags_and_defaults():
    assert _actions(port_main.build_parser()) == _actions(jax_main.build_parser())


@pytest.mark.parametrize("argv", [
    ["train", "--synthetic-path", "/tmp/x", "--batch-size", "8"],
    ["--conf-thresh", "0.1", "inference", "--weights-path", "w"],
    ["export", "--weights-path", "w"],
    ["--nms-dist", "3", "--max-keypoints", "300", "train", "--coco-path", "c",
     "--microbatch-steps", "2", "--steps-per-call", "4", "--epochs", "3",
     "--descriptor-loss", "hinge_hn", "--photometric-augment"],
])
def test_config_from_args_equals_jax(argv):
    got = port_main.config_from_args(port_main.build_parser().parse_args(argv))
    want = jax_main.config_from_args(jax_main.build_parser().parse_args(argv))
    shared = {f.name for f in dataclasses.fields(got)} & {
        f.name for f in dataclasses.fields(want)}
    assert len(shared) > 30
    for name in sorted(shared):
        assert getattr(got, name) == getattr(want, name), name
    if argv[0] == "train":
        assert got.batch_size == 8
    with pytest.raises(SystemExit):
        port_main.config_from_args(port_main.build_parser().parse_args(
            ["train", "--batch-size", "3", "--microbatch-steps", "2"]))


def test_demo_headless():
    stats = run_demo(None, CFG, source="synthetic", width=64, height=48,
                     max_frames=5, show=False, device="cpu")
    assert stats["frames"] == 5
    assert stats["mean_fps"] > 0


def test_inference_subcommand_through_main(capsys):
    stats = port_main.main(["--H", "48", "--W", "64", "--max-keypoints", "64",
                            "inference", "--weights-path", released_path(),
                            "--max-frames", "3", "--no-show"], device="cpu")
    assert stats["frames"] == 3 and stats["mean_matches"] > 0
    assert "'frames': 3" in capsys.readouterr().out


def test_synthetic_camera_equals_jax_at_a_pinned_clock(monkeypatch):
    clock = iter([100.0, 101.7, 100.0, 101.7])
    monkeypatch.setattr(time, "time", lambda: next(clock))
    port_cam = camera.SyntheticCamera((48, 64))
    port_frame, ok = port_cam.get_frame()
    jax_cam = jax_camera.SyntheticCamera((48, 64))
    jax_frame, jok = jax_cam.get_frame()
    assert ok and jok and port_frame.dtype == np.float32
    np.testing.assert_array_equal(port_frame, jax_frame)
    query = make_query_image(np.repeat(port_frame, 2, axis=1), (64, 48))
    assert query.shape == (48, 64, 3)


def _frontend_keypoints(weights_path):
    fe = SuperPointFrontend(CFG, weights_path=weights_path, device="cpu")
    img = np.random.default_rng(0).random((1, 48, 64, 3)).astype(np.float32)
    return fe.extract(img)


def test_checkpoint_directory_loads_as_the_npz(tmp_path, capsys):
    npz = released_path()
    manager = ckpt.checkpoint_manager(str(tmp_path / "ck"))
    ckpt.save_state(manager, 7, {"model": load_variables(npz, device="cpu"),
                                 "step": 7})
    step, state = load_state(str(tmp_path / "ck"))
    assert step == 7 and all(v.device.type == "cpu" for v in state.values())
    (kp_dir, d_dir), (kp_npz, d_npz) = (_frontend_keypoints(str(tmp_path / "ck")),
                                        _frontend_keypoints(npz))
    out = capsys.readouterr().out
    # the step is printed for a checkpoint directory only, as JAX does
    assert "loaded checkpoint step 7" in out and out.count("loaded checkpoint") == 1
    for f in ("y", "x", "score", "valid"):
        assert torch.equal(getattr(kp_dir, f), getattr(kp_npz, f)), f
    assert torch.equal(d_dir, d_npz)
    with pytest.raises(FileNotFoundError):
        load_state(str(tmp_path / "missing"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        load_state(str(tmp_path / "empty"))


@pytest.fixture(scope="module")
def packed_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    write_scene_items(root / "npz" / "train", 0, 4, 48, 64)
    write_scene_items(root / "npz" / "test", 1, 2, 48, 64)
    for split in ("train", "test"):
        pack_split(str(root / "npz" / split), str(root / "packed" / split))
    return root


def _run(argv, device="cpu"):
    opt = port_main.build_parser().parse_args(argv)
    return port_main.RUN[opt.run_mode](opt, port_main.config_from_args(opt), device)


def test_train_and_export_subcommands_on_a_tiny_packed_split(packed_split, tmp_path):
    data = str(packed_split / "packed")
    mp, joint = str(tmp_path / "mp"), str(tmp_path / "joint")
    common = ["--batch-size", "2", "--epochs", "1"]
    _run(["--no-write-statistics", "train", "--synthetic-path", data,
          "--checkpoint-path", mp] + common)
    assert ckpt.checkpoint_manager(mp).all_steps() == [0]
    _run(["--no-write-statistics", "train", "--coco-path", data,
          "--magic-point-weights", mp, "--checkpoint-path", joint] + common)
    step, joint_state = load_state(joint)
    _, mp_state = load_state(mp)
    assert step == 0
    # the MagicPoint encoder was grafted and then trained on: it moved
    assert not torch.equal(joint_state["encoder.conv1.weight"],
                           mp_state["encoder.conv1.weight"])

    raw = str(tmp_path / "w.npz")
    _run(["export", "--weights-path", joint, "--raw-weights", raw, "--fold-bn",
          "--out", str(tmp_path / "extract.pt2")])
    kp_dir, d_dir = _frontend_keypoints(joint)
    kp_npz, d_npz = _frontend_keypoints(raw)
    for f in ("y", "x", "score", "valid"):
        assert torch.equal(getattr(kp_dir, f), getattr(kp_npz, f)), f
    assert torch.equal(d_dir, d_npz)


def test_export_routes_that_are_not_ported_exit_naming_item_7(tmp_path):
    """The export routes that exited naming ROADMAP §1 item 7 now write:
    ``--out`` the extract program, which `torch.export.load` reads back and
    which gives the frontend's keypoints; ``train`` without data still
    exits."""
    prog = tmp_path / "extract.pt2"
    _run(["--H", "48", "--W", "64", "--max-keypoints", "64", "export",
          "--weights-path", released_path(), "--out", str(prog)])
    img = np.random.default_rng(1).random((1, 48, 64, 3)).astype(np.float32)
    with torch.no_grad():
        y, x, score, valid, desc = torch.export.load(str(prog)).module()(
            torch.from_numpy(img))
    fe = SuperPointFrontend(SuperPointConfig(max_keypoints=64),
                            weights_path=released_path(), device="cpu")
    kp, want_desc = fe.extract(img)
    assert valid.shape == (1, 64) and desc.shape == (1, 64, 128)
    for got, want in ((y, kp.y), (x, kp.x), (score, kp.score), (valid, kp.valid),
                      (desc, want_desc)):
        assert torch.equal(got, want)
    with pytest.raises(SystemExit, match="--synthetic-path or --coco-path"):
        _run(["train"])


def test_cli_export_native_fold_bn_with_raw_weights(tmp_path):
    """`export --pjrt-out --fold-bn --raw-weights`
    (`tests/test_export.py::test_cli_export_fold_bn_with_raw_weights`): the
    bundle loads and runs at its meta's shapes, and the portable snapshot
    keeps the live-BatchNorm topology."""
    from torch._inductor import aoti_load_package

    from feature_point_cnn_tpu_torch.inference.wrapper import DTYPES
    from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
    from feature_point_cnn_tpu_torch.utils.weights import save_weights

    model = SuperPoint(CFG, generator=torch.Generator().manual_seed(0))
    src, out, snap = tmp_path / "src.npz", tmp_path / "bundle", tmp_path / "snap.npz"
    save_weights(str(src), model.state_dict())
    _run(["--H", "48", "--W", "64", "--max-keypoints", "32", "export",
          "--weights-path", str(src), "--pjrt-out", str(out), "--abi", "packed",
          "--top-n", "8", "--fold-bn", "--raw-weights", str(snap)])
    meta = json.loads((out / "meta.json").read_text())
    assert meta["top_n"] == 8 and meta["max_keypoints"] == 32
    loaded = aoti_load_package(str(out / "model.pt2"))
    args = [torch.zeros(s["shape"], dtype=DTYPES[s["dtype"]]) for s in meta["inputs"]]
    outs = loaded(*args)
    assert [list(t.shape) for t in outs] == [s["shape"] for s in meta["outputs"]]
    assert any(k.endswith("running_mean") for k in load_variables(str(snap), device="cpu"))
