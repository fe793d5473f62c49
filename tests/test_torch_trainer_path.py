"""PyTorch port: the trainer on the device-resident data path against the
JAX package's trainer, on the CPU; and the trainer's summaries.

* ``train_steps_per_call`` = 4 and 3 (a tail of one) against 1, as JAX's
  `tests/test_train.py::test_steps_per_call_scan_matches_loop` holds its
  ``lax.scan`` path: parameters within rtol 2e-4 + atol 2e-5 (on the CPU
  the k-step call runs the same eager steps, so they are in fact equal).
* One MagicPoint epoch on a packed split, port `Trainer` against JAX
  `Trainer` from the same initial variables, float32, ``adam_eps = 1``: the
  tolerances of `tests/test_torch_train_step.py` (parameters atol 2e-6 +
  rtol 1e-4, BatchNorm statistics atol 2e-5 + rtol 1e-4).  The label
  tie-break noise is the step's only draw and cannot repeat ``jax.random``'s,
  so every item has at most one point a cell (at x.5 offsets): the noise
  then decides no label on either side.
* The metric writer's files appear (scalars, the model table, the overlay
  image, written through the serving extract), and a summary that fails
  does not stop training.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
from feature_point_cnn_tpu.data.device_store import DeviceBatchLoader as JaxDeviceLoader
from feature_point_cnn_tpu.data.packed import PackedPointDataset as JaxPacked
from feature_point_cnn_tpu.train.trainer import Trainer as JaxTrainer
from tests.test_torch_train_step import _assert_tree_close

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.data.device_store import DeviceBatchLoader
from feature_point_cnn_tpu_torch.data.packed import PackedPointDataset, pack_split
from feature_point_cnn_tpu_torch.train.trainer import Trainer
from feature_point_cnn_tpu_torch.utils import profiling, summary
from feature_point_cnn_tpu_torch.utils.weights import state_dict_from_jax_variables

H, W = 48, 64
KW = dict(train_image_size=(H, W), descriptor_dim=32, compute_dtype="float32",
          lr_schedule="constant", adam_eps=1.0, max_points=16, batch_size=2,
          epochs=1)


@pytest.fixture(scope="module")
def packed_root(tmp_path_factory):
    """10 items: u8-quantized random images, 10 points at most one a cell,
    at x.5 offsets; written as npz items and packed (one gray channel)."""
    root = tmp_path_factory.mktemp("trainer_path")
    rng = np.random.default_rng(0)
    (root / "npz").mkdir()
    for i in range(10):
        image = rng.integers(0, 256, (1, H, W)).astype(np.float32) / 255.0
        cells = rng.choice((H // 8) * (W // 8), 10, replace=False)
        inside = rng.integers(1, 7, (10, 2))
        y = (cells // (W // 8)) * 8 + inside[:, 0] + 0.5
        x = (cells % (W // 8)) * 8 + inside[:, 1] + 0.5
        points = np.stack([x, y, np.ones(10)]).astype(np.float32)
        np.savez_compressed(root / "npz" / f"item_{i}.npz", image=image, points=points)
    pack_split(str(root / "npz"), str(root / "packed" / "train"))
    return root / "packed"


def _loader(root, size=0):
    ds = PackedPointDataset(str(root), "train", size=size)
    return DeviceBatchLoader(ds, 2, KW["max_points"], device="cpu")


@pytest.mark.parametrize("k", [4, 3])
def test_steps_per_call_matches_single_steps(packed_root, tmp_path, k):
    """8 items at batch 2: 4 steps; k = 3 runs one call of 3 and a tail of 1."""
    def run(steps):
        t = Trainer(SuperPointConfig(**KW, train_steps_per_call=steps), "superpoint",
                    _loader(packed_root, 8), None, str(tmp_path / f"k{steps}"),
                    device="cpu", write_statistics=False, log_every=2, seed=3)
        m = t.train_epoch(0)
        return t, m

    one, m1 = run(1)
    many, mk = run(k)
    assert np.isfinite(m1["loss"]) and np.isfinite(mk["loss"])
    assert one.state.step == many.state.step == 4
    assert int(many.state.optimizer.count) == 4
    sd = many.state.model.state_dict()
    for name, v in one.state.model.state_dict().items():
        torch.testing.assert_close(sd[name], v, rtol=2e-4, atol=2e-5, msg=name)
    stacked = many.train_steps(list(many.train_loader.epoch_index_arrays(1))[:2], 1, 0)
    assert stacked["loss"].shape == (2,) and many.state.step == 6


def test_magicpoint_epoch_on_a_packed_split_matches_jax(packed_root, tmp_path):
    jcfg = JaxConfig(**KW)
    jloader = JaxDeviceLoader(JaxPacked(str(packed_root), "train"), 2, KW["max_points"])
    jt = JaxTrainer(jcfg, "magicpoint", jloader, None, str(tmp_path / "jax"),
                    write_statistics=False, log_every=1)
    start = jax.tree_util.tree_map(np.asarray, jax.device_get(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats}))
    tt = Trainer(SuperPointConfig(**KW), "magicpoint", _loader(packed_root), None,
                 str(tmp_path / "port"), device="cpu", write_statistics=False,
                 log_every=1)
    tt.state.model.load_state_dict(state_dict_from_jax_variables(start))
    jm = jt.train_epoch(0)
    tm = tt.train_epoch(0)
    assert tt.state.step == int(jt.state.step) == 5
    for key in ("loss", "f1"):
        np.testing.assert_allclose(tm[key], jm[key], rtol=2e-4, err_msg=key)
    sd = tt.state.model.state_dict()
    params = jax.device_get(jt.state.params)
    _assert_tree_close(sd, params, "params", 1e-4, 2e-6, "param")
    _assert_tree_close(sd, jax.device_get(jt.state.batch_stats), "batch_stats",
                       1e-4, 2e-5, "stat")
    desc0 = state_dict_from_jax_variables(start)["descriptor.layer_in.0.conv1.weight"]
    assert torch.equal(sd["descriptor.layer_in.0.conv1.weight"], desc0)


def test_summaries_are_written_and_a_failing_one_does_not_stop_training(
        packed_root, tmp_path, monkeypatch, capsys):
    t = Trainer(SuperPointConfig(**KW), "magicpoint", _loader(packed_root), _loader(packed_root, 4),
                str(tmp_path / "ck"), device="cpu", log_every=1)
    t.train(1)
    runs = tmp_path / "ck" / "runs"
    lines = [json.loads(x) for x in (runs / "metrics.jsonl").read_text().splitlines()]
    tags = {k for x in lines for k in x if k not in ("t", "step")}
    assert {"train/loss", "train/f1", "train/lr", "test/loss", "test/f1"} <= tags
    assert "total parameters" in (runs / "model_magicpoint_table.txt").read_text()
    image = (runs / "detector_magicpoint_4.ppm").read_bytes()
    assert image.startswith(f"P6\n{W} {H}\n255\n".encode())
    assert len(image) == len(f"P6\n{W} {H}\n255\n") + H * W * 3

    def broken(*args, **kwargs):
        raise RuntimeError("overlay broke")

    monkeypatch.setattr(summary, "keypoint_overlay", broken)
    again = Trainer(SuperPointConfig(**KW), "magicpoint", _loader(packed_root), None,
                    str(tmp_path / "ck2"), device="cpu", log_every=1)
    capsys.readouterr()
    m = again.train_epoch(0)
    assert "summary failed: overlay broke" in capsys.readouterr().out
    assert again.state.step == 5 and np.isfinite(m["loss"])


def test_step_trace_window_writes_a_trace(tmp_path):
    window = profiling.StepTraceWindow(str(tmp_path / "prof"), start=1, stop=2)
    x = torch.ones(8)
    for i in range(4):
        window.tick(i)
        with profiling.annotate("step"):
            x = x * 2
    window.close()
    assert window.path is not None and Path(window.path).is_file()
    assert "step" in Path(window.path).read_text()
