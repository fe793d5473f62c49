"""Runs of every cell at a tiny size on the CPU, past the harness's look for
a card: the program in float32 agrees with the plain reference, and a run
whose timed path is broken underneath comes out not correct.  The same
cells on the card: ``test_port_bench_chip.py``."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from port_bench.harness import core  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY = {"height": 64, "width": 96, "scenes": 2, "shifts": [0, 8],
        "batches_in_rotation": 3, "warmup_calls": 1}
SIZES = {
    "resnet.serve_b32": {**TINY, "batch": 4, "checked_calls": 2},
    "resnet.serve_b1": {**TINY, "batch": 1, "checked_calls": 4},
    "vgg.serve_b32": {**TINY, "batch": 4, "checked_calls": 2},
    "resnet.train_b32": {"height": 64, "width": 80, "batch": 4, "scenes": 8,
                         "steps_per_call": 2, "epochs_in_rotation": 2},
}
SEED = 2 ** 31 + 12345          # above 32 signed bits, as the driver's are
F32 = {"compute_dtype": "float32"}


def run(cell, seconds=0.5, config=F32):
    return core.run_cell(BENCH, cell, SEED, seconds, False, time.time(), device="cpu",
                         overrides=SIZES[cell], config_overrides=config)


def test_every_cell_has_a_tiny_size():
    assert set(SIZES) == {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_float32_program_agrees_with_the_reference(cell):
    """The program computing in float32 stays far inside every limit: the
    reference computes what the program computes.  The run names no card,
    reports the cell's end-to-end metrics, and loads nothing banned."""
    r = run(cell)
    assert r["correct"], r["compared"]
    for k, c in r["compared"].items():
        assert c["value"] <= 0.5 * c["limit"], (k, c)
    assert r["attempted"] > 0 and r["device"]["platform"] == "cpu"
    assert "setup_s" in r["metrics"] and len(r["metrics"]) == 2
    assert not core.banned_modules()


def _frontend_fault(monkeypatch, fault):
    from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend

    real = SuperPointFrontend.frame

    def broken(self, images, key_desc, key_num, top_n=256):
        num, kp, match, desc = (t.clone() for t in real(self, images, key_desc, key_num, top_n))
        b = num.shape[0]
        if fault == "half_batch":
            # the second half of the batch left out (B = 1: the frame)
            half = b // 2
            num[half:], kp[half:], match[half:], desc[half:] = 0, 0.0, -1, 0.0
        else:
            # an answer altered where it is produced: frame 0's keypoints
            # one pixel to the right
            kp[0, :, 1] += 1.0
        return num, kp, match, desc

    monkeypatch.setattr(SuperPointFrontend, "frame", broken)


@pytest.mark.parametrize("cell", ["resnet.serve_b32", "resnet.serve_b1"])
@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_frame_faults_are_not_correct(cell, fault, monkeypatch):
    _frontend_fault(monkeypatch, fault)
    r = run(cell)
    assert not r["correct"], r["compared"]
    assert r["failed"] > 0


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_forward_faults_are_not_correct(fault, monkeypatch):
    from feature_point_cnn_tpu_torch.models.vgg_superpoint import VGGSuperPoint

    real = VGGSuperPoint.forward

    def broken(self, image):
        prob, desc, logits = (t.clone() for t in real(self, image))
        if fault == "half_batch":
            half = prob.shape[0] // 2
            prob[half:], desc[half:], logits[half:] = 0.0, 0.0, 0.0
        else:
            logits[0, 0, 0, 0] += 1.0
        return prob, desc, logits

    monkeypatch.setattr(VGGSuperPoint, "forward", broken)
    assert not run("vgg.serve_b32")["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_train_faults_are_not_correct(fault, monkeypatch):
    from feature_point_cnn_tpu_torch.train.optimizer import Optimizer
    from feature_point_cnn_tpu_torch.train.trainer import Trainer

    if fault == "state_unchanged":
        monkeypatch.setattr(Optimizer, "step", lambda self, grads=None: None)
    else:
        real = Trainer._fused_step

        def half(self, idx, gen):
            return real(self, idx[: idx.shape[0] // 2], gen)

        monkeypatch.setattr(Trainer, "_fused_step", half)
    r = run("resnet.train_b32")
    assert not r["correct"], r["compared"]


def test_no_card_no_result(capsys, monkeypatch):
    """Without a CUDA device ``run.py`` exits with 2 and prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, str(HERE))
    run_py = core.load_module(HERE / "run.py")
    assert run_py.main(["--workload", "resnet.serve_b1", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_traced_run_takes_rates_from_an_untraced_window(monkeypatch):
    """A traced run: an untraced window, then one recording the host too
    (the breakdown's idle gaps), then one recording the device alone (the
    trace's metrics).  The MFU divides by the untraced window; the
    breakdown's device operations come from the device-only trace."""
    from port_bench.counts import peaks
    from port_bench.counts.convs import forward_flops
    from port_bench.harness import trace

    windows, hosts = [], []
    real_load = core.load_module
    drv_path = HERE / "drivers" / "forward.py"
    drv_mod = real_load(drv_path)
    real_window = drv_mod.Driver.window

    def window(self, seconds):
        windows.append(real_window(self, seconds))
        return windows[-1]

    def fake_traced(fn, host=False):
        out = fn()
        hosts.append(host)
        dev = [trace.Record("host_window_kernel" if host else "device_only_kernel", 0, 10)]
        return out, trace.make_trace(dev, [trace.Record("host_op", -5, 50)], out["window_s"])

    monkeypatch.setattr(core, "load_module", lambda p: drv_mod if p == drv_path else real_load(p))
    monkeypatch.setattr(drv_mod.Driver, "window", window)
    monkeypatch.setattr(trace, "traced", fake_traced)
    cell = "vgg.serve_b32"
    r = core.run_cell(BENCH, cell, SEED, 0.3, True, time.time(), device="cpu",
                      overrides=SIZES[cell], config_overrides=F32)
    assert r["correct"] and hosts == [True, False] and len(windows) == 3
    cfg = core.cell_spec(BENCH, cell)[1]
    first = windows[0]
    want = 100.0 * forward_flops(cfg, SIZES[cell]["height"], SIZES[cell]["width"]) * \
        first["frames"] / first["window_s"] / peaks.BF16_FLOPS
    assert r["metrics"]["mfu.forward"]["value"] == pytest.approx(want, rel=1e-12)
    assert [k for k, _ in r["breakdown"]["device_ops"]] == ["device_only_kernel"]
    assert [k for k, _ in r["breakdown"]["idle_gaps"]] == ["host_op"]
    assert r["attempted"] == windows[2]["attempted"]
