"""The SuperGlue cell, ``vgg_superglue.match_b32``, at a tiny size on the
CPU past the harness's look for a card: the program in float32 agrees
with the plain reference, and planted matcher faults come out not
correct.  Its files are found by name, and its FLOP counts equal the hand
counts."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from port_bench.harness import core  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "vgg_superglue.match_b32"
# scenes enough that a frame's keyframe is mostly another scene's: where the
# two sides show one scene, cross layers compute what self layers do
TINY = {"height": 64, "width": 96, "scenes": 8, "shifts": [0, 8], "batch": 4,
        "batches_in_rotation": 4, "warmup_calls": 1, "checked_calls": 2}
SEED = 2 ** 31 + 12345          # above 32 signed bits, as the driver's are


def _config() -> dict:
    cfg = core.cell_spec(BENCH, CELL)[1]
    return {"compute_dtype": "float32", "max_keypoints": 96, "top_n": 96,
            "superglue": {**cfg["superglue"], "compute_dtype": "float32"}}


def run(trace=False):
    return core.run_cell(BENCH, CELL, SEED, 1.0, trace, time.time(), device="cpu",
                         overrides=TINY, config_overrides=_config())


def test_float32_program_agrees_with_the_reference():
    """Every compared number far inside its limit; the run names no card,
    reports ``frames_per_s`` and ``setup_s``, and loads nothing banned."""
    r = run()
    assert r["correct"], r["compared"]
    assert set(r["compared"]) == {"kp_mismatch", "score_err", "desc_err", "assign_err",
                                  "best_mismatch"}
    for k, c in r["compared"].items():
        assert c["value"] <= 0.1 * c["limit"], (k, c)
    assert r["attempted"] > 0 and r["device"]["platform"] == "cpu"
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert not core.banned_modules()


def _cross_as_self(monkeypatch):
    from feature_point_cnn_tpu_torch.models import superglue

    real = superglue.AttentionalGNN.__init__

    def init(self, feature_dim, layer_names, num_heads):
        real(self, feature_dim, ("self",) * len(layer_names), num_heads)

    monkeypatch.setattr(superglue.AttentionalGNN, "__init__", init)


def _no_dustbin(monkeypatch):
    """The assignment as a dual softmax of the scores, the dustbin left
    out."""
    import torch

    from feature_point_cnn_tpu_torch.models import superglue

    real = superglue.log_optimal_transport

    def transport(scores, alpha, valid0, valid1, iters):
        z = real(scores, alpha, valid0, valid1, iters)
        inf = float("-inf")
        rows = scores.masked_fill(~valid1[:, None, :], inf).log_softmax(2)
        cols = scores.masked_fill(~valid0[:, :, None], inf).log_softmax(1)
        both = valid0[:, :, None] & valid1[:, None, :]
        z[:, :-1, :-1] = torch.where(both, rows + cols, inf)
        return z

    monkeypatch.setattr(superglue, "log_optimal_transport", transport)


@pytest.mark.parametrize("fault", [_cross_as_self, _no_dustbin],
                         ids=["cross_as_self", "no_dustbin"])
def test_matcher_faults_are_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = run()
    assert not r["correct"], r["compared"]
    assert r["compared"]["assign_err"]["value"] > r["compared"]["assign_err"]["limit"]
    assert r["failed"] > 0


def test_window_counts_the_pairs():
    """The window's dict holds the pairs the counter gained: a pair a
    frame; ``mfu.match`` reads it (a traced run's per-layer line, with a
    trace that holds nothing to read for the other two)."""
    from port_bench.harness import trace

    def fake_traced(fn, host=False):
        out = fn()
        return out, trace.make_trace([trace.Record("k", 0, 10)], [], out["window_s"])

    mp = pytest.MonkeyPatch()
    mp.setattr(trace, "traced", fake_traced)
    try:
        r = run(trace=True)
    finally:
        mp.undo()
    assert r["correct"]
    assert set(r["metrics"]) == {"mfu.match", "device_idle.match"}
    assert r["metrics"]["mfu.match"]["value"] > 0


def test_cell_files_and_counts():
    from port_bench.counts import vgg_superglue

    _, cfg, traffic, e2e, layer = core.cell_spec(BENCH, CELL)
    assert traffic["driver"] == "superglue_frame" and cfg["reduced"] == []
    assert e2e == ["frames_per_s", "setup_s"]
    assert {m["name"] for m in layer} == {"mfu.match", "device_idle.match",
                                          "attention_roofline.match"}
    assert round(vgg_superglue.matcher_flops(cfg, 1024, 1024) / 1e9, 1) == 88.2
    assert round(vgg_superglue.attention_flops(cfg, 1024, 1024) / 1e9, 2) == 38.65
    s = cfg["superglue"]
    assert (s["descriptor_dim"], s["keypoint_encoder"], s["num_heads"],
            s["sinkhorn_iterations"], s["match_threshold"]) == (256, [32, 64, 128, 256], 4,
                                                                100, 0.2)
    assert s["GNN_layers"] == ["self", "cross"] * 9
