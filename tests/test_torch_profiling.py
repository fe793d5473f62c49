"""PyTorch port: the tracer (`utils/profiling.py`) on the CPU.

Spans nest with their parents and share a call id under one root; off,
the serving frame records nothing and puts nothing in a profile; a span's
stamps and the profiler's records are on one clock; the frame and the
training call record their parts; spans stay out of exported programs;
an operator's trace turns the tracer on and holds the spans; the counters
count, reset and credit; the buffer drops past its bound.
The replay credit of a captured training step is held on the card by
`tests/test_torch_cuda_kernels.py`.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.inference.wrapper import (
    ExtractProgram,
    SuperPointFrontend,
    graph_ops,
    program_digest,
)
from feature_point_cnn_tpu_torch.utils import profiling

FRAME_PARTS = ["frame.upload", "frame.prep", "frame.forward", "frame.detect",
               "frame.describe", "frame.match"]


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.drain()
    yield
    profiling.drain()


@pytest.fixture(scope="module")
def frontend():
    return SuperPointFrontend(SuperPointConfig(max_keypoints=64, compute_dtype="float32"),
                              device="cpu")


def _frame(fe, b=1):
    images = np.random.default_rng(0).integers(0, 256, (b, 48, 64, 1), dtype=np.uint8)
    key = (torch.zeros((32, 128), dtype=torch.float16), torch.zeros((), dtype=torch.int32))
    return fe.frame(images, *key, top_n=32)


def test_spans_nest_with_parents_and_call_ids():
    with profiling.enabled():
        with profiling.span("a", n=3):
            with profiling.span("a.x"):
                with profiling.span("a.x.y"):
                    pass
            with profiling.span("a.z"):
                pass
        with profiling.span("b"):
            pass
    a, ax, axy, az, b = profiling.drain()
    assert [s.name for s in (a, ax, axy, az, b)] == ["a", "a.x", "a.x.y", "a.z", "b"]
    assert a.attrs == {"n": 3} and ax.attrs == {}
    assert (a.parent, ax.parent, axy.parent, az.parent, b.parent) == (-1, a.id, ax.id, a.id, -1)
    assert {s.call for s in (a, ax, axy, az)} == {a.id} and b.call == b.id != a.id
    assert a.start_ns <= ax.start_ns <= axy.start_ns <= axy.end_ns <= ax.end_ns
    assert ax.end_ns <= az.start_ns <= az.end_ns <= a.end_ns <= b.start_ns
    assert profiling.drain() == []


def test_tracer_off_records_nothing(frontend):
    """Off by default: a frame call records no span, and a profile of it
    (not one the tracer opens) holds no ``frame*`` record."""
    with profiling.span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frame(frontend)
    assert profiling.drain() == []
    assert not [e.name for e in prof.events() if e.name.startswith("frame")]


def test_span_clock_holds_the_profiler_records():
    """A span around ``torch.mm`` holds the profiler's ``aten::mm`` record
    on the epoch clock, with no offset fitted."""
    a = torch.randn(384, 384)
    with profiling.enabled(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mm"):
            torch.mm(a, a)
    (s,) = profiling.drain()
    (mm,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert s.start_ns <= mm.start_ns() <= mm.end_ns() <= s.end_ns


def test_frame_records_its_parts_in_order(frontend):
    with profiling.enabled():
        _frame(frontend, b=2)
        _frame(frontend, b=2)
    spans = profiling.drain()
    assert [s.name for s in spans] == 2 * (["frame"] + FRAME_PARTS)
    for root, parts in ((spans[0], spans[1:7]), (spans[7], spans[8:])):
        assert root.parent == -1 and root.attrs == {"batch": 2}
        assert all(s.parent == root.id and s.call == root.id for s in parts)
        ends = [root.start_ns] + [t for s in parts for t in (s.start_ns, s.end_ns)]
        assert ends == sorted(ends) and ends[-1] <= root.end_ns
    assert spans[0].call != spans[7].call


def test_exported_programs_are_the_same_with_the_tracer_on(frontend):
    """Spans are not recorded while ``torch.export`` traces, so neither
    the frame program nor the extract program changes."""
    image = torch.zeros((1, 48, 64, 3))

    def export_both():
        ep, _ = frontend.native_program((48, 64), top_n=32)
        with torch.no_grad():
            ex = torch.export.export(ExtractProgram(frontend.model, frontend.config).eval(),
                                     (image,))
        return [(graph_ops(p), program_digest(p)) for p in (ep, ex)]

    off = export_both()
    with profiling.enabled():
        on = export_both()
    assert on == off
    assert profiling.drain() == []


def test_operator_trace_turns_the_tracer_on(tmp_path):
    """While ``trace()`` records, spans are on and also ranges in the Chrome
    trace it writes; after it, the tracer is off again."""
    with profiling.trace(str(tmp_path)):
        with profiling.span("traced.range"):
            torch.ones(4).sum()
    (path,) = tmp_path.glob("trace_*.json")
    assert "traced.range" in path.read_text()
    assert [s.name for s in profiling.drain()] == ["traced.range"]
    with profiling.span("after"):
        pass
    assert profiling.drain() == []


def test_counters_count_reset_and_credit():
    profiling.reset_counters()
    assert set(profiling.counters().values()) == {0}
    before = profiling.counters()
    profiling.count("kernel.grid_nms")
    profiling.count("kernel.desc_loss_fwd", 3)
    captured = profiling.counted_since(before)
    assert captured == {"kernel.grid_nms": 1, "kernel.desc_loss_fwd": 3}
    profiling.credit(captured, -1)
    assert profiling.counted_since(before) == {}
    profiling.credit(captured, 4)
    assert profiling.counters()["kernel.desc_loss_fwd"] == 12
    with pytest.raises(KeyError):
        profiling.count("kernel.unknown")
    profiling.reset_counters()
    assert profiling.counters() == before


def test_buffer_drops_and_counts_past_its_bound(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    dropped = profiling.counters()["spans.dropped"]
    with profiling.enabled():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    assert [s.name for s in profiling.drain()] == ["s0", "s1", "s2"]
    assert profiling.counters()["spans.dropped"] == dropped + 2


def test_training_call_records_its_steps(tmp_path):
    """On the CPU a call of k steps runs them eagerly under ``train.call``;
    the tail step is a ``train.step``; ``train.steps`` counts all three."""
    from feature_point_cnn_tpu_torch.data.device_store import DeviceBatchLoader
    from feature_point_cnn_tpu_torch.data.packed import PackedPointDataset, pack_split
    from feature_point_cnn_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(0)
    (tmp_path / "npz").mkdir()
    for i in range(6):
        points = np.stack([rng.uniform(8, 56, 6), rng.uniform(8, 40, 6), np.ones(6)])
        np.savez_compressed(tmp_path / "npz" / f"item_{i}.npz",
                            image=rng.random((1, 48, 64)).astype(np.float32),
                            points=points.astype(np.float32))
    pack_split(str(tmp_path / "npz"), str(tmp_path / "packed" / "train"))
    loader = DeviceBatchLoader(PackedPointDataset(str(tmp_path / "packed"), "train"), 2, 16,
                               device="cpu")
    cfg = SuperPointConfig(train_image_size=(48, 64), compute_dtype="float32", max_points=16,
                           batch_size=2, epochs=1, train_steps_per_call=2)
    t = Trainer(cfg, "magicpoint", loader, None, str(tmp_path / "ck"), device="cpu",
                write_statistics=False, log_every=10)
    before = profiling.counters()
    with profiling.enabled():
        t.train_epoch(0)
    spans = profiling.drain()
    assert [s.name for s in spans] == ["train.call", "train.step"]
    assert all(s.parent == -1 for s in spans)
    assert profiling.counted_since(before) == {"train.steps": 3} and t.state.step == 3
