"""The benchmark's manifest, its files found by name, its counts and its
imports (CPU only)."""

from __future__ import annotations

import ast
import json
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from port_bench.counts import convs, kernels  # noqa: E402
from port_bench.harness import core  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_manifest_keys_and_names():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for m in BENCH["end_to_end"]:
        assert METRIC_KEYS | {"bound"} <= set(m) <= METRIC_KEYS | {"bound", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert METRIC_KEYS | {"layer", "moves"} <= set(m) <= METRIC_KEYS | {
            "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    """Every cell's configuration, its family's convolution counts,
    traffic, driver, limits and metric readers are files named after them;
    every cell reports set-up, one other end-to-end metric and one
    per-layer metric, and each per-layer metric's ``moves`` is reported in
    the cells that list it."""
    _, cfg, traffic, e2e, layer = core.cell_spec(BENCH, cell)
    assert (HERE / "counts" / f"{cfg['family']}.py").is_file()
    assert convs.family_convs(cfg, 64, 64)
    drv = core.load_module(HERE / "drivers" / f"{traffic['driver']}.py")
    assert hasattr(drv, "Driver")
    limits = core.load_json(HERE / "limits" / f"{cell}.json")
    assert limits and all(v > 0 for v in limits.values())
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e
        assert hasattr(core.load_module(HERE / "metrics" / f"{m['name']}.py"), "read")


def test_convolution_counts_equal_the_hand_counts():
    resnet = json.loads((HERE / "configs" / "resnet.json").read_text())
    vgg = json.loads((HERE / "configs" / "vgg.json").read_text())
    macs = sum(c.macs for c in convs.family_convs(resnet, 480, 640))
    assert round(macs / 1e9, 2) == 8.30
    assert round(sum(c.macs for c in convs.family_convs(vgg, 480, 640)) / 1e9, 2) == 26.05
    assert convs.train_step_flops(resnet, 240, 320, 1) == 6 * convs.forward_flops(
        resnet, 240, 320)


def test_kernel_bounds_at_b32():
    assert round(kernels.bytes_bound_s(kernels.decode_bytes(32, 480, 640)) * 1e3, 4) == 0.0237
    assert round(kernels.bytes_bound_s(kernels.nms_bytes(32, 480, 640)) * 1e3, 4) == 0.0235
    fwd, kind = kernels.desc_loss_bound_s(32, 1200, 128, 2)
    assert kind == "ops" and round(fwd * 1e3, 4) == 0.0477
    assert round(kernels.desc_loss_bound_s(32, 1200, 128, 4)[0] * 1e3, 4) == 0.0953


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(HERE).as_posix()
                                        for p in HERE.rglob("*.py")))
def test_no_banned_imports(path):
    """Compared by whole top-level name: the port's name begins with the
    JAX package's.  The reference imports nothing of the port either."""
    banned = set(core.BANNED)
    if path.startswith("reference/"):
        banned |= {"feature_point_cnn_tpu_torch"}
    for name in _imports(HERE / path):
        top = name.split(".")[0]
        assert top not in banned, f"{path} imports {name}"
        if path.startswith("reference/"):
            assert not name.startswith(("port_bench.drivers", "port_bench.harness")), name
