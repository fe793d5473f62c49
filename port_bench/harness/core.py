"""One run of one cell: set-up, the measured window, the check, the result.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<config>.json``) under a traffic mix (``traffic/<traffic>.json``).
The traffic file names its driver (``drivers/<driver>.py``); every
per-layer metric is read by ``metrics/<name>.py``.  Nothing here knows a
cell, a configuration or a metric by name: a later cell, configuration or
metric is new files and new entries.

Each cell's limits on the numbers its check compares are in
``limits/<workload>.json``, with the readings they were set from in
``PERF.md``.

A driver module defines ``Driver(config, traffic, limits, seed, device)``
with

* ``setup()``: build the program, make its inputs and weights from the
  seed, warm up every shape the window uses; it adds the seconds of each
  part to ``self.parts``, which the run logs;
* ``window(seconds) -> dict``: the measured closed loop, ending in a
  device synchronise; the dict holds ``attempted`` (items served),
  ``e2e`` (each end-to-end metric it can give, by name) and what the
  metric readers read (``frames``, ``steps``, ...);
* ``check() -> dict``: after the window, with the program's state freed,
  the comparison with the plain reference: ``{name: (value, limit)}``, and
  ``failed`` (items judged wrong) under the key ``"failed"``.

A metric reader ``metrics/<name>.py`` defines ``read(ctx) -> float or
None``; ``ctx`` holds the trace and its window's dict (``stats``), the
dict of an untraced window of the same length run just before
(``untraced``), the configuration and the traffic.  A reader that finds nothing returns None and the metric is
left out of the line.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

HERE = Path(__file__).resolve().parents[1]          # port_bench/
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "feature_point_cnn_tpu")
# the traced run traces this much of its window at most: a longer trace
# takes minutes to read back
TRACE_SECONDS = 2.0
# the window that records the host's operations for the breakdown's idle
# gaps, run before the traced window
BREAKDOWN_SECONDS = 1.0


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module from a file whose name may hold dots (``mfu.serve.py``)."""
    name = "port_bench_" + "_".join(path.relative_to(HERE).with_suffix("").parts
                                    ).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list:
    """The banned top-level names in ``sys.modules``, compared whole (the
    port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def cell_spec(bench: dict, workload: str):
    """``(cell, config, traffic, e2e names, per-layer metric entries)``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")

    def mine(m):
        return workload in m.get("workloads", [workload])

    e2e = [m["name"] for m in bench["end_to_end"] if mine(m)]
    layer = [m for m in bench["per_layer"] if mine(m)]
    return cell, config, traffic, e2e, layer


def device_info(count: int) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", overrides: Optional[dict] = None,
             config_overrides: Optional[dict] = None) -> dict:
    """One run of ``workload``; returns the result object.  ``device`` and
    the overrides (keys of the traffic and configuration files) are for the
    harness's own CPU tests, which run a cell at a tiny size; the command
    line gives none of them."""
    import torch

    cell, config, traffic, e2e_names, layer_metrics = cell_spec(bench, workload)
    traffic = {**traffic, **(overrides or {})}
    config = {**config, **(config_overrides or {})}
    drv_mod = load_module(HERE / "drivers" / f"{traffic['driver']}.py")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    drv = drv_mod.Driver(config, traffic, limits, seed, torch.device(device))
    drv.parts = {"start": time.time() - t_start}
    drv.setup()
    setup_s = time.time() - t_start
    log(f"[bench] {workload} seed {seed}: set-up {setup_s:.3f} s, by part "
        + ", ".join(f"{k} {v:.3f}" for k, v in drv.parts.items()))

    # what set-up made stays out of the collector's full passes in the window
    gc.collect()
    gc.freeze()
    tr = host_tr = untraced = None
    if trace:
        from port_bench.harness.trace import traced

        # the profiler slows a host-bound loop even when it records the
        # device alone, so the rates that per-layer metrics divide by come
        # from a window it does not watch
        untraced = drv.window(min(seconds, TRACE_SECONDS))
        host_stats, host_tr = traced(lambda: drv.window(min(seconds, BREAKDOWN_SECONDS)),
                                     host=True)
        stats, tr = traced(lambda: drv.window(min(seconds, TRACE_SECONDS)))
        gc.unfreeze()
        log(f"[trace] untraced: {untraced['e2e']}; device records only: {stats['e2e']}; "
            f"host operations recorded too: {host_stats['e2e']}")
    else:
        stats = drv.window(seconds)
        gc.unfreeze()
    on_card = device != "cpu"
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    metrics: Dict[str, dict] = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if not trace:
        for name in e2e_names:
            value = setup_s if name == "setup_s" else stats["e2e"].get(name)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        ctx = {"trace": tr, "stats": stats, "untraced": untraced, "config": config,
               "traffic": traffic}
        for m in layer_metrics:
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    checks = drv.check()
    failed = int(checks.pop("failed", 0))
    correct = all(v <= lim for v, lim in checks.values())
    dev = device_info(cell["chips"]) if on_card else {
        "platform": "cpu", "kind": "cpu", "count": 0}
    dev["memory_peak_bytes"] = int(peak)
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
    result = {"correct": correct, "attempted": int(stats["attempted"]),
              "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        from port_bench.harness.trace import breakdown

        result["breakdown"] = breakdown(tr, host_tr)
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    del drv
    gc.collect()
    found = banned_modules()
    if found:
        log(f"[bench] banned modules loaded: {found}")
        raise SystemExit(3)
    return result


def print_result(result: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for k, c in result["compared"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        log(f"[check] {k} {c['value']!r} limit {c['limit']!r} {ok}")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
