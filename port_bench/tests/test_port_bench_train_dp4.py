"""The data-parallel training cell, ``resnet.train_dp4``, at a tiny size on
the CPU: four gloo ranks (this test's child process is rank 0 and starts
the other three), one eager step a call (a graph of the step, with its
all-reduce inside, needs NCCL).  The program in float32 agrees with the
plain reference at the global batch, and every rank ends steps 1-3 with
rank 0's parameters.  The cell runs in a child process: a process group
in the test process would turn on the data group for later tests."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
CELL = "resnet.train_dp4"
TINY = {"height": 64, "width": 80, "batch": 1, "ranks": 4, "scenes": 8,
        "steps_per_call": 1, "epochs_in_rotation": 2}
SEED = 2 ** 31 + 12345

CHILD = """
import json, sys, time
sys.path.insert(0, {root!r})
from port_bench.harness import core
bench = core.load_json(core.ROOT / "BENCHMARK.json")
r = core.run_cell(bench, {cell!r}, {seed}, 0.5, False, time.time(), device="cpu",
                  overrides={tiny!r}, config_overrides={{"compute_dtype": "float32"}})
print(json.dumps(r))
"""


def test_four_gloo_ranks_agree_with_the_reference():
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    code = CHILD.format(root=str(ROOT), cell=CELL, seed=SEED, tiny=TINY)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["compared"]
    for k, c in r["compared"].items():
        assert c["value"] <= 0.5 * c["limit"], (k, c)
    assert set(r["metrics"]) == {"train_images_per_s", "setup_s"}
    # the ranks' parameters after steps 1-3 equal rank 0's
    assert "rank_param_gap=0.0" in out.stderr
    # a call's images count once, globally: 4 ranks x 1
    assert r["attempted"] >= 1
