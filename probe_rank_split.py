"""Do two data-parallel ranks on the CPU ever step apart?

Runs the first MagicPoint step of `tests/test_torch_distributed.py`'s
``magicpoint`` scenario (float64 model, two gloo ranks on loopback, two
threads a rank, each rank in a fresh process) in ``--pairs`` pairs at once
for ``--rounds`` rounds, beside ``--load`` processes that keep the cores
busy, and counts the pairs whose ranks end the step with different
parameters.  For each split it names the parameters that differ, how many
entries, by how much, and where in the tensor they lie.  The step's first
call in a process is the one that split in the whole-suite runs, so every
step here is a first call.

    python probe_rank_split.py --pairs 8 --rounds 15 --load 4     # ~3 min

``--record`` also keeps, on each rank, the first parameter's square root
in the optimizer's update (the input and output of `torch._foreach_sqrt_`,
which the optimizer called on the CPU before it took the root there as
``1 / rsqrt``), and
says for each split where the two ranks' roots differ from identical input.

A rank is this script run with ``--rank``; it needs the test files of the
repository and the JAX package they import (the test batches are drawn by
its helpers).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(port: int, rank: int, work: Path, record: bool) -> None:
    import torch

    torch.set_num_threads(2)
    roots = []
    if record:
        sqrt_ = torch._foreach_sqrt_

        def recording_sqrt_(tensors):
            before = tensors[0].clone()
            sqrt_(tensors)
            roots.append((before.numpy(), tensors[0].clone().numpy()))

        torch._foreach_sqrt_ = recording_sqrt_
    import tests.test_torch_distributed as TD
    from feature_point_cnn_tpu_torch.parallel import distributed
    from feature_point_cnn_tpu_torch.parallel.mesh import batch_sharding

    assert distributed.initialize(f"localhost:{port}", 2, rank, device="cpu")
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    out = TD.run_step("magicpoint", inputs, batch_sharding(distributed.global_mesh(), 4))
    out = {k: v for k, v in out.items() if not k.startswith("metric")}
    for i, (before, after) in enumerate(roots):
        out[f"root_in/{i}"], out[f"root_out/{i}"] = before, after
    np.savez(work / f"rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


def load_main(seconds: float) -> None:
    """A busy process on every core (torch's default thread count), as the
    JAX steps of the test suite's other workers are."""
    import torch

    x = torch.randn(4, 64, 96, 128)
    w = torch.randn(64, 64, 3, 3, requires_grad=True)
    end = time.time() + seconds
    while time.time() < end:
        torch.nn.functional.conv2d(x, w, padding=1).square().sum().backward()


def compare(work: Path) -> list:
    a, b = np.load(work / "rank0.npz"), np.load(work / "rank1.npz")
    out = []
    for k in a.files:
        if not np.array_equal(a[k], b[k]):
            off = np.flatnonzero((a[k] != b[k]).ravel())
            rel = np.abs(a[k] - b[k]) / np.maximum(np.abs(a[k]), np.abs(b[k]))
            out.append({"name": k, "entries": int(off.size), "of": int(a[k].size),
                        "max_abs": float(np.abs(a[k] - b[k]).max()),
                        "max_rel": float(rel.max()),
                        "first": int(off[0]), "last": int(off[-1])})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--load", type=int, default=4, help="busy processes beside the ranks")
    ap.add_argument("--record", action="store_true",
                    help="keep the first parameter's square root of the update")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--work", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--busy", type=float, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.port, args.rank, args.work, args.record)
        return 0
    if args.busy is not None:
        load_main(args.busy)
        return 0

    import torch

    import tests.test_torch_distributed as TD

    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("RANK", None)
    me = [sys.executable, str(Path(__file__).resolve())]
    with tempfile.TemporaryDirectory(prefix="probe_rank_split_") as tmp:
        tmp = Path(tmp)
        torch.save(TD._inputs(), tmp / "inputs.pt")
        load = [subprocess.Popen(me + ["--busy", "36000"], env=env,
                                 stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
                for _ in range(args.load)]
        splits, steps = [], 0
        try:
            for rnd in range(args.rounds):
                runs = []
                for p in range(args.pairs):
                    work = tmp / f"r{rnd}p{p}"
                    work.mkdir()
                    (work / "inputs.pt").symlink_to(tmp / "inputs.pt")
                    port = _free_port()
                    runs.append((work, [subprocess.Popen(
                        me + ["--rank", str(r), "--port", str(port), "--work", str(work)]
                        + (["--record"] if args.record else []),
                        env=env, cwd=REPO, stdout=subprocess.DEVNULL,
                        stderr=subprocess.STDOUT) for r in (0, 1)]))
                for work, procs in runs:
                    for proc in procs:
                        if proc.wait(timeout=600) != 0:
                            raise RuntimeError(f"a rank of {work.name} exited {proc.returncode}")
                    steps += 1
                    diff = compare(work)
                    if diff:
                        splits.append({"pair": work.name, "differ": diff})
                print(f"round {rnd + 1}: {steps} first steps, {len(splits)} split", flush=True)
        finally:
            for proc in load:
                proc.kill()
                proc.wait()
    print(json.dumps({"first_steps": steps, "split": len(splits), "load": args.load,
                      "splits": splits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
