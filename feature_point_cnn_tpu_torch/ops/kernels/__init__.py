"""Build and load the port's hand-written CUDA kernels.

Each ``feature_point_cnn_tpu_torch/csrc/<name>.cu`` exposes a plain C
launcher.  It is compiled with ``nvcc`` for Hopper (``sm_90a``) at first
use into ``build/torch_kernels/lib<name>-<hash>.so`` (the hash covers the
source and the flags, so an edited source rebuilds) and loaded with
``ctypes``.  A failed build or load raises: no wrapper falls back to its
plain PyTorch version for a CUDA tensor.  Nothing here runs at import
time, so the CPU tests can import every module without ``nvcc``.

Each kernel's entry point, and nothing else, picks by the tensor's device:
the kernel for a CUDA tensor, the plain version called directly for a CPU
one, so that a CPU export holds no ``fpc`` op (`csrc/serve/fpc_ops.cc`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Mapping, Tuple

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("decode_threshold", "grid_nms", "descriptor_loss", "sinkhorn", "conv_epilogue")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source of ``names`` whose library is missing, one
    ``nvcc`` each, all started together.  Returns each fresh build's
    compiler log (``-Xptxas -v``: registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        logs[name] = log
    return logs


def load_library(
    name: str, signatures: Mapping[str, Tuple[object, Tuple[object, ...]]]
) -> ctypes.CDLL:
    """Build ``name`` if needed, load it, and declare each function's
    ``(restype, argtypes)``."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = list(argtypes)
        _libs[name] = lib
    return lib


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
