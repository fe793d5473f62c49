"""Build the native serving host (`csrc/serve/`), the counterpart of the JAX
package's ``csrc/CMakeLists.txt``.

With ``g++`` by hand, as `ops/kernels/__init__.py::build` builds the
kernels with ``nvcc``: no cmake.  `build` compiles into
``build/torch_serve/<device>-<hash>/`` (the hash covers the sources, the
flags, torch's version and, for the card, the kernel libraries), every
compile started together:

  superpoint_serve   the host (`superpoint_serve.cc`, `camera.cc`) against
                     LibTorch; for ``"cuda"`` also against the op library,
                     with ``--no-as-needed`` so that its static registrars
                     run (the host calls none of its symbols)
  libfpc_ops.so      ``fpc::decode_threshold`` and ``fpc::grid_nms`` for a
                     C++ process (``"cuda"`` only), linked against the two
                     kernel libraries of ``build/torch_kernels/``
  camera_selftest    the frame sources' checks

A ``"cpu"`` host runs CPU packages (``--device cpu``), which hold the plain
versions inline and need no op library.  A failed compile raises.  Nothing
here runs at import time.

    python -m feature_point_cnn_tpu_torch.inference.native [cuda|cpu]

builds and prints the binaries' paths.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List

import torch

from feature_point_cnn_tpu_torch.ops import kernels

SERVE_SRC = kernels.CSRC / "serve"
BUILD_DIR = kernels.BUILD_DIR.parent / "torch_serve"
KERNEL_LIBS = ("decode_threshold", "grid_nms")


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (set CXX); the native host is built "
                           "from source")
    return cxx


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME", "/usr/local/cuda")


def _flags(device: str):
    """(compile flags, link flags) for ``device``."""
    from torch.utils import cpp_extension

    cflags = ["-std=c++20", "-O2", "-fPIC",
              f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
              *(f"-I{p}" for p in cpp_extension.include_paths())]
    libdirs = cpp_extension.library_paths()
    # no-as-needed: the op library and torch_cuda (AOTInductor's CUDA
    # runner) register themselves statically and export nothing the host calls
    ldflags = ["-Wl,--no-as-needed", *(f"-L{d}" for d in libdirs),
               *(f"-Wl,-rpath,{d}" for d in libdirs), "-ltorch", "-ltorch_cpu", "-lc10"]
    if device == "cuda":
        cuda = _cuda_home()
        cflags += ["-DFPC_WITH_CUDA", f"-I{cuda}/include"]
        ldflags += ["-ltorch_cuda", "-lc10_cuda", f"-L{cuda}/lib64",
                    f"-Wl,-rpath,{cuda}/lib64", "-lcudart"]
    return cflags, ldflags


def _run_all(cmds: List[List[str]]) -> None:
    """Run the commands together; raise with the log of the first that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"{' '.join(cmd)}\n{log}"
    if failed:
        raise RuntimeError(f"native build failed:\n{failed}")


def build(device: str = "cuda") -> Dict[str, Path]:
    """Build the host for ``device`` (``"cuda"`` or ``"cpu"``) unless it is
    built; returns ``{"superpoint_serve", "camera_selftest"[,
    "fpc_ops"]: path}``."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu': {device!r}")
    cflags, ldflags = _flags(device)
    kernel_libs = []
    if device == "cuda":
        kernels.build(KERNEL_LIBS)
        kernel_libs = [str(kernels.library_path(n)) for n in KERNEL_LIBS]
    digest = hashlib.sha256()
    for src in sorted(SERVE_SRC.iterdir()):
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join([_cxx(), torch.__version__, *cflags, *ldflags,
                            *kernel_libs]).encode())
    out = BUILD_DIR / f"{device}-{digest.hexdigest()[:16]}"
    products = {"superpoint_serve": out / "superpoint_serve",
                "camera_selftest": out / "camera_selftest"}
    if device == "cuda":
        products["fpc_ops"] = out / "libfpc_ops.so"
    if all(p.exists() for p in products.values()):
        return products

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f"{out.name}.", dir=BUILD_DIR))
    cxx = _cxx()
    # the binaries find their libraries relative to themselves ($ORIGIN), so
    # the directory is built in a temporary one and renamed into place
    _run_all([[cxx, *cflags, "-c", str(SERVE_SRC / f"{name}.cc"), "-o", str(tmp / f"{name}.o")]
              for name in ("superpoint_serve", "camera", "camera_selftest")] + (
        [[cxx, *cflags, "-shared", str(SERVE_SRC / "fpc_ops.cc"),
          "-o", str(tmp / "libfpc_ops.so"), "-Wl,-soname,libfpc_ops.so",
          f"-L{kernels.BUILD_DIR}", *(f"-l:{Path(p).name}" for p in kernel_libs),
          f"-Wl,-rpath,$ORIGIN/../../{kernels.BUILD_DIR.name}", *ldflags]]
        if device == "cuda" else []))
    ops_lib = ["-Wl,--no-as-needed", f"-L{tmp}", "-lfpc_ops", "-Wl,-rpath,$ORIGIN"]
    _run_all([
        [cxx, str(tmp / "superpoint_serve.o"), str(tmp / "camera.o"), "-o",
         str(tmp / "superpoint_serve"), *(ops_lib if device == "cuda" else []), *ldflags],
        [cxx, str(tmp / "camera_selftest.o"), str(tmp / "camera.o"), "-o",
         str(tmp / "camera_selftest")],
    ])
    for obj in tmp.glob("*.o"):
        obj.unlink()
    try:
        tmp.rename(out)
    except OSError:        # built meanwhile by another process
        shutil.rmtree(tmp)
    return products


if __name__ == "__main__":
    for name, path in build(*sys.argv[1:]).items():
        print(f"{name}: {path}")
