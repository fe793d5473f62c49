"""PyTorch port: what of the CUDA kernels' binding can be wrong without a
card, checked on the CPU against the sources' text.

- every ``extern "C"`` function of each `csrc/*.cu` is declared in its
  wrapper's ``_SIGNATURES`` with as many arguments as its C prototype has,
  pointers as ``c_void_p`` (or a ctypes pointer), ``int`` as ``c_int``,
  ``float`` as ``c_float`` (a `ctypes` slip is otherwise found only on the
  card, as a wild pointer);
- the descriptor-loss wrapper's partial-loss and scratch sizes follow the
  constants of `csrc/descriptor_loss.cu`;
- over a grid of shapes, among them every shape the CUDA tests and
  `chip_smoke.py` use: the width the wrapper pads to is whole k-steps, the
  scratch holds whole 16-byte pieces and whole
  tiles (the bulk copies' unit), and the dynamic shared memory that the
  source's own formulas ask for fits an SM's 227 KB (too much shows on the
  card only as a failed launch);
- the Sinkhorn wrapper's band layout follows `csrc/sinkhorn.cu`: columns a
  thread and rows a band for every M, the registers a thread holds, and
  the dynamic shared memory at the band height for N, M up to 2048;
- the convolution epilogue's wrapper follows `csrc/conv_epilogue.cu`: its
  vector width and channel limit, the bias's shared memory within what a
  launch may take unasked, one launch a call and no host round trip.
"""

import ctypes
import re
from pathlib import Path

import pytest

from feature_point_cnn_tpu_torch.ops.kernels import CSRC, SOURCES
from feature_point_cnn_tpu_torch.ops.kernels import (
    conv_epilogue,
    decode,
    descriptor_loss,
    nms,
    sinkhorn,
)

WRAPPERS = {"decode_threshold": decode, "grid_nms": nms,
            "descriptor_loss": descriptor_loss, "sinkhorn": sinkhorn,
            "conv_epilogue": conv_epilogue}
PROTOTYPE = re.compile(r'extern\s+"C"\s+\w+\s+(\w+)\s*\(([^)]*)\)\s*\{', re.S)


def _prototypes(name):
    text = (CSRC / f"{name}.cu").read_text()
    out = {}
    for fn, args in PROTOTYPE.findall(text):
        args = " ".join(args.split())
        out[fn] = [a.strip() for a in args.split(",")] if args else []
    return out


def _constant(text, name):
    m = re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", text)
    assert m, f"constexpr int {name} not found"
    return int(m.group(1))


def test_every_source_has_a_wrapper():
    assert set(SOURCES) == set(WRAPPERS)
    assert {p.stem for p in Path(CSRC).glob("*.cu")} == set(SOURCES)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_signatures_match_the_c_prototypes(name):
    protos = _prototypes(name)
    sigs = WRAPPERS[name]._SIGNATURES
    assert protos and set(protos) == set(sigs)
    for fn, args in protos.items():
        restype, argtypes = sigs[fn]
        assert restype is ctypes.c_int
        assert len(argtypes) == len(args), (fn, len(argtypes), len(args))
        for c_arg, ct in zip(args, argtypes):
            if "*" in c_arg:
                assert ct is ctypes.c_void_p or issubclass(ct, ctypes._Pointer), (fn, c_arg)
            elif c_arg.startswith("float"):
                assert ct is ctypes.c_float, (fn, c_arg)
            else:
                assert c_arg.startswith("int") and ct is ctypes.c_int, (fn, c_arg)


def _dl_source():
    text = (CSRC / "descriptor_loss.cu").read_text()
    consts = {k: _constant(text, k)
              for k in ("kOwn", "kChunk", "kStages", "kMaxDim")}
    assert "constexpr int kCols = kMaxDim;" in text
    consts["kCols"] = consts["kMaxDim"]
    return text, consts


def _smem_floats(text, consts, fn, kdim):
    """The source's own formula `fn(int kdim)` for a kernel's dynamic shared
    memory, evaluated here."""
    m = re.search(rf"size_t {fn}\(int dim\) \{{\s*return (.*?);", text, re.S)
    assert m, fn
    expr = re.sub(r"//[^\n]*", "", m.group(1)).replace("static_cast<size_t>", "")
    return eval(f"({expr})", {"__builtins__": {}}, dict(consts, dim=kdim))


def test_descriptor_loss_sizes_follow_the_source():
    text, k = _dl_source()
    assert descriptor_loss._OWN == k["kOwn"]
    assert descriptor_loss._CHUNK == k["kChunk"]
    assert descriptor_loss._COLS == k["kMaxDim"]
    # the kernels take whole k-steps of 8 columns; the wrapper pads to them
    assert "dim % 8 == 0 && dim <= kMaxDim" in text and descriptor_loss._KSTEP == 8
    assert [descriptor_loss.padded_dim(x) for x in (1, 8, 12, 100, 128)] == \
        [8, 8, 16, 104, 128]
    # the forward sums one partial loss per block of kOwn rows
    assert "b * ((n + kOwn - 1) / kOwn), loss)" in text
    for b, n, dim in ((32, 1200, 128), (2, 195, 8), (1, 16, 8), (3, 135, 128),
                      (2, 140, 12), (1, 135, 100)):
        chunks = -(-n // k["kChunk"])
        kdim = descriptor_loss.padded_dim(dim)
        assert descriptor_loss.partial_size(b, n) == b * -(-n // k["kOwn"])
        # hi and lo of d and wd, rows padded to whole chunks ...
        assert descriptor_loss.scratch_size(b, n, kdim, False) == \
            4 * b * chunks * k["kChunk"] * kdim
        # ... and, for the backward, transposed tiles of kCols x kChunk
        assert descriptor_loss.scratch_size(b, n, kdim, True) == \
            4 * b * chunks * k["kChunk"] * kdim \
            + 4 * b * chunks * k["kCols"] * k["kChunk"]


@pytest.mark.parametrize("n", [1, 16, 48, 128, 135, 140, 195, 1200, 4800])
@pytest.mark.parametrize("dim", [1, 4, 8, 12, 16, 32, 64, 100, 120, 128])
def test_sizes_by_shape_alone(n, dim):
    text, k = _dl_source()
    kdim = descriptor_loss.padded_dim(dim)
    assert kdim % 8 == 0 and dim <= kdim < dim + 8
    fwd = descriptor_loss.scratch_size(2, n, kdim, False)
    bwd = descriptor_loss.scratch_size(2, n, kdim, True)
    # four equal parts (hi, lo of d and of wd), each whole tiles of whole
    # 16-byte pieces: the unit of a bulk copy
    for part in (fwd // 4, (bwd - fwd) // 4):
        assert part > 0 and part % 4 == 0
    assert fwd // 4 % (k["kChunk"] * kdim) == 0
    assert (bwd - fwd) // 4 % (k["kCols"] * k["kChunk"]) == 0
    assert fwd // 4 >= 2 * n * dim      # holds every element of a (2, n, dim) operand
    assert descriptor_loss.partial_size(2, n) * k["kOwn"] >= 2 * n
    for fn in ("smem_floats", "grad_smem_floats"):
        assert 4 * _smem_floats(text, k, fn, kdim) <= 227 * 1024, fn


def test_shapes_in_use_are_within_the_kernels_limit():
    _, k = _dl_source()
    # tests/test_torch_cuda_kernels.py and chip_smoke.py, as (N, D)
    for n, dim in ((48, 32), (128, 16), (140, 8), (135, 128), (195, 128),
                   (195, 8), (16, 8), (1200, 128), (4800, 64), (140, 12),
                   (135, 100)):
        assert 1 <= dim <= k["kMaxDim"] and n >= 1


def test_nms_source_has_no_host_round_trip():
    """One launch a call: the convergence loop runs on the device, so the
    launcher neither synchronises nor copies anything back."""
    text = (CSRC / "grid_nms.cu").read_text()
    for call in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy"):
        assert call not in text, call
    assert "cudaLaunchKernelEx" in text and "cudaLaunchAttributeClusterDimension" in text
    assert text.count("<<<") == 0          # the cluster launch is the only one


def test_nms_layout_follows_the_source():
    text = (CSRC / "grid_nms.cu").read_text()
    assert nms._MAX_CLUSTER == _constant(text, "kMaxCluster")
    assert nms._SMEM_LIMIT == _constant(text, "kSmemLimit") == 232448
    assert nms._SMEM_RESERVE == _constant(text, "kSmemReserve")
    assert nms._STRIP == 32 * _constant(text, "kGroup")
    assert "constexpr int kStrip = 32 * kGroup;" in text
    # the source's shared-memory formula, term by term
    assert "(4 * static_cast<size_t>(rows) * strips_of(w) + 15) / 16 * 16" in text
    assert "(in_shared ? 5 * static_cast<size_t>(rows) * w : 0)" in text
    assert nms._STATE_BYTES == 5
    # the source's rule for the cluster size: bands at least max(r, 1) rows
    assert "h / cluster < (R > 0 ? R : 1)" in text


def _decode_source():
    text = (CSRC / "decode_threshold.cu").read_text()
    return text, {k: _constant(text, k) for k in
                  ("kCell", "kThreads", "kSegCells", "kTilePad", "kBarBytes")}


def test_decode_cell_rows_follow_the_source():
    text, k = _decode_source()
    assert decode._SEG_CELLS == k["kSegCells"] == 80    # one 640-px cell row a block
    assert decode._TILE_PAD == k["kTilePad"]
    assert decode._BAR_BYTES == k["kBarBytes"]
    assert "constexpr int kChannels = kCell * kCell + 1;" in text
    assert decode._CHANNELS == k["kCell"] ** 2 + 1
    assert "const int bulk = wc % 4 == 0" in text
    m = re.search(r"size_t segment_smem_bytes\(int seg\) \{\s*return (.*?);", text, re.S)
    expr = m.group(1).replace("static_cast<size_t>", "").replace("round4", "_round4")
    env = dict(k, kChannels=k["kCell"] ** 2 + 1, _round4=lambda n: (n + 3) // 4 * 4)
    for wc in (1, 2, 11, 80, 160, 240):
        lay = decode.cell_row_layout(wc)
        seg = min(wc, k["kSegCells"])
        assert lay["seg"] == seg and lay["nseg"] == -(-wc // seg)
        assert lay["smem_bytes"] == eval(f"({expr})", {"__builtins__": {}}, dict(env, seg=seg))
        assert lay["smem_bytes"] <= 48 * 1024       # no opt-in attribute needed
        assert lay["bulk"] == (wc % 4 == 0)
        # a segment's logits are whole 16 B runs when they arrive by bulk copy
        if lay["bulk"]:
            assert seg * 65 * 4 % 16 == 0 and k["kSegCells"] % 4 == 0


def _sinkhorn_source():
    text = (CSRC / "sinkhorn.cu").read_text()
    return text, {k: _constant(text, k) for k in
                  ("kThreads", "kSlots", "kMaxCols", "kBlocksPerSm")}


def test_sinkhorn_layout_follows_the_source():
    text, k = _sinkhorn_source()
    assert sinkhorn._THREADS == k["kThreads"] and sinkhorn._SLOTS == k["kSlots"]
    assert sinkhorn._MAX_COLS == k["kMaxCols"]
    assert sinkhorn.MAX_COLUMNS == k["kThreads"] * k["kMaxCols"]
    # the source's rule for a thread's columns and a band's rows
    assert "while (kThreads * cols < m) cols *= 2;" in text
    assert "constexpr int kRows = kSlots / COLS;" in text
    assert "const int bands = (n + 1 + kRows - 1) / kRows;" in text
    assert "m > kThreads * kMaxCols" in text
    # every layout the wrapper can ask for has its instantiation
    for cols in (1, 2, 4, 8, 16):
        assert f"case {cols}: return run<{cols}>(" in text
    m = re.search(r"size_t band_smem_bytes\(int rows\) \{\s*return (.*?);", text, re.S)
    expr = m.group(1).replace("static_cast<size_t>", "")
    env = dict(k, kWarps=k["kThreads"] // 32)
    for n in (0, 1, 15, 16, 100, 1023, 1024, 1025, 2047, 2048):
        for mm in (0, 1, 9, 256, 257, 300, 1000, 1024, 1025, 1600, 2047, 2048):
            cols, rows = sinkhorn.band_layout(mm)
            assert cols * k["kThreads"] >= mm and (cols == 1 or (cols // 2) * k["kThreads"] < mm)
            assert cols <= k["kMaxCols"] and cols * rows == k["kSlots"]
            bands = -(-(n + 1) // rows)
            assert (bands - 1) * rows < n + 1 <= bands * rows
            smem = eval(f"({expr})", {"__builtins__": {}}, dict(env, rows=rows))
            # the blocks an SM holds, within 227 KB, and each under the 48 KB
            # a launch may take without the opt-in attribute
            assert smem <= 48 * 1024 and k["kBlocksPerSm"] * smem <= 232448
    assert sinkhorn.band_layout(1024) == (4, 8)       # the benchmark's shape
    assert eval(f"({expr})", {"__builtins__": {}}, dict(env, rows=8)) == 576
    assert sinkhorn.band_layout(sinkhorn.MAX_COLUMNS) == (16, 2)
    # three blocks an SM, as the source's launch bounds ask
    assert "__launch_bounds__(kThreads, kBlocksPerSm)" in text


def test_sinkhorn_source_has_no_host_round_trip():
    """The launcher queues its 2 * iters + 1 launches and returns: no
    synchronise, no copy, no allocation (the wrapper's scratch lives in a
    captured graph's pool)."""
    text = (CSRC / "sinkhorn.cu").read_text()
    for call in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
                 "cudaMalloc"):
        assert call not in text, call
    assert text.count("<<<") == 3


def test_conv_epilogue_wrapper_follows_the_source():
    """The wrapper's vector width and channel limit are the source's; the
    bias's shared memory (4 B a channel) stays under the 48 KB a launch may
    take without the opt-in attribute for every C the wrapper passes; the
    launcher queues one launch a call, allocates and synchronises nothing."""
    text = (CSRC / "conv_epilogue.cu").read_text()
    assert conv_epilogue._VEC == _constant(text, "kVec")
    assert conv_epilogue.MAX_CHANNELS == _constant(text, "kMaxChannels")
    assert 4 * conv_epilogue.MAX_CHANNELS <= 48 * 1024
    assert "const size_t smem = sizeof(float) * static_cast<size_t>(c);" in text
    assert "vectors > 0x7fffffffLL" in text and conv_epilogue._MAX_VECTORS == 0x7fffffff
    for call in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
                 "cudaMalloc"):
        assert call not in text, call
    assert text.count("<<<") == 3
