"""Serving front end: image batch -> keypoints + descriptors (+ matches).

Port of `feature_point_cnn_tpu/inference/wrapper.py`: `extract_fn`
(`:33-66`), `adaptation_fn` (`:69-74`), `SuperPointFrontend.extract`/`run`/
`run_with_homography_adaptation` (`:134-199`), and the frame program of
``export_pjrt`` (input prep `:298-307`, full ABI `:311-323`, packed
`:351-387`) as the module `FrameProgram`, which `SuperPointFrontend.frame`
calls eagerly.  `export_program` and `export_native` are ``export_stablehlo``
and ``export_pjrt`` (`:203-440`): `torch.export` of the extract program, and
an AOTInductor package of the frame program with JAX's ``meta.json`` for the
native host (`inference/native.py`, `csrc/serve/`).  `load_state` is `load_variables`
(`:77-95`): weights come from a ``weights/*.npz`` snapshot or from a
directory of the port's checkpoints (`utils/checkpoint.py`); the JAX
package's orbax directories need orbax, and with it JAX, so the port does
not read them.  `SuperPointFrontend.extract_sharded` (`:139-175`) splits a
batch over the ranks of a data mesh (`parallel/mesh.py`): each rank runs
`extract_fn` on its rows and every rank gets the whole batch back;
`SuperPointFrontend.extract_spatial` splits each image along W over a width
mesh instead, which JAX's ``extract_fn`` does on a W-sharded input.

The tracer's spans (`utils/profiling.py`) of a ``frame`` call: ``frame``
(the root, with the batch size), ``frame.upload`` (the host-to-device
copy), ``frame.prep``, and in `extract_fn` ``frame.forward``,
``frame.detect`` (decode, NMS, border, top-K) and ``frame.describe``,
then ``frame.match`` (the top-n rows, the match, the packing).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from feature_point_cnn_tpu_torch.config import HomographyConfig, SuperPointConfig
from feature_point_cnn_tpu_torch.device import resolve_device
from feature_point_cnn_tpu_torch.models.fold import fold_batchnorm
from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
from feature_point_cnn_tpu_torch.ops.descriptors import sample_descriptors
from feature_point_cnn_tpu_torch.ops.detection import (
    Keypoints,
    decode_prob_map,
    extract_keypoints,
    extract_keypoints_from_scores,
    keypoints_to_numpy,
    refine_keypoints,
)
from feature_point_cnn_tpu_torch.ops.kernels import use_kernel
from feature_point_cnn_tpu_torch.ops.kernels.decode import decode_threshold_cuda
from feature_point_cnn_tpu_torch.ops.matching import mnn_match
from feature_point_cnn_tpu_torch.parallel import spatial
from feature_point_cnn_tpu_torch.selflabel.adaptation import (
    Generators,
    homography_adaptation,
)
from feature_point_cnn_tpu_torch.utils import checkpoint as ckpt
from feature_point_cnn_tpu_torch.utils import profiling
from feature_point_cnn_tpu_torch.utils.weights import load_variables


def extract_fn(
    model: SuperPoint, images: torch.Tensor, config: SuperPointConfig
) -> Tuple[Keypoints, torch.Tensor]:
    """Forward -> decode -> NMS -> top-K -> descriptor sampling.

    With the decode kernel on, the thresholded map comes straight from the
    logits and the raw prob map is decoded only for subpixel refinement.
    Under a width group ``images`` is this rank's block of columns, and
    every rank returns the whole image's keypoints and descriptors, as JAX
    computes them on a W-sharded input: the forward and the decode run on
    the block (a cell's decode is its own); the score map, and for
    refinement the raw prob map, are gathered whole by one exact sum each,
    so every rank runs NMS, the border strip and top-K on the same map; the
    descriptor map stays sharded (`sample_descriptors`).
    """
    h, w = images.shape[1], images.shape[2] * spatial.split()[1]
    with profiling.span("frame.forward"):
        logits, desc_map = model.features(images)
    with profiling.span("frame.detect"):
        prob = None
        if use_kernel(config.use_cuda_decode, logits):
            scores = spatial.gather_width(
                decode_threshold_cuda(logits, config.cell, config.confidence_thresh), 2)
            kp = extract_keypoints_from_scores(scores, config)
        else:
            prob = spatial.gather_width(decode_prob_map(logits, config.cell), 2)
            kp = extract_keypoints(prob, config)
        if config.subpixel_refine:
            # refine on the RAW prob map: the thresholded map zeroes
            # sub-threshold neighbours and would bias the fit
            if prob is None:
                prob = spatial.gather_width(decode_prob_map(logits, config.cell), 2)
            kp = refine_keypoints(prob, kp)
    with profiling.span("frame.describe"):
        return kp, sample_descriptors(desc_map, kp, h, w)


def adaptation_prob_fn(model: SuperPoint, config: SuperPointConfig):
    """The probability map adaptation aggregates: ``(M, H, W, 3)`` images
    -> ``(M, H, W)``, through the decode kernel where its gate is on."""
    def prob_fn(x: torch.Tensor) -> torch.Tensor:
        logits, _ = model.features(x, enable_descriptor=False)
        if use_kernel(config.use_cuda_decode, logits):
            # threshold 0 keeps every probability (where(p >= 0, p, 0) = p),
            # so the kernel returns the raw decoded map
            return decode_threshold_cuda(logits, config.cell, 0.0)
        return decode_prob_map(logits, config.cell)

    return prob_fn


def adaptation_fn(
    model: SuperPoint, images: torch.Tensor, gen: Generators,
    config: SuperPointConfig, homo_config: HomographyConfig,
) -> torch.Tensor:
    """Homography adaptation of the model's own probability map: ``(B, H,
    W, 3)`` images -> ``(B, H, W)`` aggregated probabilities."""
    return homography_adaptation(gen, images, adaptation_prob_fn(model, config),
                                 homo_config)


def prep_images(images: torch.Tensor, channels: int) -> torch.Tensor:
    """u8 -> float32 / 255, and gray -> ``channels`` repeated channels."""
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) * (1.0 / 255.0)
    else:
        images = images.to(torch.float32)
    if images.shape[-1] == 1 and channels != 1:
        images = images.expand(*images.shape[:-1], channels)
    return images


def load_state(weights_path: str) -> Tuple[int, Dict[str, torch.Tensor]]:
    """``(step, state_dict)`` on the CPU from a ``.npz`` snapshot (step 0)
    or from the newest ``ckpt_<step>.pt`` of a checkpoint directory (its
    ``"model"`` entry)."""
    if str(weights_path).endswith(".npz"):
        return 0, load_variables(weights_path, device="cpu")
    if not Path(weights_path).is_dir():
        raise FileNotFoundError(f"no .npz snapshot or checkpoint directory at "
                                f"{weights_path}")
    step, state = ckpt.restore_latest(ckpt.checkpoint_manager(weights_path))
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {weights_path}")
    return step, state["model"]


class SuperPointFrontend:
    """Holds the model on one device; ``device=None`` means ``cuda``."""

    def __init__(
        self,
        config: SuperPointConfig = SuperPointConfig(),
        weights_path: Optional[str] = None,
        seed: int = 0,
        device=None,
    ):
        """``weights_path``: a ``weights/*.npz`` snapshot or a checkpoint
        directory (`load_state`); without one the weights are random, drawn
        from ``seed``.  With ``config.fold_bn``
        the BatchNorms are folded into the convolutions here: snapshots
        always keep the live-BN layout (`wrapper.py:117-121`)."""
        self.config = config
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        # the fold reads float32 parameters, as the JAX fold does
        live = SuperPoint(config.replace(fold_bn=False, compute_dtype=(
            "float32" if config.fold_bn else config.compute_dtype)), generator=gen)
        if weights_path is not None:
            step, state = load_state(weights_path)
            live.load_state_dict(state)
            if not str(weights_path).endswith(".npz"):
                print(f"[frontend] loaded checkpoint step {step} from {weights_path}")
        model = live
        if config.fold_bn:
            model = SuperPoint(config, generator=torch.Generator())
            model.load_state_dict(fold_batchnorm(live.state_dict()))
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        self._programs: Dict[Tuple[int, int], FrameProgram] = {}   # frame's, by (B, top_n)

    def _images(self, images) -> torch.Tensor:
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.asarray(images))
        return images.to(self.device)

    @torch.inference_mode()
    def extract(self, images) -> Tuple[Keypoints, torch.Tensor]:
        """``(B, H, W, 3)`` float images in [0, 1] -> ``(Keypoints, desc
        (B, K, D))`` on the frontend's device."""
        images = self._images(images).to(torch.float32)
        return extract_fn(self.model, images, self.config)

    @torch.inference_mode()
    def extract_sharded(self, images, mesh) -> Tuple[Keypoints, torch.Tensor]:
        """`extract` of a ``(B, H, W, 3)`` batch split over ``mesh``: each
        rank runs the whole extract (the decode and NMS kernels included)
        on its ``B / d`` rows, and every rank gets the whole batch's
        keypoints and descriptors back through one exact sum of zero-filled
        buffers a field (`parallel/collectives.py::gather_rows`).  Every
        rank passes the same global batch, as in JAX."""
        from feature_point_cnn_tpu_torch.parallel.collectives import gather_rows
        from feature_point_cnn_tpu_torch.parallel.mesh import batch_sharding

        images = self._images(images).to(torch.float32)
        kp, desc = extract_fn(self.model, images[batch_sharding(mesh, images.shape[0])],
                              self.config)
        return (Keypoints(*(gather_rows(f, mesh.group) for f in kp)),
                gather_rows(desc, mesh.group))

    @torch.inference_mode()
    def extract_spatial(self, images, mesh) -> Tuple[Keypoints, torch.Tensor]:
        """`extract` of a ``(B, H, W, 3)`` batch whose images are split along
        W over the width ``mesh`` (`parallel/mesh.py::make_spatial_mesh`):
        each rank runs the forward and the decode on its ``W / d`` columns,
        and every rank gets the whole batch's keypoints and descriptors back
        (`extract_fn` under `spatial.width_group`).  Every rank passes the
        same global batch, as in JAX.  On a mesh of one rank it is
        `extract`."""
        from feature_point_cnn_tpu_torch.parallel.mesh import shard_images_spatial

        if not isinstance(images, torch.Tensor):
            images = np.asarray(images)
        block = self._images(shard_images_spatial(images, mesh)).to(torch.float32)
        with spatial.width_group(mesh.group):
            return extract_fn(self.model, block, self.config)

    def run(self, img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One ``(H, W, 3)`` image -> ``(points (3, N) [x, y, conf], desc
        (D, N))``, the reference's layout."""
        kp, desc = self.extract(np.asarray(img, np.float32)[None])
        v = kp.valid[0].cpu().numpy()
        return keypoints_to_numpy(kp, 0), desc[0].cpu().numpy()[v].T

    @torch.inference_mode()
    def run_with_homography_adaptation(
        self, images, homo_config: HomographyConfig, gen: Generators
    ) -> List[np.ndarray]:
        """Self-labeling pass: ``(B, H, W, 3)`` images -> the aggregated
        map's keypoints, one ``(3, N)`` ``[x, y, conf]`` array an image.
        ``gen``: one generator shared by the batch, or one an image."""
        images = self._images(images).to(torch.float32)
        prob = adaptation_fn(self.model, images, gen, self.config, homo_config)
        kp = extract_keypoints(prob, self.config)
        return [keypoints_to_numpy(kp, i) for i in range(images.shape[0])]

    @torch.inference_mode()
    def frame(self, images, key_desc, key_num, top_n: int = 256):
        """The packed serving frame (`FrameProgram`, packed ABI): detect +
        describe + match every frame of the batch against one keyframe.

        ``images``: ``(B, H, W, C)`` uint8 (scaled by 1/255 here) or float in
        [0, 1], with C = 3 or 1 (gray, repeated to 3 channels here).
        ``key_desc``: ``(N, D)`` float16 keyframe descriptors, ``key_num``
        its valid row count; N = ``min(top_n, max_keypoints)``.

        Returns ``(num_valid (B,) int32, kp_packed (B, N, 3) float32 [y, x,
        score], match_index (B, N) int32 (-1 = no match), desc16 (B, N, D)
        float16)``.  Keypoints are score-sorted, so the first N rows are the
        top N.  Frame ``b``'s ``(desc16[b], num_valid[b])`` is the next
        keyframe input.
        """
        b = len(images)
        with profiling.span("frame", batch=b):
            with profiling.span("frame.upload"):
                images = self._images(images)
            program = self._programs.get((b, top_n))
            if program is None:
                program = FrameProgram(self.model, self.config, "packed", top_n, b)
                program = self._programs[(b, top_n)] = program.to(self.device)
            key_desc = torch.as_tensor(key_desc, device=self.device)
            key_num = torch.as_tensor(key_num, dtype=torch.int32, device=self.device)
            out = program(images, key_desc, key_num)
            return tuple(t[None] for t in out) if b == 1 else out[:4]

    def export_program(self, path: str, image_size: Tuple[int, int]) -> None:
        """`torch.export.save` of the extract program at ``(1, H, W, C)``
        float32 with the flat-tuple ABI ``(y, x, score, valid, desc)``
        (``export_stablehlo``, JAX `wrapper.py:203-224`); load it with
        `torch.export.load`.  Traced on the frontend's device."""
        h, w = image_size
        image = torch.zeros((1, h, w, self.config.image_channels), device=self.device)
        with torch.no_grad():
            ep = torch.export.export(ExtractProgram(self.model, self.config).eval(),
                                     (image,))
        torch.export.save(ep, path)
        print(f"[frontend] exported program ({h}x{w}) to {path}")

    def native_program(
        self,
        image_size: Tuple[int, int],
        abi: str = "packed",
        top_n: Optional[int] = None,
        batch: int = 1,
        input_dtype: str = "f32",
        input_channels: Optional[int] = None,
    ):
        """``(ExportedProgram, meta)``: `torch.export` of `FrameProgram` on
        the frontend's device, and its ``meta.json`` (JAX's keys, spec names
        and dtype strings, `wrapper.py:226-440`).  The arguments and their
        checks are ``export_pjrt``'s."""
        h, w = image_size
        cfg = self.config
        k, d = cfg.max_keypoints, cfg.descriptor_dim
        if abi not in ("full", "packed"):
            raise ValueError(f"abi must be 'full' or 'packed': {abi!r}")
        if batch != 1 and abi != "packed":
            raise ValueError("batched export is packed-only")
        if input_dtype not in ("f32", "u8"):
            raise ValueError(f"input_dtype must be 'f32' or 'u8': {input_dtype!r}")
        cin = input_channels or cfg.image_channels
        if cin not in (1, cfg.image_channels):
            raise ValueError(f"input_channels must be 1 or {cfg.image_channels}")
        n = min(top_n or 256, k)
        image_spec = {"name": "image", "shape": [batch, h, w, cin], "dtype": input_dtype}
        if abi == "full":
            inputs = [image_spec,
                      {"name": "key_desc", "shape": [k, d], "dtype": "f32"},
                      {"name": "key_valid", "shape": [k], "dtype": "pred"}]
            outputs = [{"name": name, "shape": shape, "dtype": dtype} for name, shape, dtype in (
                ("y", [k], "f32"), ("x", [k], "f32"), ("score", [k], "f32"),
                ("valid", [k], "pred"), ("match_index", [k], "s32"),
                ("match_valid", [k], "pred"), ("desc", [k, d], "f32"))]
        else:
            inputs = [image_spec,
                      {"name": "key_desc", "shape": [n, d], "dtype": "f16"},
                      {"name": "key_num", "shape": [], "dtype": "s32"}]
            lead = [] if batch == 1 else [batch]
            outputs = [{"name": "num_valid", "shape": lead, "dtype": "s32"},
                       {"name": "kp_packed", "shape": lead + [n, 3], "dtype": "f32"},
                       {"name": "match_index", "shape": lead + [n], "dtype": "s32"},
                       {"name": "desc", "shape": lead + [n, d], "dtype": "f16"}]
            if batch > 1:
                outputs += [{"name": "key_desc_out", "shape": [n, d], "dtype": "f16"},
                            {"name": "key_num_out", "shape": [], "dtype": "s32"}]
        program = FrameProgram(self.model, cfg, abi, n, batch).to(self.device).eval()
        example = tuple(torch.zeros(s["shape"], dtype=DTYPES[s["dtype"]], device=self.device)
                        for s in inputs)
        with torch.no_grad():
            ep = torch.export.export(program, example)
        meta = {
            "abi": abi, "batch": batch, "image_size": [h, w], "channels": cin,
            "input_dtype": input_dtype, "max_keypoints": k, "top_n": n,
            "descriptor_dim": d, "inputs": inputs, "outputs": outputs,
        }
        return ep, meta

    def export_native(
        self,
        out_dir: str,
        image_size: Tuple[int, int],
        abi: str = "packed",
        top_n: Optional[int] = None,
        batch: int = 1,
        input_dtype: str = "f32",
        input_channels: Optional[int] = None,
    ) -> None:
        """The frame program for the native host (`csrc/serve/
        superpoint_serve.cc`), ``export_pjrt``'s counterpart with its
        arguments (`native_program`; JAX's docstring explains the ABIs).
        Writes

          <out_dir>/model.pt2   AOTInductor package, compiled for the
                                frontend's device
          <out_dir>/meta.json   JAX's keys, spec names and dtype strings

        On CUDA the package reaches the decode and NMS kernels through the
        ``fpc`` ops (`ops/kernels/`): the exported graph must hold both, or
        this raises.  Packages are cached in ``build/torch_serve/packages/``
        by `program_digest`, the device and torch's version.
        """
        ep, meta = self.native_program(image_size, abi, top_n, batch, input_dtype,
                                       input_channels)
        if self.device.type == "cuda":
            missing = KERNEL_OPS - graph_ops(ep)
            if missing:
                raise RuntimeError(f"the exported frame program does not call {sorted(missing)}")
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        compile_package(ep, out / "model.pt2", self.device)
        (out / "meta.json").write_text(json.dumps(meta, indent=1))
        h, w = image_size
        print(f"[frontend] exported native program ({h}x{w}, abi={abi}) to {out_dir}")


# meta.json's dtype strings (JAX's, `export_pjrt`)
DTYPES = {"f32": torch.float32, "f16": torch.float16, "s32": torch.int32,
          "s16": torch.int16, "u8": torch.uint8, "pred": torch.bool}
KERNEL_OPS = frozenset({"fpc.decode_threshold.default", "fpc.grid_nms.default"})
PACKAGE_CACHE = Path(__file__).resolve().parents[2] / "build" / "torch_serve" / "packages"


class ExtractProgram(nn.Module):
    """`extract_fn` with the flat-tuple ABI ``(y, x, score, valid, desc)``."""

    def __init__(self, model: SuperPoint, config: SuperPointConfig):
        super().__init__()
        self.model, self.config = model, config

    def forward(self, image: torch.Tensor):
        kp, desc = extract_fn(self.model, image, self.config)
        return kp.y, kp.x, kp.score, kp.valid, desc


class FrameProgram(nn.Module):
    """``export_pjrt``'s ``frame_fn`` (JAX `wrapper.py:298-387`): prep the
    ABI image on the device (u8 -> float32 / 255, gray -> the model's
    channels), extract, and match against a fed-back keyframe.

    ``abi="full"`` (``batch`` 1): ``forward(image, key_desc (K, D) f32,
    key_valid (K,) bool) -> (y, x, score, valid, match_index, match_valid,
    desc)`` of the one frame, K wide.  ``abi="packed"``: ``forward(image,
    key_desc (N, D) f16, key_num () int32)`` -> the top ``n`` score-sorted
    rows, ``(num_valid, kp_packed [y, x, score], match_index (-1 = none),
    desc f16)``, unbatched at ``batch`` 1 and batched with ``(key_desc_out,
    key_num_out)``, frame 0's, after them otherwise.
    """

    def __init__(self, model: SuperPoint, config: SuperPointConfig,
                 abi: str = "packed", n: int = 256, batch: int = 1):
        super().__init__()
        self.model, self.config, self.abi, self.batch = model, config, abi, batch
        n = config.max_keypoints if abi == "full" else min(n, config.max_keypoints)
        # the keyframe's row slots, for key_valid = slots < key_num
        self.register_buffer("slots", torch.arange(n), persistent=False)

    def forward(self, image: torch.Tensor, key_desc: torch.Tensor, key: torch.Tensor):
        cfg = self.config
        with profiling.span("frame.prep"):
            image = prep_images(image, cfg.image_channels)
        kp, desc = extract_fn(self.model, image, cfg)
        with profiling.span("frame.match"):
            if self.abi == "full":
                m = mnn_match(desc[0], kp.valid[0], key_desc, key, max_l2_dist=cfg.nn_thresh)
                return kp.y[0], kp.x[0], kp.score[0], kp.valid[0], m.index, m.valid, desc[0]
            n = self.slots.shape[0]
            # keypoints are score-sorted, so the first n rows are the top n
            y, x = kp.y[:, :n], kp.x[:, :n]
            score, valid = kp.score[:, :n], kp.valid[:, :n]
            desc_n = torch.where(valid[..., None], desc[:, :n], 0.0)
            m = mnn_match(desc_n, valid, key_desc.float(), self.slots < key,
                          max_l2_dist=cfg.nn_thresh)
            num_valid = valid.sum(-1, dtype=torch.int32)
            # coordinates stay float32 (f16 spacing is 0.5 px beyond x = 512)
            packed = torch.stack([y, x, score], dim=-1)
            match_index = torch.where(m.valid, m.index, -1).to(torch.int32)
            desc16 = desc_n.to(torch.float16)
            if self.batch == 1:
                return num_valid[0], packed[0], match_index[0], desc16[0]
            return num_valid, packed, match_index, desc16, desc16[0], num_valid[0]


def graph_ops(ep) -> set:
    """The operators an exported program's graph calls, as ``"ns.op.overload"``."""
    return {str(node.target) for node in ep.graph.nodes if node.op == "call_function"}


def program_digest(ep) -> str:
    """A hash of what an exported program computes: its graph, its inputs'
    shapes and types, and its parameters, buffers and constants."""
    h = hashlib.sha256(ep.graph_module.code.encode() + str(ep.graph_signature).encode())
    for node in ep.graph.nodes:
        if node.op == "placeholder":
            h.update(str(node.meta.get("val")).encode())
    for name, value in sorted({**ep.state_dict, **ep.constants}.items()):
        h.update(name.encode())
        if isinstance(value, torch.Tensor):
            h.update(value.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


# Inductor rounds a fused chain of low-precision operations once where
# eager rounds each operation; this makes it round where eager does (and
# fuse no multiply-add it is not asked for), so that a bf16 package
# computes what the eager frame computes (`chip_smoke.py` phase 14 holds
# the live and the folded model's packages to it; BatchNorm's own
# arithmetic: `models/blocks.py::BatchNorm2d._exported_eval`)
INDUCTOR_CONFIGS = {"emulate_precision_casts": True}


def compile_package(ep, path: Path, device: torch.device) -> None:
    """``aoti_compile_and_package`` of ``ep`` into ``path`` with
    `INDUCTOR_CONFIGS`, through a cache keyed by `program_digest`, the
    device's name and torch's version."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    key = hashlib.sha256(f"{program_digest(ep)} {name} {torch.__version__} "
                         f"{sorted(INDUCTOR_CONFIGS.items())}".encode())
    cached = PACKAGE_CACHE / f"{key.hexdigest()[:16]}.pt2"
    if not cached.exists():
        from torch._inductor import aoti_compile_and_package

        PACKAGE_CACHE.mkdir(parents=True, exist_ok=True)
        tmp = cached.with_suffix(f".{os.getpid()}.tmp.pt2")
        aoti_compile_and_package(ep, package_path=str(tmp),
                                 inductor_configs=INDUCTOR_CONFIGS)
        os.replace(tmp, cached)
    shutil.copyfile(cached, path)
