"""Serving front end: image batch -> keypoints + descriptors (+ matches).

Port of `feature_point_cnn_tpu/inference/wrapper.py`: `extract_fn`
(`:33-66`), `adaptation_fn` (`:69-74`), `SuperPointFrontend.extract`/`run`/
`run_with_homography_adaptation` (`:134-199`), and the frame program of
``export_pjrt`` (prep `:298-307`, packed `:351-387`) as the batched module
`FrameProgram`, which `SuperPointFrontend.frame` serves.  `export_program`
and `export_native` are ``export_stablehlo`` and ``export_pjrt``
(`:203-440`): `torch.export` of the extract program, and an AOTInductor
package of the frame program in JAX's ABIs (`FullExport`, `PackedExport`)
with JAX's ``meta.json``, for the native host (`inference/native.py`,
`csrc/serve/`).  `load_state` is `load_variables`
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
then ``frame.match`` (the top-n rows, the match, the packing; with the
SuperGlue matcher its spans ``superglue.encode``, ``.gnn`` and
``.sinkhorn`` inside).  On the card ``frame`` replays a CUDA graph of the
frame program (`FrameGraph`): a replayed call records ``frame``,
``frame.upload`` and ``frame.replay`` only, since the program's own spans
run at its capture alone.

The frontend builds the detector that ``config.backbone`` names (the
ResNet SuperPoint or magicleap's VGG SuperPoint, whose ``features`` give
`extract_fn` the same layouts) and the matcher ``config.matcher`` names
(`ops/matching.py::MnnMatcher`, `models/superglue.py`), which declares
its keyframe tensors (``keyframe``) and its outputs beyond the frame's four
(``extra_outputs``): nothing else here knows a matcher by name.
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
from feature_point_cnn_tpu_torch.models.superglue import SuperGlue
from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
from feature_point_cnn_tpu_torch.models.vgg_superpoint import VGGSuperPoint
from feature_point_cnn_tpu_torch.ops.descriptors import sample_descriptors
from feature_point_cnn_tpu_torch.ops.detection import (
    Keypoints,
    decode_prob_map,
    extract_keypoints,
    extract_keypoints_from_scores,
    keypoints_to_numpy,
    refine_keypoints,
)
from feature_point_cnn_tpu_torch.ops.kernels.decode import decode_threshold_cuda
from feature_point_cnn_tpu_torch.ops.matching import FrameRows, MnnMatcher, mnn_match
from feature_point_cnn_tpu_torch.parallel import spatial
from feature_point_cnn_tpu_torch.selflabel.adaptation import (
    Generators,
    homography_adaptation,
)
from feature_point_cnn_tpu_torch.utils import checkpoint as ckpt
from feature_point_cnn_tpu_torch.utils import profiling
from feature_point_cnn_tpu_torch.utils.weights import (
    load_variables,
    load_weights,
    vgg_state_dict_from_jax_variables,
)


def extract_fn(
    model: SuperPoint, images: torch.Tensor, config: SuperPointConfig
) -> Tuple[Keypoints, torch.Tensor]:
    """Forward -> decode -> NMS -> top-K -> descriptor sampling.

    The thresholded map comes straight from the logits (the decode kernel
    on the card), and the raw prob map is decoded only for subpixel
    refinement.
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
        scores = spatial.gather_width(
            decode_threshold_cuda(logits, config.cell, config.confidence_thresh), 2)
        kp = extract_keypoints_from_scores(scores, config)
        if config.subpixel_refine:
            # refine on the RAW prob map: the thresholded map zeroes
            # sub-threshold neighbours and would bias the fit
            prob = spatial.gather_width(decode_prob_map(logits, config.cell), 2)
            kp = refine_keypoints(prob, kp)
    with profiling.span("frame.describe"):
        return kp, sample_descriptors(desc_map, kp, h, w)


def adaptation_prob_fn(model: SuperPoint, config: SuperPointConfig):
    """The probability map adaptation aggregates: ``(M, H, W, 3)`` images
    -> ``(M, H, W)``, through the decode kernel on the card."""
    def prob_fn(x: torch.Tensor) -> torch.Tensor:
        logits, _ = model.features(x, enable_descriptor=False)
        # threshold 0 keeps every probability (where(p >= 0, p, 0) = p), so
        # the decode returns the raw map
        return decode_threshold_cuda(logits, config.cell, 0.0)

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


def load_state(weights_path: str, backbone: str = "resnet"
               ) -> Tuple[int, Dict[str, torch.Tensor]]:
    """``(step, state_dict)`` on the CPU from a ``.npz`` snapshot (step 0)
    of the ``backbone``'s JAX variables or from the newest
    ``ckpt_<step>.pt`` of a checkpoint directory (its ``"model"`` entry)."""
    if str(weights_path).endswith(".npz"):
        if backbone == "vgg":
            return 0, vgg_state_dict_from_jax_variables(load_weights(weights_path))
        return 0, load_variables(weights_path, device="cpu")
    if not Path(weights_path).is_dir():
        raise FileNotFoundError(f"no .npz snapshot or checkpoint directory at "
                                f"{weights_path}")
    step, state = ckpt.restore_latest(ckpt.checkpoint_manager(weights_path))
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {weights_path}")
    return step, state["model"]


class SuperPointFrontend:
    """Holds the model and the frame's matcher on one device;
    ``device=None`` means ``cuda``."""

    def __init__(
        self,
        config: SuperPointConfig = SuperPointConfig(),
        weights_path: Optional[str] = None,
        seed: int = 0,
        device=None,
    ):
        """``weights_path``: a ``weights/*.npz`` snapshot or a checkpoint
        directory (`load_state`) of ``config.backbone``'s model; without one
        the weights are random, drawn from ``seed``.  With ``config.fold_bn``
        the BatchNorms are folded into the convolutions here: snapshots
        always keep the live-BN layout (`wrapper.py:117-121`).  The
        SuperGlue matcher's weights are random, drawn after the model's; its
        parameters carry the published names, so ``self.matcher``'s
        ``load_state_dict`` takes a published state dict."""
        self.config = config
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        if config.backbone == "vgg":
            if config.fold_bn:
                raise ValueError("the VGG SuperPoint has no BatchNorm to fold")
            live = VGGSuperPoint(config, generator=gen)
        else:
            # the fold reads float32 parameters, as the JAX fold does
            live = SuperPoint(config.replace(fold_bn=False, compute_dtype=(
                "float32" if config.fold_bn else config.compute_dtype)), generator=gen)
        if weights_path is not None:
            step, state = load_state(weights_path, config.backbone)
            live.load_state_dict(state)
            if not str(weights_path).endswith(".npz"):
                print(f"[frontend] loaded checkpoint step {step} from {weights_path}")
        model = live
        if config.fold_bn:
            model = SuperPoint(config, generator=torch.Generator())
            model.load_state_dict(fold_batchnorm(live.state_dict()))
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        self.matcher = (SuperGlue(config.superglue, generator=gen) if config.matcher == "superglue"
                        else MnnMatcher(config.max_keypoints, config.nn_thresh)
                        ).to(self.device).eval()
        self._programs: Dict[int, FrameProgram] = {}   # frame's, by top_n
        self._graphs: Dict[tuple, FrameGraph] = {}   # frame's, by `frame_signature`

    def _images(self, images) -> torch.Tensor:
        return _host_tensor(images).to(self.device)

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
    def frame(self, images, key_desc, key_num, top_n: int = 256, key_kp=None):
        """The serving frame (`FrameProgram`): detect + describe + match
        every frame of the batch against one keyframe.

        ``images``: ``(B, H, W, C)`` uint8 (scaled by 1/255 here) or float in
        [0, 1], with C = 3 or 1 (gray, repeated to 3 channels here).
        ``key_desc``: ``(N, D)`` float16 keyframe descriptors, ``key_num``
        its valid row count; N = ``min(top_n, max_keypoints)``.  With the
        SuperGlue matcher also ``key_kp``, the keyframe's ``(N, 3)`` float32
        ``[y, x, score]`` rows; the mnn matcher takes none.  Any may be on
        the host.

        Returns ``(num_valid (B,) int32, kp_packed (B, N, 3) float32 [y, x,
        score], match_index (B, N) int32 (-1 = no match), desc16 (B, N, D)
        float16)``, and with SuperGlue a fifth, ``match_score (B, N)``
        float32 (`FrameProgram`), tensors the caller owns.  Keypoints are
        score-sorted, so the first N rows are the top N.  Frame ``b``'s
        ``(desc16[b], num_valid[b])``, with ``kp_packed[b]`` for SuperGlue,
        is the next keyframe input.

        On the card, outside a width group, a call replays the CUDA graph
        of its `frame_signature` (`FrameGraph`), captured at the
        signature's first call; elsewhere the program runs eagerly.
        """
        key = (key_desc, key_num) if key_kp is None else (key_desc, key_num, key_kp)
        with profiling.span("frame", batch=len(images)):
            images = _host_tensor(images)
            program = self._programs.get(top_n)
            if program is None:
                program = self._programs[top_n] = FrameProgram(self.model, self.config, top_n,
                                                                self.matcher)
            if len(key) != len(program.keyframe):
                raise ValueError(f"the {self.config.matcher} matcher's keyframe is "
                                 f"{[name for name, _, _ in program.keyframe]}")
            if self.device.type == "cuda" and spatial.split()[1] == 1:
                sig = frame_signature(images, top_n)
                graph = self._graphs.get(sig)
                if graph is None:
                    graph = self._graphs[sig] = FrameGraph(program, images, self.device)
                with profiling.span("frame.upload"):
                    graph.image.copy_(images)
                for static, t in zip(graph.key, key):
                    static.copy_(torch.as_tensor(t))
                if graph.graph is None:
                    graph.capture()
                with profiling.span("frame.replay"):
                    return graph.replay()
            with profiling.span("frame.upload"):
                images = images.to(self.device)
            return program(images, *(torch.as_tensor(t, dtype=dtype, device=self.device)
                                     for t, (_, _, dtype) in zip(key, program.keyframe)))

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
        """``(ExportedProgram, meta)``: `torch.export` of `FullExport` or
        `PackedExport` on the frontend's device, and its ``meta.json`` (JAX's
        keys, spec names and dtype strings, `wrapper.py:226-440`) with the
        export's own specs.  The arguments and checks are ``export_pjrt``'s."""
        h, w = image_size
        cfg = self.config
        k, d = cfg.max_keypoints, cfg.descriptor_dim
        if abi not in ("full", "packed"):
            raise ValueError(f"abi must be 'full' or 'packed': {abi!r}")
        if batch != 1 and abi != "packed":
            raise ValueError("batched export is packed-only")
        if input_dtype not in ("f32", "u8"):
            raise ValueError(f"input_dtype must be 'f32' or 'u8': {input_dtype!r}")
        if not isinstance(self.matcher, MnnMatcher):
            raise ValueError("the native host serves the frame matched by mutual nearest "
                             "neighbours alone")
        cin = input_channels or cfg.image_channels
        if cin not in (1, cfg.image_channels):
            raise ValueError(f"input_channels must be 1 or {cfg.image_channels}")
        n = min(top_n or 256, k)
        if abi == "full":
            program = FullExport(self.model, cfg)
        else:
            program = PackedExport(FrameProgram(self.model, cfg, n, self.matcher), batch)
        inputs = (("image", (batch, h, w, cin), DTYPES[input_dtype]),) + program.keyframe
        example = tuple(torch.zeros(shape, dtype=dtype, device=self.device)
                        for _, shape, dtype in inputs)
        with torch.no_grad():
            ep = torch.export.export(program.eval(), example)
        # the graph's last node is its output: one traced value an output
        results = [node.meta["val"] for node in list(ep.graph.nodes)[-1].args[0]]
        meta = {
            "abi": abi, "batch": batch, "image_size": [h, w], "channels": cin,
            "input_dtype": input_dtype, "max_keypoints": k, "top_n": n,
            "descriptor_dim": d, "inputs": _specs(inputs),
            "outputs": _specs((name, t.shape, t.dtype)
                              for name, t in zip(program.outputs, results)),
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
    """The serving frame (JAX `wrapper.py:298-387`): prep the image batch
    (u8 -> float32 / 255, gray -> the model's channels), extract, and match
    each frame's top ``n = min(top_n, max_keypoints)`` rows against a
    keyframe by ``matcher``, whose tensors ``keyframe`` declares, ``(name,
    shape, dtype)`` each.  ``forward(image (B, H, W, C), *keyframe)`` ->
    ``(num_valid (B,) int32, kp_packed (B, n, 3) float32 [y, x, score],
    match_index (B, n) int32 (-1 = none), desc16 (B, n, D) float16)``, then
    the matcher's ``extra_outputs``."""

    def __init__(self, model: nn.Module, config: SuperPointConfig, top_n: int,
                 matcher: nn.Module):
        super().__init__()
        self.model, self.config, self.matcher = model, config, matcher
        self.n = min(top_n, config.max_keypoints)
        self.keyframe = matcher.keyframe(self.n, config.descriptor_dim)

    def forward(self, image: torch.Tensor, *key: torch.Tensor):
        cfg, n = self.config, self.n
        with profiling.span("frame.prep"):
            image = prep_images(image, cfg.image_channels)
        kp, desc = extract_fn(self.model, image, cfg)
        with profiling.span("frame.match"):
            # keypoints are score-sorted, so the first n rows are the top n
            valid = kp.valid[:, :n]
            desc_n = torch.where(valid[..., None], desc[:, :n], 0.0)
            rows = FrameRows(
                valid=valid,
                # coordinates stay float32 (f16 spacing is 0.5 px beyond x = 512)
                packed=torch.stack([kp.y[:, :n], kp.x[:, :n], kp.score[:, :n]], dim=-1),
                desc=desc_n, desc16=desc_n.to(torch.float16),
                num_valid=valid.sum(-1, dtype=torch.int32))
            match_index, *extra = self.matcher.match_frame(rows, key, image.shape[1:3])
            return (rows.num_valid, rows.packed, match_index, rows.desc16, *extra)


class PackedExport(nn.Module):
    """JAX's packed ABI (`wrapper.py:351-387`) over an mnn `FrameProgram`:
    its four outputs, unbatched at ``batch`` 1, else batched and followed by
    frame 0's ``(desc16, num_valid)`` as ``(key_desc_out, key_num_out)``."""

    def __init__(self, program: FrameProgram, batch: int):
        super().__init__()
        self.program, self.batch, self.keyframe = program, batch, program.keyframe
        self.outputs = ("num_valid", "kp_packed", "match_index", "desc",
                        *program.matcher.extra_outputs) + (
            ("key_desc_out", "key_num_out") if batch > 1 else ())

    def forward(self, image: torch.Tensor, key_desc: torch.Tensor, key_num: torch.Tensor):
        out = self.program(image, key_desc, key_num)
        if self.batch == 1:
            return tuple(t[0] for t in out)
        return (*out, out[3][0], out[0][0])   # frame 0's (desc16, num_valid)


class FullExport(nn.Module):
    """JAX's full ABI (``export_pjrt``, `wrapper.py:311-323`), one frame K
    wide: ``forward(image (1, H, W, C), key_desc (K, D) f32, key_valid (K,)
    bool) -> (y, x, score, valid, match_index, match_valid, desc)``,
    matched by mutual nearest neighbours."""

    outputs = ("y", "x", "score", "valid", "match_index", "match_valid", "desc")

    def __init__(self, model: nn.Module, config: SuperPointConfig):
        super().__init__()
        self.model, self.config = model, config
        k, d = config.max_keypoints, config.descriptor_dim
        self.keyframe = (("key_desc", (k, d), torch.float32), ("key_valid", (k,), torch.bool))

    def forward(self, image: torch.Tensor, key_desc: torch.Tensor, key_valid: torch.Tensor):
        cfg = self.config
        kp, desc = extract_fn(self.model, prep_images(image, cfg.image_channels), cfg)
        m = mnn_match(desc[0], kp.valid[0], key_desc, key_valid, max_l2_dist=cfg.nn_thresh)
        return kp.y[0], kp.x[0], kp.score[0], kp.valid[0], m.index, m.valid, desc[0]


def _specs(entries) -> List[dict]:
    """``meta.json`` specs of ``(name, shape, dtype)`` entries."""
    names = {dtype: name for name, dtype in DTYPES.items()}
    return [{"name": name, "shape": list(shape), "dtype": names[dtype]}
            for name, shape, dtype in entries]


def _host_tensor(images) -> torch.Tensor:
    """An image batch as a tensor, left where it is."""
    if isinstance(images, torch.Tensor):
        return images
    return torch.from_numpy(np.asarray(images))


def frame_signature(images: torch.Tensor, top_n: int) -> tuple:
    """``(B, H, W, C, image dtype, top_n)``: what a `FrameGraph` is
    captured for.  The keyframe's shapes and dtypes follow from it and the
    frontend's matcher (`FrameProgram.keyframe`)."""
    return (*images.shape, images.dtype, top_n)


class FrameGraph:
    """One CUDA graph of a `FrameProgram` at one `frame_signature`.

    It owns static inputs, the ``image`` buffer and ``key``, one buffer
    for each tensor of the program's keyframe, which a call fills before
    `replay`, and the graph's outputs in its private memory pool, which
    `replay` clones, so what a call returns stays the caller's after the
    next one.  `capture` runs the program eagerly twice on a side stream
    first, as ``Trainer._capture`` does (cuDNN and cuBLAS handles, the
    kernels' libraries, cached constants), then captures it.  The
    hand-written kernels launch inside the graph; the ``kernel.*`` and
    ``superglue.*`` counts of the capture are taken back and credited at
    each replay.
    """

    def __init__(self, program: FrameProgram, images: torch.Tensor, device: torch.device):
        self.program = program
        self.image = torch.empty(images.shape, dtype=images.dtype, device=device)
        self.key = [torch.empty(shape, dtype=dtype, device=device)
                    for _, shape, dtype in program.keyframe]
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def capture(self) -> None:
        """Warm up and capture, on the filled static inputs."""
        inputs = (self.image, *self.key)
        with torch.cuda.device(self.image.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(2):
                    self.program(*inputs)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = profiling.counters()
            with torch.cuda.graph(graph):
                self.outputs = self.program(*inputs)
        # the capture ran nothing: what it counted is credited at each replay
        self.counts = {k: v for k, v in profiling.counted_since(before).items()
                       if k.startswith(("kernel.", "superglue."))}
        profiling.credit(self.counts, -1)
        profiling.count("frame.captures")
        self.graph = graph

    def replay(self) -> Tuple[torch.Tensor, ...]:
        """The program on the static inputs: clones of its outputs."""
        self.graph.replay()
        out = tuple(t.clone() for t in self.outputs)
        profiling.credit(self.counts)
        profiling.count("frame.replays")
        return out


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
