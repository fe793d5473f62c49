"""Committed ``.npz`` weight snapshots -> PyTorch ``state_dict``.

The snapshots (`weights/*.npz`) are the JAX package's format: one array per
``/``-joined Flax tree path (``params/encoder/conv1/kernel``, ...).  This
module reads them without JAX and carries them across to the reference's
PyTorch names, the inverse of the JAX package's checkpoint importer
(`feature_point_cnn_tpu/models/torch_import.py:42-122`):

* conv kernels HWIO -> OIHW;
* the transposed conv kernel is stored in flipped correlation form
  (`feature_point_cnn_tpu/models/blocks.py:59-97`), so torch's
  ``(in, out, kh, kw)`` is ``kernel[::-1, ::-1].transpose(2, 3, 0, 1)``;
* BatchNorm ``scale/bias`` + ``mean/var`` -> ``weight/bias/running_mean/
  running_var``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from feature_point_cnn_tpu_torch.device import resolve_device


def released_path(weights_dir=None) -> str:
    """Resolve the RELEASED weight snapshot.

    The ``weights/RELEASED`` pointer file (one line: the snapshot filename)
    names the one artifact behind every published number.  Without the
    pointer: the newest-by-mtime ``superpoint*.npz`` (then any ``*.npz``).
    Raises FileNotFoundError when no snapshot exists at all.
    """
    wdir = Path(weights_dir) if weights_dir else (
        Path(__file__).resolve().parents[2] / "weights"
    )
    pointer = wdir / "RELEASED"
    if pointer.exists():
        name = pointer.read_text().strip()
        path = wdir / name
        if not path.exists():
            raise FileNotFoundError(
                f"{pointer} points at {name!r} but {path} does not exist"
            )
        return str(path)
    snaps = sorted(
        list(wdir.glob("superpoint*.npz")) or list(wdir.glob("*.npz")),
        key=lambda p: p.stat().st_mtime,
    )
    if not snaps:
        raise FileNotFoundError(f"no weight snapshots under {wdir}")
    return str(snaps[-1])


def load_weights(path: str) -> dict:
    """Read a snapshot into the nested ``{"params", "batch_stats"}`` dict of
    numpy arrays."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    for top in ("params", "batch_stats"):
        if top not in out:
            raise ValueError(
                f"{path} is not a weights snapshot: missing {top!r} "
                f"(top-level keys: {sorted(out)})"
            )
    return out


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _conv(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))


def _bn(sd: dict, name: str, p: Mapping, s: Mapping) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = _t(s["mean"])
    sd[f"{name}.running_var"] = _t(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def _layer(sd: dict, name: str, p: Mapping, s: Mapping) -> None:
    """A `ResNetLayer`: ``block{i}`` -> ``{i}``; the first block's projected
    identity is the reference's ``identity_downsample`` Sequential."""
    i = 0
    while f"block{i}" in p:
        bp, bs, pre = p[f"block{i}"], s[f"block{i}"], f"{name}.{i}"
        _conv(sd, f"{pre}.conv1", bp["conv1"])
        _bn(sd, f"{pre}.bn1", bp["bn1"], bs["bn1"])
        _conv(sd, f"{pre}.conv2", bp["conv2"])
        _bn(sd, f"{pre}.bn2", bp["bn2"], bs["bn2"])
        if "identity_conv" in bp:
            _conv(sd, f"{pre}.identity_downsample.0", bp["identity_conv"])
            _bn(sd, f"{pre}.identity_downsample.1", bp["identity_bn"],
                bs["identity_bn"])
        i += 1


def state_dict_from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of the ResNet SuperPoint -> a CPU
    float32 ``state_dict`` under the reference's PyTorch names."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    enc_p, enc_s = p["encoder"], s["encoder"]
    _conv(sd, "encoder.conv1", enc_p["conv1"])
    _bn(sd, "encoder.bn1", enc_p["bn1"], enc_s["bn1"])
    for layer in ("layer1", "layer2"):
        _layer(sd, f"encoder.{layer}", enc_p[layer], enc_s[layer])
    _layer(sd, "detector.layer", p["detector"]["layer"], s["detector"]["layer"])
    dsc_p, dsc_s = p["descriptor"], s["descriptor"]
    _layer(sd, "descriptor.layer_in", dsc_p["layer_in"], dsc_s["layer_in"])
    up = dsc_p["up_sample"]
    sd["descriptor.up_sample.weight"] = _t(
        np.asarray(up["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
    )
    sd["descriptor.up_sample.bias"] = _t(up["bias"])
    _bn(sd, "descriptor.bn", dsc_p["bn"], dsc_s["bn"])
    _layer(sd, "descriptor.layer_out", dsc_p["layer_out"], dsc_s["layer_out"])
    return sd


def load_variables(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Load a snapshot as a ``state_dict`` on ``device`` (``cuda`` unless
    the caller passes another)."""
    dev = resolve_device(device)
    sd = state_dict_from_jax_variables(load_weights(path))
    return {k: v.to(dev) for k, v in sd.items()}
