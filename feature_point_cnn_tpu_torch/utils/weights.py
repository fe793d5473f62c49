"""Committed ``.npz`` weight snapshots <-> PyTorch ``state_dict``.

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

`jax_variables_from_state_dict` is the way back, so trained parameters
return to the ``.npz`` layout (`save_weights`).  The VGG family
(`models/vgg_superpoint.py`: HWIO kernels with biases, no BatchNorm, the
same names on both sides) goes across with `vgg_state_dict_from_jax_variables`
and back with `jax_variables_from_vgg_state_dict`.
"""

from __future__ import annotations

import os
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
    if "bias" in p:                       # a folded tree's conv
        sd[f"{name}.bias"] = _t(p["bias"])


def _bn(sd: dict, name: str, p: Mapping, s: Mapping) -> None:
    if p is None:                         # folded away
        return
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
        bp, bs, pre = p[f"block{i}"], s.get(f"block{i}", {}), f"{name}.{i}"
        _conv(sd, f"{pre}.conv1", bp["conv1"])
        _bn(sd, f"{pre}.bn1", bp.get("bn1"), bs.get("bn1"))
        _conv(sd, f"{pre}.conv2", bp["conv2"])
        _bn(sd, f"{pre}.bn2", bp.get("bn2"), bs.get("bn2"))
        if "identity_conv" in bp:
            _conv(sd, f"{pre}.identity_downsample.0", bp["identity_conv"])
            _bn(sd, f"{pre}.identity_downsample.1", bp.get("identity_bn"),
                bs.get("identity_bn"))
        i += 1


def state_dict_from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of the ResNet SuperPoint -> a CPU
    float32 ``state_dict`` under the reference's PyTorch names.  A folded
    tree (JAX's ``fold_batchnorm``: ``{"params"}`` alone, conv kernels with
    biases) gives the ``fold_bn=True`` model's ``state_dict``."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    enc_p, enc_s = p["encoder"], s.get("encoder", {})
    _conv(sd, "encoder.conv1", enc_p["conv1"])
    _bn(sd, "encoder.bn1", enc_p.get("bn1"), enc_s.get("bn1"))
    for layer in ("layer1", "layer2"):
        _layer(sd, f"encoder.{layer}", enc_p[layer], enc_s.get(layer, {}))
    _layer(sd, "detector.layer", p["detector"]["layer"],
           s.get("detector", {}).get("layer", {}))
    dsc_p, dsc_s = p["descriptor"], s.get("descriptor", {})
    _layer(sd, "descriptor.layer_in", dsc_p["layer_in"], dsc_s.get("layer_in", {}))
    up = dsc_p["up_sample"]
    sd["descriptor.up_sample.weight"] = _t(
        np.asarray(up["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
    )
    sd["descriptor.up_sample.bias"] = _t(up["bias"])
    _bn(sd, "descriptor.bn", dsc_p.get("bn"), dsc_s.get("bn"))
    _layer(sd, "descriptor.layer_out", dsc_p["layer_out"],
           dsc_s.get("layer_out", {}))
    return sd


VGG_CONVS = tuple(f"encoder_conv{i}_{ab}" for i in range(4) for ab in "ab") + (
    "detector_conv_a", "detector_conv_b", "descriptor_conv_a", "descriptor_conv_b")


def vgg_state_dict_from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``VGGSuperPoint`` variables (``{"params": {name: {kernel HWIO,
    bias}}}``) -> the port's CPU float32 ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for name in VGG_CONVS:
        _conv(sd, name, variables["params"][name])
    return sd


def jax_variables_from_vgg_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The inverse: a VGG ``state_dict`` -> ``{"params", "batch_stats"}`` of
    float32 numpy arrays in the Flax layout (no BatchNorm: empty stats)."""
    params = {}
    for name in VGG_CONVS:
        params[name] = _conv_back(sd, name)
        params[name]["bias"] = _np(sd[f"{name}.bias"])
    return {"params": params, "batch_stats": {}}


def load_variables(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Load a snapshot as a ``state_dict`` on ``device`` (``cuda`` unless
    the caller passes another)."""
    dev = resolve_device(device)
    sd = state_dict_from_jax_variables(load_weights(path))
    return {k: v.to(dev) for k, v in sd.items()}


def _np(t) -> np.ndarray:
    return t.detach().to(device="cpu", dtype=torch.float32).numpy()


def _conv_back(sd: Mapping, name: str) -> dict:
    return {"kernel": _np(sd[f"{name}.weight"]).transpose(2, 3, 1, 0)}


def _bn_back(sd: Mapping, name: str):
    return ({"scale": _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])},
            {"mean": _np(sd[f"{name}.running_mean"]),
             "var": _np(sd[f"{name}.running_var"])})


def _layer_back(sd: Mapping, name: str):
    p, s = {}, {}
    i = 0
    while f"{name}.{i}.conv1.weight" in sd:
        pre = f"{name}.{i}"
        bp = {"conv1": _conv_back(sd, f"{pre}.conv1"),
              "conv2": _conv_back(sd, f"{pre}.conv2")}
        bs = {}
        bp["bn1"], bs["bn1"] = _bn_back(sd, f"{pre}.bn1")
        bp["bn2"], bs["bn2"] = _bn_back(sd, f"{pre}.bn2")
        if f"{pre}.identity_downsample.0.weight" in sd:
            bp["identity_conv"] = _conv_back(sd, f"{pre}.identity_downsample.0")
            bp["identity_bn"], bs["identity_bn"] = _bn_back(
                sd, f"{pre}.identity_downsample.1")
        p[f"block{i}"], s[f"block{i}"] = bp, bs
        i += 1
    return p, s


def jax_variables_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of `state_dict_from_jax_variables`: a ``state_dict``
    under the reference's PyTorch names -> ``{"params", "batch_stats"}`` of
    float32 numpy arrays in the Flax tree's layout."""
    p = {"encoder": {}, "detector": {}, "descriptor": {}}
    s = {"encoder": {}, "detector": {}, "descriptor": {}}
    p["encoder"]["conv1"] = _conv_back(sd, "encoder.conv1")
    p["encoder"]["bn1"], s["encoder"]["bn1"] = _bn_back(sd, "encoder.bn1")
    for head, layer in (("encoder", "layer1"), ("encoder", "layer2"),
                        ("detector", "layer"), ("descriptor", "layer_in"),
                        ("descriptor", "layer_out")):
        p[head][layer], s[head][layer] = _layer_back(sd, f"{head}.{layer}")
    p["descriptor"]["up_sample"] = {
        "kernel": np.ascontiguousarray(
            _np(sd["descriptor.up_sample.weight"]).transpose(2, 3, 0, 1)[::-1, ::-1]),
        "bias": _np(sd["descriptor.up_sample.bias"]),
    }
    p["descriptor"]["bn"], s["descriptor"]["bn"] = _bn_back(sd, "descriptor.bn")
    return {"params": p, "batch_stats": s}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def save_weights(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Write a model ``state_dict`` as a portable ``.npz`` snapshot in the
    JAX package's layout (one array per ``/``-joined tree path); written to
    a temporary file and renamed."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    tmp = f"{path}.tmp.npz"  # .npz suffix so savez doesn't append its own
    np.savez_compressed(tmp, **_flatten(jax_variables_from_state_dict(state_dict)))
    os.replace(tmp, path)
