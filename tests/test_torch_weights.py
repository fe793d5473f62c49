"""PyTorch port: weight carry-over from the committed ``.npz`` snapshots.

`state_dict_from_jax_variables` is the inverse of the JAX package's torch
importer, so the round trip through `resnet_variables_from_torch_state`
must give every snapshot back bit for bit.
"""

import os
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.models.torch_import import (
    resnet_variables_from_torch_state,
)
from feature_point_cnn_tpu.utils.weights import load_weights as jax_load_weights

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.models.superpoint import SuperPoint
from feature_point_cnn_tpu_torch.utils.weights import (
    load_variables,
    load_weights,
    released_path,
    state_dict_from_jax_variables,
)

WEIGHTS_DIR = Path(__file__).resolve().parent.parent / "weights"
SNAPSHOTS = sorted(WEIGHTS_DIR.glob("*.npz"))


def _flat(tree):
    return {
        jax.tree_util.keystr(path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.mark.parametrize("snapshot", SNAPSHOTS, ids=lambda p: p.name)
def test_round_trip_through_jax_importer_is_bit_exact(snapshot):
    want = _flat(jax_load_weights(str(snapshot)))
    state = state_dict_from_jax_variables(load_weights(str(snapshot)))
    got = _flat(resnet_variables_from_torch_state(state))
    assert len(want) == 136 and got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_state_dict_loads_strictly_into_the_model():
    sd = load_variables(released_path(), device="cpu")
    assert all(v.device.type == "cpu" for v in sd.values())
    model = SuperPoint(SuperPointConfig(compute_dtype="float32"))
    model.load_state_dict(sd)  # strict: every name and shape matches
    assert torch.equal(
        model.descriptor.up_sample.bias, sd["descriptor.up_sample.bias"]
    )


def test_released_path_pointer_and_fallback(tmp_path):
    with pytest.raises(FileNotFoundError):
        released_path(tmp_path)
    np.savez(tmp_path / "magicpoint_only.npz", a=np.zeros(1))
    assert released_path(tmp_path).endswith("magicpoint_only.npz")
    np.savez(tmp_path / "superpoint_r3.npz", a=np.zeros(1))
    np.savez(tmp_path / "superpoint_r10.npz", a=np.zeros(1))
    now = time.time()
    os.utime(tmp_path / "superpoint_r10.npz", (now - 100, now - 100))
    assert released_path(tmp_path).endswith("superpoint_r3.npz")  # mtime
    (tmp_path / "RELEASED").write_text("superpoint_r10.npz\n")
    assert released_path(tmp_path).endswith("superpoint_r10.npz")
    (tmp_path / "RELEASED").write_text("missing.npz\n")
    with pytest.raises(FileNotFoundError):
        released_path(tmp_path)
    # the repo's own pointer
    assert Path(released_path()).name == (WEIGHTS_DIR / "RELEASED").read_text().strip()


def test_load_weights_rejects_non_snapshot(tmp_path):
    np.savez(tmp_path / "x.npz", **{"params/a": np.zeros(1)})
    with pytest.raises(ValueError, match="batch_stats"):
        load_weights(str(tmp_path / "x.npz"))
