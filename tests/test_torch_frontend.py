"""PyTorch port: the whole serving slice against the JAX frontend on the
released weights, on the CPU (float32 on both sides).

Tolerances: prob maps agree to atol 1e-5 + rtol 1e-4 (the convolutions
sum in another order, and oneDNN's order varies from run to run: logits
differ by up to ~1e-4, which moves a probability p by ~1e-4 p); given the
same prob map the keypoints are exactly equal; end to end the keypoint sets
overlap >= 99% (a score within an ulp of the threshold or of a neighbour
may flip one point).  The packed frame is held to the JAX
composition of `export_pjrt`'s frame program: counts and match indices
agree on >= 99% of slots, coordinates and scores where both keep the
keypoint to 1e-5, f16 descriptors to 1e-3 (one f16 ulp near 1).
"""

import functools
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
from feature_point_cnn_tpu.inference.wrapper import SuperPointFrontend as JaxFrontend
from feature_point_cnn_tpu.ops.detection import extract_keypoints as jax_extract
from feature_point_cnn_tpu.ops.matching import mnn_match as jax_mnn
from tests.test_torch_model import released_jax_variables

from chip_smoke import polygon_scene, shifted_pair
from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
from feature_point_cnn_tpu_torch.ops.detection import (
    decode_prob_map,
    extract_keypoints,
    refine_keypoints,
)
from feature_point_cnn_tpu_torch.utils.weights import released_path

H, W = 72, 88
REPO = Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=None)
def _frontends(k=128):
    jfe = JaxFrontend(JaxConfig(compute_dtype="float32", max_keypoints=k),
                      variables=released_jax_variables())
    tfe = SuperPointFrontend(SuperPointConfig(compute_dtype="float32",
                                              max_keypoints=k),
                             weights_path=released_path(), device="cpu")
    return jfe, tfe


def _scenes(b, seed=0):
    rng = np.random.default_rng(seed)
    gray = np.stack([polygon_scene(rng, H, W, n_polygons=12) for _ in range(b)])
    return np.repeat(gray[..., None], 3, axis=-1)


def _kp_set(kp, b):
    y, x, v = (np.asarray(kp.y[b]), np.asarray(kp.x[b]), np.asarray(kp.valid[b]))
    return {(int(yy), int(xx)) for yy, xx, vv in zip(y, x, v) if vv}


def test_slice_matches_jax_frontend():
    jfe, tfe = _frontends()
    imgs = _scenes(2)
    jprob = np.array(jfe.model.apply(jfe.variables, jnp.asarray(imgs))[0])
    with torch.no_grad():
        tprob = tfe.model(torch.from_numpy(imgs))[0].numpy()
    np.testing.assert_allclose(tprob, jprob, atol=1e-5, rtol=1e-4)

    # the same prob map -> exactly the same keypoints
    same = extract_keypoints(torch.from_numpy(jprob), tfe.config)
    want = jax_extract(jnp.asarray(jprob), jfe.config)
    for f in ("y", "x", "score", "valid"):
        np.testing.assert_array_equal(getattr(same, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)

    jkp, jdesc = jfe.extract(imgs)
    tkp, tdesc = tfe.extract(imgs)
    total = both = 0
    for b in range(2):
        js, ts = _kp_set(jkp, b), _kp_set(tkp, b)
        total += len(js)
        both += len(js & ts)
    print(f'keypoints {total}, shared {both}')
    assert total >= 10 and both / total >= 0.99
    agree = (np.asarray(jkp.valid) & tkp.valid.numpy()
             & (np.asarray(jkp.y) == tkp.y.numpy())
             & (np.asarray(jkp.x) == tkp.x.numpy()))
    np.testing.assert_allclose(tdesc.numpy()[agree], np.asarray(jdesc)[agree],
                               atol=1e-5)
    pts, desc = tfe.run(imgs[0])
    assert pts.shape[0] == 3 and desc.shape == (128, pts.shape[1])


def _jax_frame(jfe, images, key_desc, key_num, n):
    """`export_pjrt`'s packed frame program (wrapper.py:298-307,351-387),
    composed from the JAX package's public functions."""
    images = jnp.asarray(images)
    if images.dtype == jnp.uint8:
        images = images.astype(jnp.float32) * (1.0 / 255.0)
    if images.shape[-1] == 1:
        images = jnp.broadcast_to(images, images.shape[:-1] + (3,))
    kp, desc = jfe.extract(images)
    y, x = kp.y[:, :n], kp.x[:, :n]
    score, valid = kp.score[:, :n], kp.valid[:, :n]
    desc_n = jnp.where(valid[..., None], desc[:, :n], 0.0)
    key_valid = jnp.arange(n) < key_num
    m = jax.vmap(lambda dn, v: jax_mnn(
        dn, v, jnp.asarray(key_desc).astype(jnp.float32), key_valid,
        max_l2_dist=jfe.config.nn_thresh))(desc_n, valid)
    return (np.array(valid.sum(-1, dtype=jnp.int32)),
            np.array(jnp.stack([y, x, score], axis=-1)),
            np.array(jnp.where(m.valid, m.index, -1).astype(jnp.int32)),
            np.array(desc_n.astype(jnp.float16)))


@pytest.mark.parametrize("channels", [3, 1], ids=["u8_rgb", "u8_gray"])
def test_frame_matches_jax_frame_program(channels):
    n = 64
    jfe, tfe = _frontends(k=128)
    key, moved = shifted_pair(3, H, W, 8)
    frames = np.stack([moved, shifted_pair(4, H, W, 0)[0]])   # (2, H, W, 1)
    key = key[None]
    if channels == 3:
        frames, key = np.repeat(frames, 3, -1), np.repeat(key, 3, -1)
    zero = np.zeros((n, 128), np.float16)
    jnum_k, _, _, jkey = _jax_frame(jfe, key, zero, 0, n)
    want = _jax_frame(jfe, frames, jkey[0], int(jnum_k[0]), n)
    got = [t.numpy() for t in tfe.frame(torch.from_numpy(frames),
                                        torch.from_numpy(jkey[0]), int(jnum_k[0]),
                                        top_n=n)]
    assert got[0].dtype == np.int32 and got[3].dtype == np.float16
    assert got[1].shape == (2, n, 3) and got[2].shape == (2, n)
    np.testing.assert_array_equal(got[0], want[0])
    same = (got[1][..., :2] == want[1][..., :2]).all(-1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got[1][same], want[1][same], atol=1e-5)
    np.testing.assert_allclose(got[3][same].astype(np.float32),
                               want[3][same].astype(np.float32), atol=1e-3)
    assert (got[2] == want[2]).mean() >= 0.99
    assert (got[2][0] >= 0).sum() >= 5  # the shifted frame matches the key


def test_frontend_without_device_and_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SuperPointFrontend()


def test_decode_gate_on_cpu_matches_prob_path():
    """On the CPU `extract` decodes through the decode kernel's plain
    version (the thresholded map, then NMS on it): the same keypoints as
    the prob-map path, `decode_prob_map` then `extract_keypoints`, refined
    on the raw map."""
    imgs = _scenes(1, seed=5)
    fe = SuperPointFrontend(SuperPointConfig(
        compute_dtype="float32", max_keypoints=64, subpixel_refine=True),
        weights_path=released_path(), device="cpu")
    got = fe.extract(imgs)[0]
    with torch.inference_mode():
        logits, _ = fe.model.features(torch.from_numpy(imgs).float())
        prob = decode_prob_map(logits, fe.config.cell)
        want = refine_keypoints(prob, extract_keypoints(prob, fe.config))
    assert int(got.valid.sum()) > 0
    for f in ("y", "x", "score", "valid"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_port_imports_no_jax():
    """Importing every port module (the native build's `inference/native.py`
    among them), chip_smoke, bench_torch_nms and the two probes
    (`probe_torch_batchnorm`, `probe_trace_records`) pulls in neither JAX nor the JAX package, nor cv2 or PIL: the port
    imports those two inside the functions that need them (the H100
    machine has both, ROADMAP §3).  The native host's sources include only
    files of their own directory."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "feature_point_cnn_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke', 'bench_torch_nms', 'probe_torch_batchnorm',"
        " 'probe_trace_records']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'feature_point_cnn_tpu', 'cv2', 'PIL')]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(mods) >= 15
    assert "feature_point_cnn_tpu_torch.inference.native" in mods
    # the native host's C++ includes its own copies, nothing of the JAX
    # package's csrc/
    serve = REPO / "feature_point_cnn_tpu_torch" / "csrc" / "serve"
    for src in serve.iterdir():
        for inc in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (serve / inc).exists(), (src.name, inc)
