"""PyTorch port parity: the tracking evaluation against the JAX package,
on the CPU.

`sim2_h_flat` and `smooth_trajectory` are numpy on both sides and equal
exactly; `render_sequence` (one batched warp) within 1e-5.  With both
packages' RANSAC draws pinned to one table (``pinned_ransac``),
`evaluate_tracking` with the ideal provider of
`tests/test_eval.py::test_tracking_eval_ideal_provider_recovers_trajectory`
gives JAX's dict (counts exactly, ATE within 1e-3 px), and the whole slice
(the released weights at float32 through both frontends, 96x128, 8
frames, with and without the pose graph) gives JAX's counts exactly and
its ATE within 0.05 px, as does the entry point's default synthetic scene
(240x320, 40 frames), where both re-key every frame.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_point_cnn_tpu.config import SuperPointConfig as JaxConfig
from feature_point_cnn_tpu.eval import tracking as jax_eval
from feature_point_cnn_tpu.inference.wrapper import SuperPointFrontend as JaxFrontend
from feature_point_cnn_tpu.slam import tracking as jax_tracking
from tests.test_torch_model import released_jax_variables
from tests.test_torch_slam import pinned_ransac  # noqa: F401  (a fixture)

from chip_smoke import polygon_scene, write_bmp
from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.eval import tracking
from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
from feature_point_cnn_tpu_torch.slam import tracking as port_tracking
from feature_point_cnn_tpu_torch.utils.weights import released_path

COUNTS = ("frames", "num_keyframes", "num_loop_closures")


def test_sim2_h_flat_and_smooth_trajectory_equal_jax():
    for args in ((0.1, 1.2, 3.0, -4.0), (-0.5, 0.9, 0.0, 7.5)):
        np.testing.assert_array_equal(tracking.sim2_h_flat(*args),
                                      jax_eval.sim2_h_flat(*args))
    for kw in (dict(n_frames=12), dict(n_frames=40, max_shift=10.0, loops=2)):
        np.testing.assert_array_equal(tracking.smooth_trajectory(**kw),
                                      jax_eval.smooth_trajectory(**kw))


def test_render_sequence_matches_jax():
    base = np.random.default_rng(0).random((48, 64, 3)).astype(np.float32)
    params = tracking.smooth_trajectory(5, max_shift=6.0, loops=2)
    got = tracking.render_sequence(base, params, device="cpu")
    assert got.shape == (5, 48, 64, 3) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), jax_eval.render_sequence(base, params),
                               atol=1e-5)


def _ideal_extractor(package):
    """The ideal provider of `tests/test_eval.py`: world points projected
    through the exact render transforms, fixed unit descriptors."""
    h, w, k = 120, 160, 64
    rng = np.random.default_rng(0)
    base_xy = np.stack([rng.uniform(20, w - 20, k), rng.uniform(20, h - 20, k)], -1)
    desc = rng.standard_normal((k, 32)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    params = tracking.smooth_trajectory(12, max_shift=10.0)
    frame = {"i": 0}

    def extract(_image):
        th, s, tx, ty = params[frame["i"]]
        frame["i"] += 1
        c, sn = np.cos(th), np.sin(th)
        shifted = (base_xy - [tx, ty]) / s
        fx = (c * shifted[:, 0] + sn * shifted[:, 1]).astype(np.float32)
        fy = (-sn * shifted[:, 0] + c * shifted[:, 1]).astype(np.float32)
        if package == "jax":
            return jax_tracking.FrameFeatures(jnp.asarray(fy), jnp.asarray(fx),
                                              jnp.ones(k, bool), jnp.asarray(desc))
        return port_tracking.FrameFeatures(torch.from_numpy(fy), torch.from_numpy(fx),
                                           torch.ones(k, dtype=torch.bool),
                                           torch.from_numpy(desc))

    return extract, np.zeros((h, w, 3), np.float32)


def _assert_outputs_close(got, want, ate_atol):
    assert got.keys() == want.keys()
    for key in got:
        if key in COUNTS:
            assert got[key] == want[key], (key, got[key], want[key])
        elif key.endswith("_px"):
            assert got[key] == pytest.approx(want[key], abs=ate_atol), key
        else:                   # frac_tracked, mean_matches, mean_inliers
            assert got[key] == pytest.approx(want[key], abs=1e-9), key


def test_evaluate_tracking_ideal_provider_recovers_trajectory_and_equals_jax(
        pinned_ransac):
    extract, base = _ideal_extractor("port")
    got = tracking.evaluate_tracking(extract, base, n_frames=12, max_shift=10.0,
                                     device="cpu")
    assert got["frac_tracked"] == 1.0
    assert got["ate_rmse_px"] < 0.2, got
    assert got["mean_inliers"] > 50
    jextract, base = _ideal_extractor("jax")
    want = jax_eval.evaluate_tracking(jextract, base, n_frames=12, max_shift=10.0)
    _assert_outputs_close(got, want, ate_atol=1e-3)


@pytest.mark.parametrize("posegraph", [False, True])
def test_tracking_slice_through_both_frontends_equals_jax(pinned_ransac, posegraph):
    h, w = 96, 128
    base = np.repeat(polygon_scene(np.random.default_rng(7), h, w, n_polygons=14)[..., None],
                     3, -1)
    # min_inliers 18 promotes keyframes on this short sweep (7 of 8 frames),
    # so the pose graph has loop closures to work with
    kw = dict(n_frames=8, max_shift=6.0, min_inliers=18, loop_min_inliers=10,
              loops=2, posegraph=posegraph)
    tfe = SuperPointFrontend(SuperPointConfig(compute_dtype="float32", max_keypoints=128),
                             weights_path=released_path(), device="cpu")
    jfe = JaxFrontend(JaxConfig(compute_dtype="float32", max_keypoints=128),
                      variables=released_jax_variables())
    got = tracking.evaluate_tracking(port_tracking.frontend_extractor(tfe), base,
                                     device="cpu", **kw)
    want = jax_eval.evaluate_tracking(jax_tracking.frontend_extractor(jfe), base, **kw)
    assert got["mean_matches"] > 10 and got["frac_tracked"] > 0.5
    assert got["num_keyframes"] > 2 and got.get("num_loop_closures", 1) > 0
    _assert_outputs_close(got, want, ate_atol=0.05)


def test_entry_point_synthetic_scene_rekeys_every_frame_in_both_packages(pinned_ransac):
    # the tracking entry point's defaults (--source synthetic, 240x320, K 512,
    # 40 frames) at float32: the scene is sparse, so the released model
    # re-keys every frame in JAX as in the port
    shape = (240, 320)
    base = tracking._base_image("synthetic", shape)
    np.testing.assert_array_equal(np.asarray(base), jax_eval._base_image("synthetic", shape))
    tfe = SuperPointFrontend(SuperPointConfig(compute_dtype="float32", max_keypoints=512),
                             weights_path=released_path(), device="cpu")
    jfe = JaxFrontend(JaxConfig(compute_dtype="float32", max_keypoints=512),
                      variables=released_jax_variables())
    got = tracking.evaluate_tracking(port_tracking.frontend_extractor(tfe), base,
                                     n_frames=40, device="cpu")
    want = jax_eval.evaluate_tracking(jax_tracking.frontend_extractor(jfe), base,
                                      n_frames=40)
    assert got["frac_tracked"] == 0.0 and got["num_keyframes"] == 40, got
    _assert_outputs_close(got, want, ate_atol=0.05)


def test_main_on_an_image_directory_prints_its_json(tmp_path, capsys):
    img = polygon_scene(np.random.default_rng(3), 96, 128)
    write_bmp(tmp_path / "a.bmp", np.repeat((img[..., None] * 255).astype(np.uint8), 3, -1))
    out = tracking.main(["--weights-path", released_path(), "--source", str(tmp_path),
                         "--H", "48", "--W", "64", "--frames", "4", "--max-keypoints",
                         "64", "--max-shift", "2"], device="cpu")
    printed = capsys.readouterr().out
    assert '"ate_rmse_px"' in printed and out["frames"] == 4
