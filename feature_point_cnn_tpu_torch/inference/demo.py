"""Live feature-matching demo (`feature_point_cnn_tpu/inference/demo.py:32-141`).

Capture frames, extract keypoints and descriptors on the device, match the
current frame against a captured keyframe (`mnn_match` with the cross
check), draw the matches and the frame rate.  Runs headless
(``source="synthetic"``, ``max_frames``, ``show=False``) so the loop can be
tested and timed without a webcam or a display.

Keys (with a window): q quit, s set keyframe, b toggle blur, t export the
native serving bundle (`SuperPointFrontend.export_native`) to
``export_live/``, as the JAX demo does.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.inference.camera import Camera, SyntheticCamera
from feature_point_cnn_tpu_torch.inference.wrapper import SuperPointFrontend
from feature_point_cnn_tpu_torch.ops.matching import mnn_match


def make_query_image(frame: np.ndarray, out_wh) -> np.ndarray:
    """Ratio-preserving resize and centre crop to ``out_wh = (W, H)``;
    ``frame`` is ``(H, W, 3)`` float RGB in [0, 1]."""
    from feature_point_cnn_tpu_torch.utils.image import ratio_preserving_crop

    ow, oh = out_wh
    return ratio_preserving_crop(frame, (oh, ow))


def run_demo(
    weights_path: Optional[str],
    config: SuperPointConfig = SuperPointConfig(),
    source="synthetic",
    width: int = 640,
    height: int = 480,
    max_frames: int = 0,
    show: bool = True,
    device=None,
) -> dict:
    """Runs the loop on ``device`` (``None``: ``cuda``) and returns summary
    stats (frames, mean fps, mean matches) so headless runs are
    assertable.  ``weights_path``: a ``.npz`` snapshot, a checkpoint
    directory, or ``None`` for random weights."""
    if source == "synthetic":
        camera = SyntheticCamera((height, width))
    else:
        camera = Camera(int(source) if str(source).isdigit() else source)

    frontend = SuperPointFrontend(config=config, weights_path=weights_path,
                                  device=device)

    win = None
    if show:
        try:
            import cv2

            cv2.namedWindow("feature_point_cnn_tpu_torch")
            win = "feature_point_cnn_tpu_torch"
        except Exception as e:  # no display or no cv2: run headless
            print(f"[demo] no window ({e}); running headless")
            win = None

    key_desc = key_kp = None
    frames = 0
    do_blur = False
    fps_hist, match_hist = [], []
    t_prev = time.perf_counter()
    try:
        while True:
            frame, ok = camera.get_frame()
            if not ok:
                break
            if do_blur:
                import cv2

                frame = cv2.blur(frame, (3, 3))
            query = make_query_image(frame, (width, height))
            kp, desc = frontend.extract(np.asarray(query, np.float32)[None])
            first_frame = key_desc is None
            if first_frame:
                key_kp, key_desc = kp, desc
            m = mnn_match(desc[0], kp.valid[0], key_desc[0], key_kp.valid[0],
                          max_l2_dist=config.nn_thresh, cross_check=True)
            n_matches = int(m.num)
            if not first_frame:  # the keyframe's own frame matches itself
                match_hist.append(n_matches)

            t_now = time.perf_counter()
            fps = 1.0 / max(t_now - t_prev, 1e-6)
            t_prev = t_now
            fps_hist.append(fps)
            frames += 1

            if win is not None:
                import cv2

                vis = (np.asarray(query) * 255).astype(np.uint8).copy()
                xs = kp.x[0].cpu().numpy().astype(int)
                ys = kp.y[0].cpu().numpy().astype(int)
                for x, y, v in zip(xs, ys, kp.valid[0].cpu().numpy()):
                    if v:
                        cv2.circle(vis, (x, y), 2, (0, 255, 0), -1, lineType=16)
                cv2.putText(
                    vis, f"FPS {fps:.0f} matches {n_matches}", (10, 30),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.75, (200, 200, 200), 2,
                )
                cv2.imshow(win, vis)
                k = cv2.waitKey(1)
                if k == ord("q"):
                    break
                if k == ord("s"):
                    key_kp, key_desc = kp, desc
                if k == ord("b"):
                    do_blur = not do_blur
                if k == ord("t"):
                    out = "export_live"
                    frontend.export_native(out, (height, width))
                    print(f"Model saved to {out}/, 't' pressed.")
            if max_frames and frames >= max_frames:
                break
    finally:
        camera.close()
        if win is not None:
            import cv2

            cv2.destroyAllWindows()
    return {
        "frames": frames,
        "mean_fps": float(np.mean(fps_hist[1:])) if len(fps_hist) > 1 else 0.0,
        "mean_matches": float(np.mean(match_hist)) if match_hist else 0.0,
    }
