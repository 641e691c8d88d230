"""Visualization helpers: warped-event renders and sensor-FOV markers
(counterpart of ``emba_tpu/viz.py``, numpy on the host).

Covers the reference's visual-debug surface: drawing warped events on the
panorama (``src/test/event_warper_test.cpp:160-190``) and the sensor-FOV
center marker (``EventWarper::drawSensorFOV``,
``src/utils/event_pano_warper.cpp:76-89``).
"""

from __future__ import annotations

import numpy as np

from . import spline
from .camera import EquirectangularCamera, PinholeCamera
from .io import normalize_robust


def warp_points_np(bearings: np.ndarray, R: np.ndarray, pano: EquirectangularCamera):
    """Host-side warp of bearing vectors (N, 3) under rotation R -> (N, 2)."""
    rb = bearings @ R.T
    phi = np.arctan2(rb[:, 0], rb[:, 2])
    theta = np.arcsin(np.clip(rb[:, 1] / np.linalg.norm(rb, axis=1), -1, 1))
    return np.stack(
        [pano.width / 2.0 + phi * pano.fx, pano.height / 2.0 + theta * pano.fy],
        axis=-1,
    )


def render_warped_events(
    base: np.ndarray,
    traj: "spline.Trajectory",
    cam: PinholeCamera,
    pano: EquirectangularCamera,
    t: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    pol: np.ndarray,
    max_events: int = 200000,
) -> np.ndarray:
    """Draw warped events on a (H, W, 3) uint8 canvas: positive red,
    negative blue (reference event_warper_test.cpp:166-172)."""
    canvas = np.ascontiguousarray(base).copy()
    if canvas.ndim == 2:
        canvas = np.stack([canvas] * 3, axis=-1)
    if canvas.dtype != np.uint8:
        canvas = np.stack([normalize_robust(canvas[..., c]) for c in range(3)], -1)
    step = max(1, len(t) // max_events)
    t, x, y, pol = t[::step], x[::step], y[::step], pol[::step]
    lut = cam.bearing_lut()
    R = traj.evaluate(t).numpy()
    b = lut[y.astype(np.int64) * cam.width + x]
    rb = np.einsum("nij,nj->ni", R, b)
    phi = np.arctan2(rb[:, 0], rb[:, 2])
    theta = np.arcsin(np.clip(rb[:, 1] / np.linalg.norm(rb, axis=1), -1, 1))
    px = np.clip(
        np.floor(pano.width / 2.0 + phi * pano.fx + 0.5).astype(int),
        0,
        pano.width - 1,
    )
    py = np.clip(
        np.floor(pano.height / 2.0 + theta * pano.fy + 0.5).astype(int),
        0,
        pano.height - 1,
    )
    pos = pol > 0
    canvas[py[pos], px[pos]] = (255, 0, 0)
    canvas[py[~pos], px[~pos]] = (0, 0, 255)
    return canvas


def draw_sensor_fov(
    canvas: np.ndarray,
    R: np.ndarray,
    cam: PinholeCamera,
    pano: EquirectangularCamera,
    color=(0, 255, 0),
    marker: int = 5,
) -> np.ndarray:
    """Mark the warped sensor FOV center (+ outline corners) on the canvas
    (reference drawSensorFOV draws only the center marker)."""
    canvas = canvas.copy()
    lut = cam.bearing_lut().reshape(cam.height, cam.width, 3)
    pts = [lut[cam.height // 2, cam.width // 2]]
    # FOV outline: border pixels
    for yy in (0, cam.height - 1):
        for xx in range(0, cam.width, max(1, cam.width // 16)):
            pts.append(lut[yy, xx])
    for xx in (0, cam.width - 1):
        for yy in range(0, cam.height, max(1, cam.height // 16)):
            pts.append(lut[yy, xx])
    pm = warp_points_np(np.stack(pts), R, pano)
    px = np.clip(np.floor(pm[:, 0] + 0.5).astype(int), 0, pano.width - 1)
    py = np.clip(np.floor(pm[:, 1] + 0.5).astype(int), 0, pano.height - 1)
    # center cross
    cx, cy = px[0], py[0]
    for dd in range(-marker, marker + 1):
        canvas[np.clip(cy + dd, 0, pano.height - 1), cx] = color
        canvas[cy, np.clip(cx + dd, 0, pano.width - 1)] = color
    # outline dots
    canvas[py[1:], px[1:]] = color
    return canvas
