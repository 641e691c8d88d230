"""Synthetic event generation: render a DVS event stream from a known
panorama and trajectory (counterpart of ``emba_tpu/synth.py``).

Host-side numpy in f64; the spline evaluation goes through the port's
torch :func:`spline.evaluate` on the CPU. Same inputs and seed give the
same scene as the reference module.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import spline
from .camera import EquirectangularCamera, PinholeCamera


def smooth_random_map(height: int, width: int, rng, smooth: int = 15, amp: float = 1.0):
    """A smooth random brightness panorama (separable box-filtered noise)."""
    B = rng.normal(size=(height, width))
    for _ in range(3):
        k = np.ones(smooth) / smooth
        B = np.apply_along_axis(
            lambda r: np.convolve(np.pad(r, smooth, mode="wrap"), k, "same")[
                smooth:-smooth
            ],
            1,
            B,
        )
        B = np.apply_along_axis(
            lambda c: np.convolve(np.pad(c, smooth, mode="reflect"), k, "same")[
                smooth:-smooth
            ],
            0,
            B,
        )
    return B / (np.abs(B).max() + 1e-12) * amp


def sobel_gradients_np(G):
    """Host Sobel/8 gradients with reflect-101 padding."""
    P = np.pad(G, 1, mode="reflect")
    sy = P[:-2, :] + 2.0 * P[1:-1, :] + P[2:, :]
    gx = (sy[:, 2:] - sy[:, :-2]) * 0.125
    sx = P[:, :-2] + 2.0 * P[:, 1:-1] + P[:, 2:]
    gy = (sx[2:, :] - sx[:-2, :]) * 0.125
    return gx, gy


def bilinear_sample(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    h, w = img.shape
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 2)
    fx = np.clip(x - x0, 0.0, 1.0)
    fy = np.clip(y - y0, 0.0, 1.0)
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )


@dataclasses.dataclass
class SyntheticScene:
    brightness: np.ndarray  # (H, W) panorama
    gx: np.ndarray  # GT gradient maps (Sobel/8 of brightness)
    gy: np.ndarray
    traj: spline.Trajectory  # GT trajectory
    cam: PinholeCamera
    pano: EquirectangularCamera
    t: np.ndarray
    x: np.ndarray
    y: np.ndarray
    pol: np.ndarray


def generate(
    rng,
    sensor: PinholeCamera,
    pano_width: int = 256,
    pano_height: int = 128,
    c_th: float = 0.2,
    t_beg: float = 0.0,
    t_end: float = 1.0,
    dt_knots: float = 0.05,
    num_steps: int = 400,
    motion_amp: float = 0.25,
    order: int = 2,
    brightness: np.ndarray | None = None,
) -> SyntheticScene:
    """Render an event stream by threshold-crossing the warped brightness:
    an event fires whenever a pixel's brightness change since its last
    event crosses +-c_th, timestamped by linear interpolation in the step."""
    H, W = pano_height, pano_width
    if brightness is None:
        brightness = smooth_random_map(H, W, rng, smooth=max(5, H // 16))
    gx, gy = sobel_gradients_np(brightness)

    tt = np.linspace(t_beg, t_end, 200)
    f = rng.uniform(0.5, 1.5, size=3)
    ph = rng.uniform(0, 2 * np.pi, size=3)
    amp = motion_amp * rng.uniform(0.5, 1.0, size=3)
    rotvec = np.stack(
        [amp[i] * np.sin(2 * np.pi * f[i] * tt + ph[i]) for i in range(3)], axis=-1
    )
    rotvec -= rotvec[0]  # start at identity
    traj = spline.Trajectory.from_poses(tt, spline._np_exp(rotvec), t_beg, t_end,
                                        dt_knots, order)

    pano = EquirectangularCamera(W, H)
    bearings = sensor.bearing_lut()  # (P, 3)

    ts = np.linspace(t_beg, t_end - 1e-9, num_steps)
    s, u = traj.locate(ts)
    Rts = spline.evaluate(torch.from_numpy(traj.knots), torch.from_numpy(s),
                          torch.from_numpy(u), order, need_jacobian=False).numpy()

    ref = None
    prev_val = None
    ev_t, ev_p, ev_pol = [], [], []
    cx_p, cy_p = W / 2.0, H / 2.0
    dt_step = ts[1] - ts[0]
    for k in range(num_steps):
        rb = bearings @ Rts[k].T
        phi = np.arctan2(rb[:, 0], rb[:, 2])
        theta = np.arcsin(np.clip(rb[:, 1] / np.linalg.norm(rb, axis=1), -1, 1))
        val = bilinear_sample(brightness, cx_p + phi * pano.fx, cy_p + theta * pano.fy)
        if ref is None:
            ref = val.copy()
            prev_val = val.copy()
            continue
        while True:
            diff = val - ref
            fire_pos = diff >= c_th
            fire = fire_pos | (diff <= -c_th)
            if not fire.any():
                break
            idx = np.nonzero(fire)[0]
            new_ref = ref[idx] + np.where(fire_pos[idx], c_th, -c_th)
            denom = val[idx] - prev_val[idx]
            denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
            frac = np.clip((new_ref - prev_val[idx]) / denom, 0.0, 1.0)
            ev_t.append(ts[k] - dt_step + frac * dt_step)
            ev_p.append(idx)
            ev_pol.append(fire_pos[idx].astype(np.int8))
            ref[idx] = new_ref
        prev_val = val.copy()

    t = np.concatenate(ev_t) if ev_t else np.zeros(0)
    p = np.concatenate(ev_p) if ev_p else np.zeros(0, np.int64)
    pol = np.concatenate(ev_pol) if ev_pol else np.zeros(0, np.int8)
    order_idx = np.argsort(t, kind="stable")
    return SyntheticScene(
        brightness=brightness,
        gx=gx,
        gy=gy,
        traj=traj,
        cam=sensor,
        pano=pano,
        t=t[order_idx],
        x=(p[order_idx] % sensor.width).astype(np.int32),
        y=(p[order_idx] // sensor.width).astype(np.int32),
        pol=pol[order_idx],
    )


def default_sensor(width: int = 64, height: int = 64, f: float = 60.0) -> PinholeCamera:
    """A small synthetic pinhole sensor (square, no distortion)."""
    K = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1.0]])
    return PinholeCamera.from_calib(width, height, K)
