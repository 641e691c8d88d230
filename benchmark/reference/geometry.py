"""Plain geometry of the benchmark: SO(3), the order-2 cumulative rotation
spline, pinhole bearings, the equirectangular panorama, Sobel and median
filters. Plain torch (any device, any float dtype) and numpy, written from
the model's definitions; nothing here comes from the program under test.

The spline: knots P_i at times t_beg + i dt; at time t in segment s with
offset u = (t - t_beg) / dt - s in [0, 1),

    R(t) = P_s exp(u log(P_s^T P_{s+1})),

the order-2 (linear) cumulative B-spline on SO(3). Knots are updated by
left perturbations, P_i <- exp(x_i) P_i.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ORDER = 2  # the spline order every configuration of the benchmark states


def hat(v):
    """(..., 3) -> (..., 3, 3) skew matrices."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def exp_so3(v):
    """Rodrigues' formula, (..., 3) -> (..., 3, 3); the series near 0."""
    th2 = torch.sum(v * v, -1)
    small = th2 < 1e-16
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / (th * th))
    K = hat(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def log_so3(R):
    """(..., 3, 3) -> (..., 3) rotation vectors, for angles below pi. The
    angle is atan2(|w| / 2, (tr R - 1) / 2), w = vee(R - R^T), which keeps
    its precision at small angles."""
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    s2 = torch.sum(w * w, -1)
    small = s2 < 1e-30
    s = 0.5 * torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    th = torch.atan2(s, c)
    k = torch.where(small, torch.full_like(s, 0.5), th / (2.0 * s))
    return k[..., None] * w


def angle_deg(Ra, Rb):
    """Geodesic angle between rotations (..., 3, 3), in degrees."""
    return torch.rad2deg(torch.linalg.norm(log_so3(Ra.transpose(-1, -2) @ Rb), dim=-1))


def locate(t, t_beg: float, dt: float, num_knots: int):
    """Times -> (segment s, offset u), numpy f64, s clamped to the valid
    segments [0, K - 2]."""
    rel = (np.asarray(t, np.float64) - t_beg) / dt
    s = np.clip(np.floor(rel).astype(np.int64), 0, num_knots - ORDER)
    return s, rel - s


def spline_eval(knots, s, u):
    """R at segments ``s`` (Q,) and offsets ``u`` (Q,) of ``knots`` (K, 3, 3)."""
    s = torch.as_tensor(s, device=knots.device).long()
    u = torch.as_tensor(u, dtype=knots.dtype, device=knots.device)
    p0, p1 = knots[s], knots[s + 1]
    return p0 @ exp_so3(u[:, None] * log_so3(p0.transpose(-1, -2) @ p1))


def fit_knots(times, rotations, t_beg: float, t_end: float, dt: float) -> np.ndarray:
    """Knots of the spline that follows discrete poses, numpy f64: the span
    is cut into intervals of ``dt``; in each, the poses strictly inside it
    are lifted to the tangent space at the interval's first pose, the two
    knots at its ends are the least-squares fit of the lifted poses by
    linear interpolation in time, and the interval's first knot is dropped
    after the first interval (it is the previous interval's last)."""
    times = np.asarray(times, np.float64)
    rots = np.asarray(rotations, np.float64)
    count = int(np.floor((t_end - t_beg) / dt + 1e-6))
    out = []
    for i in range(count):
        lo = t_beg + i * dt
        hi = lo + dt
        m = (times > lo) & (times < hi)
        tm, Rm = times[m], rots[m]
        if len(tm) < 2:
            raise ValueError(f"fit_knots: {len(tm)} poses in ({lo}, {hi}); need 2")
        base = Rm[0]
        lifted = log_so3(torch.from_numpy(np.einsum("ji,mjk->mik", base, Rm))).numpy()
        u = (tm - lo) / dt
        A = np.stack([1.0 - u, u], axis=1)
        sol = np.linalg.lstsq(A, lifted, rcond=None)[0]
        knots = np.einsum("ij,mjk->mik", base, exp_so3(torch.from_numpy(sol)).numpy())
        out.append(knots if i == 0 else knots[1:])
    return np.concatenate(out, axis=0)


def bearings(width: int, height: int, cam: dict, dtype=torch.float64, device="cpu"):
    """Unit bearings (H*W, 3) of a pinhole sensor, row-major. ``cam``: ``fx``,
    ``fy``, ``cx``, ``cy`` and ``dist``, the plumb_bob coefficients (k1, k2,
    p1, p2, k3; all 0 or left out for none), inverted by 8 fixed-point
    steps from the distorted normalized point."""
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float64, device=device),
                            torch.arange(width, dtype=torch.float64, device=device),
                            indexing="ij")
    x0, y0 = (xs - cam["cx"]) / cam["fx"], (ys - cam["cy"]) / cam["fy"]
    k1, k2, p1, p2, k3 = (list(cam.get("dist", [])) + [0.0] * 5)[:5]
    x, y = x0, y0
    if any(c != 0 for c in (k1, k2, p1, p2, k3)):
        for _ in range(8):
            r2 = x * x + y * y
            icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
            x, y = (x0 - dx) * icdist, (y0 - dy) * icdist
    rays = torch.stack([x, y, torch.ones_like(x)], -1).reshape(-1, 3)
    return (rays / torch.linalg.norm(rays, dim=1, keepdim=True)).to(dtype)


def project(rb, pano_width: int, pano_height: int):
    """Equirectangular projection of (N, 3) rays: x = W/2 + atan2(x, z) W /
    (2 pi), y = H/2 + asin(y / |r|) H / pi."""
    rho = torch.linalg.norm(rb, dim=1)
    phi = torch.atan2(rb[:, 0], rb[:, 2])
    theta = torch.asin(torch.clamp(rb[:, 1] / rho, -1.0, 1.0))
    return (pano_width / 2.0 + phi * (pano_width / (2.0 * math.pi)),
            pano_height / 2.0 + theta * (pano_height / math.pi))


def sobel(G):
    """Sobel x and y derivatives over 8, reflect-101 border: (gx, gy)."""
    P = torch.nn.functional.pad(G[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]
    sy = P[:-2] + 2.0 * P[1:-1] + P[2:]
    sx = P[:, :-2] + 2.0 * P[:, 1:-1] + P[:, 2:]
    return (sy[:, 2:] - sy[:, :-2]) / 8.0, (sx[2:] - sx[:-2]) / 8.0


def median3(img):
    """3x3 median with replicated borders, computed in float32 (as OpenCV's
    medianBlur of a CV_32F map), returned in float64."""
    x = torch.as_tensor(img).to(torch.float32)
    p = torch.nn.functional.pad(x[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    h, w = x.shape
    stack = torch.stack([p[i:i + h, j:j + w] for i in range(3) for j in range(3)])
    return torch.sort(stack, dim=0).values[4].to(torch.float64)
