"""Cumulative uniform SO(3) B-spline trajectory, order-parametric (N=2, N=4).

Counterpart of ``emba_tpu/spline.py``. :func:`evaluate` runs in torch on
any device, with the analytic knot Jacobians. The host half (blending
matrices, time bucketing, fitting and :class:`Trajectory`) is numpy in f64,
as in the reference, copied here because the reference module imports JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import lie


_binom = math.comb  # the reference's name (emba_tpu.spline._binom)


def blending_matrix(order: int, cumulative: bool = True) -> np.ndarray:
    """Uniform B-spline blending matrix M (order x order), with
    ``coeff = M @ [1, u, u^2, ...]^T``."""
    n = order
    m = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for j in range(n):
            s = sum(
                (-1.0) ** (k - j) * math.comb(n, k - j) * (n - k - 1.0) ** (n - 1.0 - i)
                for k in range(j, n)
            )
            m[j, i] = math.comb(n - 1, n - 1 - i) * s
    if cumulative:
        for i in range(n):
            for j in range(i + 1, n):
                m[i] += m[j]
    return m / math.factorial(n - 1)


@functools.lru_cache(maxsize=None)
def _blend(order: int, dtype, device):
    """The cumulative blending matrix on the device, copied there once: a
    host-to-device copy inside :func:`evaluate` would synchronize, and
    could not be captured in a CUDA graph."""
    return torch.as_tensor(blending_matrix(order, cumulative=True), dtype=dtype,
                           device=device)


def evaluate(knots, s, u, order: int, need_jacobian: bool = True):
    """Evaluate the cumulative SO(3) B-spline at query points.

    Args:
      knots: (K, 3, 3) rotation tensor (control poses).
      s: (Q,) integer segment start indices (first involved knot).
      u: (Q,) normalized offsets in [0, 1).
      order: spline order N (2 = linear, 4 = cubic).
      need_jacobian: also return d(left-pert of R(t)) / d(left-pert of
        knot s+i) for i in [0, N).

    Returns R (Q, 3, 3) and, if ``need_jacobian``, J (Q, N, 3, 3), on the
    device and in the dtype of ``knots``.
    """
    dtype, device = knots.dtype, knots.device
    u = torch.as_tensor(u, dtype=dtype, device=device)
    s = torch.as_tensor(s, device=device).long()

    n = order
    blend = _blend(n, dtype, device)
    powers = torch.stack([u**i for i in range(n)], dim=-1)  # (Q, N)
    coeff = powers @ blend.T  # (Q, N)

    idx = s[:, None] + torch.arange(n, device=device)[None, :]
    P = knots[idx]  # (Q, N, 3, 3)

    res = P[:, 0]
    if need_jacobian:
        j_helper = torch.eye(3, dtype=dtype, device=device).expand(res.shape)
        j_out = []
    for i in range(n - 1):
        p0 = P[:, i]
        p1 = P[:, i + 1]
        delta = lie.log(p0.transpose(-1, -2) @ p1)  # (Q, 3)
        c = coeff[:, i + 1]
        kdelta = c[:, None] * delta
        if need_jacobian:
            jl_inv_delta = lie.left_jacobian_inv(delta)
            jl_kdelta = lie.left_jacobian(kdelta)
            a = c[:, None, None] * (
                res @ jl_kdelta @ jl_inv_delta @ p0.transpose(-1, -2)
            )
            j_out.append(j_helper - a)
            j_helper = a
        res = res @ lie.exp(kdelta)
    if need_jacobian:
        j_out.append(j_helper)
        return res, torch.stack(j_out, dim=1)
    return res


def evaluate_derivatives(knots, s, u, dt: float, order: int, degree: int = 2):
    """Time derivatives of the cumulative SO(3) B-spline in the body frame:
    angular velocity, acceleration and jerk (counterpart of
    ``emba_tpu.spline.evaluate_derivatives``; unused by the BA, part of the
    trajectory layer). With ``R = P_s prod_j A_j``, ``A_j = exp(c_j(u)
    delta_j)`` about a fixed axis per factor, the forward recursions over
    the factors are

      V_j   = A_j^T V_{j-1} + cdot_j delta_j
      Vd_j  = A_j^T Vd_{j-1} - cdot_j delta_j x (A_j^T V_{j-1}) + cddot_j delta_j
      Vdd_j = A_j^T Vdd_{j-1} - 2 cdot_j delta_j x (A_j^T Vd_{j-1})
              - cddot_j delta_j x (A_j^T V_{j-1})
              + cdot_j^2 delta_j x (delta_j x (A_j^T V_{j-1})) + cdddot_j delta_j

    with the c-derivatives from the cumulative blending polynomial and
    ``du/dt = 1/dt``.

    Args: knots (K, 3, 3); s (Q,) segment starts; u (Q,) offsets; dt the
    knot spacing [s]; order N >= 2; degree 1 = velocity, 2 = + acceleration,
    3 = + jerk. Returns (R, omega[, alpha[, jerk]]): R (Q, 3, 3), each
    derivative (Q, 3), in the dtype and on the device of ``knots``.
    """
    dtype, device = knots.dtype, knots.device
    u = torch.as_tensor(u, dtype=dtype, device=device)
    s = torch.as_tensor(s, device=device).long()
    n = order
    blend = _blend(n, dtype, device)

    def upow(deriv: int):
        # d^deriv/du^deriv of [1, u, u^2, ...]
        cols = []
        for i in range(n):
            fac = 1.0
            for k in range(deriv):
                fac *= i - k
            cols.append(fac * u ** (i - deriv) if i >= deriv else torch.zeros_like(u))
        return torch.stack(cols, dim=-1)  # (Q, N)

    coeff = upow(0) @ blend.T
    dcoeff = (upow(1) @ blend.T) / dt
    ddcoeff = (upow(2) @ blend.T) / dt**2 if degree >= 2 else None
    dddcoeff = (upow(3) @ blend.T) / dt**3 if degree >= 3 else None

    idx = s[:, None] + torch.arange(n, device=device)[None, :]
    P = knots[idx]  # (Q, N, 3, 3)
    res = P[:, 0]
    V = Vd = Vdd = torch.zeros(u.shape + (3,), dtype=dtype, device=device)
    for i in range(n - 1):
        delta = lie.log(P[:, i].transpose(-1, -2) @ P[:, i + 1])  # (Q, 3)
        A = lie.exp(coeff[:, i + 1][:, None] * delta)
        At = A.transpose(-1, -2)

        def rot(x):
            return torch.einsum("qij,qj->qi", At, x)

        cd = dcoeff[:, i + 1][:, None]
        tV = rot(V)
        if degree >= 3:
            cdd = ddcoeff[:, i + 1][:, None]
            cddd = dddcoeff[:, i + 1][:, None]
            tVd = rot(Vd)
            Vdd = (rot(Vdd) - 2.0 * cd * torch.cross(delta, tVd, dim=-1)
                   - cdd * torch.cross(delta, tV, dim=-1)
                   + cd**2 * torch.cross(delta, torch.cross(delta, tV, dim=-1), dim=-1)
                   + cddd * delta)
        if degree >= 2:
            cdd = ddcoeff[:, i + 1][:, None]
            Vd = rot(Vd) - cd * torch.cross(delta, tV, dim=-1) + cdd * delta
        V = tV + cd * delta
        res = res @ A
    return (res, V) + ((Vd,) if degree >= 2 else ()) + ((Vdd,) if degree >= 3 else ())


# ---------------------------------------------------------------------------
# Host-side time bucketing and fitting (numpy, f64).
# ---------------------------------------------------------------------------


def locate(t, t_beg: float, dt: float, num_knots: int, order: int):
    """Absolute times -> (segment index s, normalized offset u), f64 host,
    clamped to the valid segment range [0, K - N]."""
    t = np.asarray(t, dtype=np.float64)
    rel = (t - t_beg) / dt
    s = np.floor(rel).astype(np.int64)
    s = np.clip(s, 0, num_knots - order)
    u = rel - s
    return s.astype(np.int32), u


def fit_knots(times, rotations, t_beg: float, dt: float, num_knots: int,
              order: int) -> np.ndarray:
    """Fit spline knots to discrete poses by lift-solve-retract (host, f64):
    log-map the poses relative to the first, solve per axis in the tangent
    space, retract with the offset. Valid for short intervals."""
    times = np.asarray(times, dtype=np.float64)
    rotations = np.asarray(rotations, dtype=np.float64)
    if len(times) < num_knots:
        raise ValueError(
            f"need >= {num_knots} poses to fit {num_knots} knots, got {len(times)}"
        )
    offset = rotations[0]
    rel = np.einsum("ji,mjk->mik", offset, rotations)  # offset^T @ R_m
    d = _np_log(rel)  # (M, 3)

    m_blend = blending_matrix(order, cumulative=False)
    nmat = np.zeros((len(times), num_knots), dtype=np.float64)
    rel_t = (times - t_beg) / dt
    seg = np.clip(np.floor(rel_t).astype(np.int64), 0, num_knots - order)
    u = rel_t - seg
    upow = np.stack([u**i for i in range(order)], axis=-1)  # (M, N)
    weights = upow @ m_blend.T
    for j in range(order):
        nmat[np.arange(len(times)), seg + j] = weights[:, j]

    sol, *_ = np.linalg.lstsq(nmat, d, rcond=None)
    return np.einsum("ij,mjk->mik", offset, _np_exp(sol))


def fit_knots_long(times, rotations, t_beg: float, t_end: float, dt: float,
                   order: int, sub_interval: float | None = None) -> np.ndarray:
    """Chunked fitting for long intervals: fit each ``sub_interval``
    independently and merge, dropping the shared head knots of every chunk
    after the first."""
    if sub_interval is None:
        sub_interval = dt
    times = np.asarray(times, dtype=np.float64)
    rotations = np.asarray(rotations, dtype=np.float64)
    num_chunks = int(np.floor((t_end - t_beg) / sub_interval + 1e-6))
    head = order - 1
    out: list[np.ndarray] = []
    for i in range(num_chunks):
        c_beg = t_beg + i * sub_interval
        c_end = c_beg + sub_interval
        mask = (times > c_beg) & (times < c_end)
        n_k = int(round(sub_interval / dt)) + order - 1
        chunk = fit_knots(times[mask], rotations[mask], c_beg, dt, n_k, order)
        out.append(chunk if i == 0 else chunk[head:])
    return np.concatenate(out, axis=0)


def _np_log(R: np.ndarray) -> np.ndarray:
    """Batched f64 SO(3) log on host."""
    tr = np.trace(R, axis1=-2, axis2=-1)
    ct = np.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(ct)
    small = th < 1e-7
    sin_safe = np.where(small, 1.0, np.sin(th))
    k = np.where(small, 0.5 + th**2 / 12.0, th / (2.0 * sin_safe))
    w = np.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    return k[..., None] * w


def _np_exp(v: np.ndarray) -> np.ndarray:
    """Batched f64 SO(3) exp on host."""
    th = np.linalg.norm(v, axis=-1)
    small = th < 1e-7
    th_safe = np.where(small, 1.0, th)
    K = np.zeros(v.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -v[..., 2], v[..., 1]
    K[..., 1, 0], K[..., 1, 2] = v[..., 2], -v[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -v[..., 1], v[..., 0]
    a = np.where(small, 1.0 - th**2 / 6.0, np.sin(th_safe) / th_safe)
    b = np.where(small, 0.5 - th**2 / 24.0, (1.0 - np.cos(th_safe)) / th_safe**2)
    return np.eye(3) + a[..., None, None] * K + b[..., None, None] * (K @ K)


@dataclasses.dataclass
class Trajectory:
    """Uniform cumulative SO(3) B-spline trajectory: f64 numpy knots plus
    (t_beg, dt, order); evaluation goes through the torch :func:`evaluate`
    on the CPU in f64."""

    t_beg: float
    dt: float
    knots: np.ndarray  # (K, 3, 3) f64
    order: int = 2

    @classmethod
    def empty(cls, t_beg: float, dt: float, order: int = 2) -> "Trajectory":
        return cls(t_beg=t_beg, dt=dt, knots=np.zeros((0, 3, 3)), order=order)

    @classmethod
    def from_poses(cls, times, rotations, t_beg: float, t_end: float, dt: float,
                   order: int = 2, chunked: bool = True) -> "Trajectory":
        """Fit a trajectory from discrete (time, rotation) samples."""
        if chunked:
            knots = fit_knots_long(times, rotations, t_beg, t_end, dt, order)
        else:
            n_k = int(round((t_end - t_beg) / dt)) + order - 1
            knots = fit_knots(times, rotations, t_beg, dt, n_k, order)
        return cls(t_beg=t_beg, dt=dt, knots=knots, order=order)

    @property
    def num_knots(self) -> int:
        return len(self.knots)

    @property
    def t_end(self) -> float:
        """Last representable time (end of the final full segment)."""
        return self.t_beg + (self.num_knots - self.order + 1) * self.dt

    def knot_time(self, i: int) -> float:
        return self.t_beg + i * self.dt

    def locate(self, t):
        return locate(t, self.t_beg, self.dt, self.num_knots, self.order)

    def evaluate(self, t, need_jacobian: bool = False):
        """R(t) (and optionally the knot Jacobians) as f64 CPU tensors."""
        s, u = self.locate(np.atleast_1d(t))
        knots = torch.from_numpy(np.ascontiguousarray(self.knots, np.float64))
        return evaluate(knots, torch.from_numpy(s), torch.from_numpy(u),
                        self.order, need_jacobian)

    def pushback(self, knots: np.ndarray) -> None:
        self.knots = np.concatenate([self.knots, np.asarray(knots)], axis=0)

    def incremental_update(self, drotv: np.ndarray, idx_beg: int = 0) -> "Trajectory":
        """Left-multiplicative knot update ``P_i <- exp(d_i) P_i``."""
        if idx_beg + len(drotv) != self.num_knots:
            raise ValueError("drotv must cover the knots from idx_beg to the end")
        upd = self.knots.copy()
        upd[idx_beg:] = _np_exp(np.asarray(drotv)) @ upd[idx_beg:]
        return dataclasses.replace(self, knots=upd)

    def clone(self) -> "Trajectory":
        return dataclasses.replace(self, knots=self.knots.copy())

    def segment(self, idx_beg: int, idx_end: int) -> "Trajectory":
        """Clone knots [idx_beg, idx_end) as a new trajectory."""
        return Trajectory(
            t_beg=self.t_beg + idx_beg * self.dt,
            dt=self.dt,
            knots=self.knots[idx_beg:idx_end].copy(),
            order=self.order,
        )

    def replace_with(self, src: "Trajectory", num_copy: int, idx_src: int,
                     idx_dst: int) -> None:
        """Overwrite knots from another trajectory."""
        self.knots[idx_dst: idx_dst + num_copy] = src.knots[idx_src: idx_src + num_copy]

    def write_tum(self, path: str, time_offset: float = 0.0) -> None:
        """Write knots as a TUM-format trajectory txt."""
        quats = lie.matrix_to_quat(torch.from_numpy(self.knots)).numpy()
        with open(path, "w") as f:
            for i in range(self.num_knots):
                t = self.knot_time(i) - time_offset
                qx, qy, qz, qw = quats[i]
                f.write(f"{t} 0.0 0.0 0.0 {qx} {qy} {qz} {qw}\n")
