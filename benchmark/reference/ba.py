"""The plain reference of one bundle-adjustment window: the window a
pipeline run prepares from its inputs, and its Levenberg-Marquardt solve,
written from the model's definitions in plain torch (float64 by default,
any device). It imports nothing of the program under test and takes
nothing it made: from the same events, front-end poses and initial maps it
works out again the event cut, the pose fit, the pairing, the map filter,
the Jacobians (by forward-mode automatic differentiation), the normal
equations and their Schur solve.

The model (LEGM, the linearized event generation model): event k at sensor
pixel q is paired with the previous event p at q. Both are warped onto the
panorama by the spline's rotation at the middle of their batch of
``event_batch_size`` events: pm_k, pm_p; dp = pm_k - pm_p. An inlier has a
previous event and |dp| <= ``outlier_dp_norm``. Its residual, at the
panorama pixel nearest pm_k,

    e = pol_k c_th - G(pix) . dp,   pol_k = +-1,

and the cost is 1/2 sum e^2 + alpha/2 (|Gx|^2 + |Gy|^2). A pixel is active
when ``thres_valid_pixel`` inliers or more sample it. Gauss-Newton takes
the derivative of the prediction G . dp: (G + H dp) . d pm_k - G . d pm_p
for the knots (H the symmetrized Sobel derivatives of the maps), dp for the
map values at pix. The normal equations hold the inliers on active pixels
and the regularizer on active pixels; the map values of inactive pixels are
set to 0 by each step. The first window's first knot is held fixed.

LM schedule: lambda starts at 1e-3; a step is accepted when it lowers the
cost (lambda / 10), else rejected (lambda x 10); A11 and each pixel's 2x2
block are damped by (1 + lambda) on their diagonals; the loop stops after
``max_num_iter`` + 1 steps, when lambda leaves [1e-300, 1e3], or when an
accepted step changed the cost by less than ``tol_fun`` (relative) for the
``num_times_tol_fun_sat``-th time without a reject between.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import geometry as geo


@dataclasses.dataclass
class Window:
    bear: torch.Tensor  # (N, 3) bearing of each event
    pol: torch.Tensor  # (N,) +-1
    prev: torch.Tensor  # (N,) long, previous event at the pixel (0 if none)
    has_prev: torch.Tensor  # (N,) bool
    bid: torch.Tensor  # (N,) long batch of each event
    bs: torch.Tensor  # (NB,) long spline segment of each batch
    bu: torch.Tensor  # (NB,) offset of each batch
    num_knots: int


@dataclasses.dataclass
class State:
    knots: torch.Tensor
    gx: torch.Tensor
    gy: torch.Tensor


def prepare_window(st: dict, events, num_knots: int, device="cpu",
                   dtype=torch.float64) -> Window:
    """The whole-span window of ``st`` (the configuration's settings) from
    the events handed to the program ((t, x, y, pol) in numpy): the BA
    interval cut, the window's events (a whole number of batches), each
    event's previous event at its pixel, and each batch's spline segment
    and offset at its middle time for a spline of ``num_knots`` knots."""
    t, x, y, pol = (np.asarray(a) for a in events)
    order = np.argsort(t, kind="stable")
    t, x, y, pol = t[order], x[order], y[order], pol[order]
    t0, t1 = st["start_time"], st["stop_time"]
    m = (t >= t0 + 1e-6) & (t <= t1)
    t, x, y, pol = t[m], x[m], y[m], pol[m]
    lo = np.searchsorted(t, t0 + 1e-3, side="right")
    hi = np.searchsorted(t, t0 + (t1 - t0) - 1e-3, side="right")
    nb_size = st["event_batch_size"]
    n = (hi - lo) // nb_size * nb_size
    t, x, y, pol = t[lo:lo + n], x[lo:lo + n], y[lo:lo + n], pol[lo:lo + n]

    pix = y.astype(np.int64) * st["sensor_width"] + x.astype(np.int64)
    by_pix = np.argsort(pix, kind="stable")
    same = pix[by_pix][1:] == pix[by_pix][:-1]
    prev = np.full(n, -1, np.int64)
    prev[by_pix[1:][same]] = by_pix[:-1][same]
    first, last = t[0::nb_size], t[nb_size - 1::nb_size]
    bs, bu = geo.locate(first + 0.5 * (last - first), t0, st["dt_knots"], num_knots)

    lut = geo.bearings(st["sensor_width"], st["sensor_height"], st["camera"], dtype, device)

    def dev(a, dt=None):
        return torch.as_tensor(a).to(device=device, dtype=dt)

    return Window(
        bear=lut[dev(pix)], pol=dev(2.0 * pol.astype(np.float64) - 1.0, dtype),
        prev=dev(np.maximum(prev, 0)), has_prev=dev(prev >= 0),
        bid=dev(np.arange(n) // nb_size), bs=dev(bs), bu=dev(bu, dtype),
        num_knots=num_knots)


def start_state(st: dict, pose_times, pose_rotations, init_gx, init_gy,
                device="cpu", dtype=torch.float64) -> State:
    """The window's start: the spline fitted to the front-end poses inside
    the BA interval, and the initial maps through a 3x3 median filter."""
    t0, t1 = st["start_time"], st["stop_time"]
    t_end = t0 + (t1 - t0)
    pt = np.asarray(pose_times, np.float64)
    pm = (pt > t0) & (pt < t_end)
    knots = geo.fit_knots(pt[pm], np.asarray(pose_rotations)[pm], t0, t_end,
                          st["dt_knots"])
    return State(torch.as_tensor(knots).to(device, dtype),
                 geo.median3(init_gx).to(device, dtype),
                 geo.median3(init_gy).to(device, dtype))


def warp(win: Window, knots, W: int, H: int, eps=None):
    """(2, N) panorama positions of the events; ``eps`` (NB, 2, 3): a left
    perturbation of each batch's two knots (first order), for derivatives."""
    p0, p1 = knots[win.bs], knots[win.bs + 1]
    if eps is not None:
        eye = torch.eye(3, dtype=knots.dtype, device=knots.device)
        p0 = (eye + geo.hat(eps[:, 0])) @ p0
        p1 = (eye + geo.hat(eps[:, 1])) @ p1
    R = p0 @ geo.exp_so3(win.bu[:, None] * geo.log_so3(p0.transpose(-1, -2) @ p1))
    rb = torch.einsum("nij,nj->ni", R[win.bid], win.bear)
    return torch.stack(geo.project(rb, W, H))


def warp_jacobian(win: Window, knots, W: int, H: int):
    """(pm (2, N), dpm (6, 2, N)): positions and their derivatives by the
    left perturbations of each event's two knots (3 of the first, 3 of the
    second), by forward-mode differentiation."""
    nb = win.bs.shape[0]
    zero = torch.zeros((nb, 2, 3), dtype=knots.dtype, device=knots.device)
    cols = []
    pm = None
    for d in range(6):
        tan = torch.zeros_like(zero)
        tan[:, d // 3, d % 3] = 1.0
        pm, dpm = torch.func.jvp(lambda e: warp(win, knots, W, H, e), (zero,), (tan,))
        cols.append(dpm)
    return pm, torch.stack(cols)


def accumulator(dtype):
    """The dtype sums are taken in: the state's, and float32 for bfloat16
    (as bfloat16 arithmetic units accumulate)."""
    return torch.promote_types(dtype, torch.float32)


@dataclasses.dataclass
class Linearization:
    cost: torch.Tensor
    e: torch.Tensor
    dp: torch.Tensor  # (2, N)
    pix: torch.Tensor  # (N,) long
    used: torch.Tensor  # (N,) bool: inlier on an active pixel
    active: torch.Tensor  # (HW,) bool


def objective(st: dict, win: Window, s: State, pm=None) -> Linearization:
    """Residuals, activity and cost at state ``s``."""
    H, W = s.gx.shape
    if pm is None:
        pm = warp(win, s.knots, W, H)
    dp = pm - pm[:, win.prev]
    inlier = win.has_prev & (torch.sum(dp * dp, 0) <= st["outlier_dp_norm"] ** 2)
    px = torch.clamp(torch.floor(pm[0] + 0.5).long(), 0, W - 1)
    py = torch.clamp(torch.floor(pm[1] + 0.5).long(), 0, H - 1)
    pix = py * W + px
    g = torch.stack([s.gx.reshape(-1), s.gy.reshape(-1)])[:, pix]
    e = torch.where(inlier, win.pol * st["c_th"] - torch.sum(g * dp, 0),
                    torch.zeros_like(dp[0]))
    count = torch.zeros(H * W, dtype=torch.long, device=e.device)
    count.index_add_(0, pix, inlier.long())
    active = count >= st["thres_valid_pixel"]
    acc = accumulator(e.dtype)
    ea, gxa, gya = e.to(acc), s.gx.to(acc), s.gy.to(acc)
    cost = 0.5 * torch.sum(ea * ea) + 0.5 * st["alpha"] * (
        torch.sum(gxa * gxa) + torch.sum(gya * gya))
    return Linearization(cost, e, dp, pix, inlier & active[pix], active)


@dataclasses.dataclass
class System:
    A11: torch.Tensor  # (3K, 3K)
    b1: torch.Tensor
    A12: torch.Tensor  # (2, R, 3K): the Gx and the Gy rows of the active pixels
    a22: torch.Tensor  # (3, R): xx, xy, yy
    b2: torch.Tensor  # (2, R)
    rows: torch.Tensor  # (R,) pixel of each row
    active: torch.Tensor  # (HW,) bool


def form(st: dict, win: Window, s: State, chunk: int = 1 << 18) -> System:
    """The normal equations at state ``s``."""
    H, W = s.gx.shape
    dt, device = accumulator(s.gx.dtype), s.gx.device
    pm, dpm = warp_jacobian(win, s.knots, W, H)
    lin = objective(st, win, s, pm)
    nk3 = 3 * win.num_knots
    idx = torch.nonzero(lin.used)[:, 0]
    rows = torch.nonzero(lin.active)[:, 0]
    row_of = torch.full((H * W,), -1, dtype=torch.long, device=device)
    row_of[rows] = torch.arange(rows.shape[0], device=device)
    gxx, gxy_ = geo.sobel(s.gx)
    gyx, gyy = geo.sobel(s.gy)
    hmaps = torch.stack([s.gx.reshape(-1), s.gy.reshape(-1), gxx.reshape(-1),
                         (0.5 * (gxy_ + gyx)).reshape(-1), gyy.reshape(-1)])
    A11 = torch.zeros((nk3, nk3), dtype=dt, device=device)
    b1 = torch.zeros(nk3, dtype=dt, device=device)
    A12 = torch.zeros((2, rows.shape[0] * nk3), dtype=dt, device=device)
    a22 = torch.zeros((3, rows.shape[0]), dtype=dt, device=device)
    b2 = torch.zeros((2, rows.shape[0]), dtype=dt, device=device)
    offs = torch.arange(6, device=device)
    for lo in range(0, idx.shape[0], chunk):
        k = idx[lo:lo + chunk]
        p = win.prev[k]
        dx, dy = lin.dp[0, k], lin.dp[1, k]
        e = lin.e[k]
        g = hmaps[:, lin.pix[k]]
        tx = g[0] + dx * g[2] + dy * g[3]
        ty = g[1] + dx * g[3] + dy * g[4]
        jc = tx * dpm[:, 0, k] + ty * dpm[:, 1, k]  # (6, n)
        jp = -g[0] * dpm[:, 0, p] - g[1] * dpm[:, 1, p]
        cc = 3 * win.bs[win.bid[k]][:, None] + offs  # (n, 6)
        cp = 3 * win.bs[win.bid[p]][:, None] + offs
        J = torch.zeros((k.shape[0], nk3), dtype=dt, device=device)
        J.scatter_add_(1, cc, jc.T.to(dt))
        J.scatter_add_(1, cp, jp.T.to(dt))
        e, dx, dy = e.to(dt), dx.to(dt), dy.to(dt)
        A11 += J.T @ J
        b1 += J.T @ e
        r = row_of[lin.pix[k]]
        for plane, d in enumerate((dx, dy)):
            flat = torch.cat([(r[:, None] * nk3 + cc).reshape(-1),
                              (r[:, None] * nk3 + cp).reshape(-1)])
            vals = torch.cat([(jc.to(dt) * d).T.reshape(-1), (jp.to(dt) * d).T.reshape(-1)])
            A12[plane].index_add_(0, flat, vals)
            b2[plane].index_add_(0, r, e * d)
        a22[0].index_add_(0, r, dx * dx)
        a22[1].index_add_(0, r, dx * dy)
        a22[2].index_add_(0, r, dy * dy)
    alpha = st["alpha"]
    a22[0] += alpha
    a22[2] += alpha
    b2[0] -= alpha * s.gx.reshape(-1)[rows].to(dt)
    b2[1] -= alpha * s.gy.reshape(-1)[rows].to(dt)
    return System(A11, b1, A12.reshape(2, rows.shape[0], nk3), a22, b2, rows, lin.active)


def step(st: dict, sysm: System, s: State, lam: float, fix_first: bool = True) -> State:
    """The damped Schur-complement solve and the trial state (NaN where the
    pose system cannot be factored, as the program's Cholesky gives; LM then
    rejects the step)."""
    dt, device = sysm.A11.dtype, s.gx.device
    nk3 = sysm.A11.shape[0]
    keep = torch.ones(nk3, dtype=dt, device=device)
    if fix_first:
        keep[:3] = 0.0
    A11 = sysm.A11 * keep[:, None] * keep[None, :] + torch.diag(1.0 - keep)
    b1 = sysm.b1 * keep
    Ax, Ay = sysm.A12[0] * keep, sysm.A12[1] * keep
    a = sysm.a22[0] * (1.0 + lam)
    b = sysm.a22[1]
    c = sysm.a22[2] * (1.0 + lam)
    det = a * c - b * b
    m00, m01, m11 = c / det, -b / det, a / det
    S = A11 + lam * torch.diag(torch.diag(A11))
    S = S - Ax.T @ (m00[:, None] * Ax + m01[:, None] * Ay) \
          - Ay.T @ (m01[:, None] * Ax + m11[:, None] * Ay)
    rhs = b1 - Ax.T @ (m00 * sysm.b2[0] + m01 * sysm.b2[1]) \
             - Ay.T @ (m01 * sysm.b2[0] + m11 * sysm.b2[1])
    S = S + (1e-10 * torch.clamp(torch.max(torch.diag(S)), min=1.0) + 1e-30) * torch.eye(
        nk3, dtype=dt, device=device)
    x1, info = torch.linalg.solve_ex(S, rhs)
    x1 = torch.where(info == 0, x1, torch.full_like(x1, float("nan")))
    vx = sysm.b2[0] - Ax @ x1
    vy = sysm.b2[1] - Ay @ x1
    damping = st["damping_factor"]
    H, W = s.gx.shape
    gx = torch.zeros(H * W, dtype=dt, device=device)
    gy = torch.zeros(H * W, dtype=dt, device=device)
    gx[sysm.rows] = s.gx.reshape(-1)[sysm.rows].to(dt) + damping * (m00 * vx + m01 * vy)
    gy[sysm.rows] = s.gy.reshape(-1)[sysm.rows].to(dt) + damping * (m01 * vx + m11 * vy)
    knots = geo.exp_so3(x1.reshape(-1, 3)) @ s.knots.to(dt)
    low = s.gx.dtype
    return State(knots.to(low), gx.reshape(H, W).to(low), gy.reshape(H, W).to(low))


@dataclasses.dataclass
class Result:
    state: State
    cost: float
    trace: list  # per step: (lambda, cost_min, cost_new, accepted)


def solve(st: dict, win: Window, s: State, fix_first: bool = True) -> Result:
    """The LM window from ``s``."""
    lam, count, it, conv = 1e-3, 0, 0, False
    cost_min = float(objective(st, win, s).cost)
    sysm = form(st, win, s)
    trace = []
    def running():
        return it <= st["max_num_iter"] and cost_min > 1e-16 and 1e-300 <= lam <= 1e3 and not conv

    while running():
        trial = step(st, sysm, s, lam)
        cost_new = float(objective(st, win, trial).cost)
        accept = cost_new < cost_min
        rel = abs(1.0 - cost_new / (cost_min + 1e-10))
        count = (count + int(rel < st["tol_fun"])) if accept else 0
        trace.append((lam, cost_min, cost_new, accept))
        lam = lam / 10.0 if accept else lam * 10.0
        if accept:
            s, cost_min = trial, cost_new
        conv = count >= st["num_times_tol_fun_sat"]
        it += 1
        if accept and running():
            sysm = form(st, win, s)
    return Result(s, cost_min, trace)
