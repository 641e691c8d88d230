"""LEGM: the Linearized Event Generation Model — residuals, Jacobians,
normal equations and the Schur solve, in torch.

Counterpart of the classic path of ``emba_tpu/model.py``:

* residual per paired events (prev, curr) at a sensor pixel
  ``e = 2(pol-0.5) C_th - G(pm_curr) . (pm_curr - pm_prev)``, with the
  outlier cut ``|dp| > outlier_dp_norm``;
* pose Jacobians ``Jc = (G + dp^T grad G) . dpm_curr/dcp``,
  ``Jp = -G . dpm_prev/dcp``; map Jacobian ``dp``;
* Schur-structured normal equations (A11, per-pixel 2x2 A22, A12, b1, b2)
  with the L2 map regularizer, formed by ``kernels.a12_accum`` (the CUDA
  kernel on the card, its plain version on the CPU);
* the Schur solve as two GEMMs over the A12 column planes and one Cholesky.

Per-event arrays keep the reference layouts: (N,) vectors, (3, N)
bearings, (D, N) Jacobians.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import lie, warp
from .camera import EquirectangularCamera
from .kernels import a12_accum

_LATER = {
    "compact_cap": "ROADMAP queue 1 item 10 (compact_cap)",
    "stream_chunk": "ROADMAP queue 1 item 11 (streamed tiers)",
    "stream_light": "ROADMAP queue 1 item 11 (streamed tiers)",
    "light_trial": "ROADMAP queue 1 item 10 (light_trial)",
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model configuration, the fields of the reference's
    ``ModelConfig``. The producer of the normal equations follows the
    device of the tensors, so there is no ``use_pallas``."""

    c_th: float = 0.2
    pano_width: int = 1024
    pano_height: int = 512
    thres_valid_pixel: int = 5
    alpha: float = 5.0
    outlier_dp_norm: float = 10.0
    use_irls: bool = False
    cost_type: str = "quadratic"  # quadratic | huber | cauchy
    eta: float = 1.0
    spline_order: int = 2
    compact_cap: int | None = None
    stream_chunk: int | None = None
    light_trial: bool = False
    sample_mode: str = "curr"  # curr | mid
    stream_light: bool = False

    def __post_init__(self):
        for name, where in _LATER.items():
            if getattr(self, name) not in (None, False):
                raise NotImplementedError(f"ModelConfig.{name}: not ported yet, see {where}")

    @property
    def num_pix(self) -> int:
        return self.pano_width * self.pano_height

    @property
    def dim_block(self) -> int:
        return 3 * self.spline_order

    @property
    def pano(self) -> EquirectangularCamera:
        return EquirectangularCamera(self.pano_width, self.pano_height)


# ---------------------------------------------------------------------------
# Map gradients.
# ---------------------------------------------------------------------------


def _reflect_pad(G):
    """BORDER_REFLECT_101 padding by 1 (OpenCV's Sobel default)."""
    return torch.nn.functional.pad(G[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]


def sobel_gradients(G):
    """3x3 Sobel x/y derivatives scaled by 1/8."""
    P = _reflect_pad(G)
    sy = P[:-2, :] + 2.0 * P[1:-1, :] + P[2:, :]  # (H, W+2)
    gx = (sy[:, 2:] - sy[:, :-2]) * 0.125
    sx = P[:, :-2] + 2.0 * P[:, 1:-1] + P[:, 2:]  # (H+2, W)
    gy = (sx[2:, :] - sx[:-2, :]) * 0.125
    return gx, gy


def second_order_gradients(Gx, Gy):
    """(Gxx, Gxy_sym, Gyy): Sobel of the gradient maps, mixed term
    symmetrized."""
    gxx, gxy = sobel_gradients(Gx)
    gyx, gyy = sobel_gradients(Gy)
    return gxx, 0.5 * (gxy + gyx), gyy


# ---------------------------------------------------------------------------
# Window data and per-measurement quantities.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceWindow:
    """Static per-window event data on the device."""

    bearings: torch.Tensor  # (3, N) per-event unit bearing vectors
    pol_signed: torch.Tensor  # (N,) +-1.0 (curr-event polarity sign)
    prev_idx: torch.Tensor  # (N,) int32, clipped to >= 0
    has_prev: torch.Tensor  # (N,) bool
    batch_ids: torch.Tensor  # (N,) int32 event -> pose batch
    batch_s: torch.Tensor  # (NB,) int32 spline segment per batch
    batch_u: torch.Tensor  # (NB,) normalized offset per batch (mid-time)
    sensor_pix: torch.Tensor | None = None  # (N,) int32 flat sensor pixel

    @classmethod
    def from_window(cls, win, bearing_lut: np.ndarray, sensor_width: int, dtype,
                    device):
        """Move an ``emba_tpu.pairing.EventWindow`` to ``device``."""
        spix = win.sensor_flat_idx(sensor_width)

        def t(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

        return cls(
            bearings=t(bearing_lut[spix].T, dtype),
            pol_signed=t(2.0 * (win.pol.astype(np.float64) - 0.5), dtype),
            prev_idx=t(np.maximum(win.prev_idx, 0).astype(np.int32), torch.int32),
            has_prev=t(win.prev_idx >= 0, torch.bool),
            batch_ids=t(win.batch_ids().astype(np.int32), torch.int32),
            batch_s=t(win.batch_s.astype(np.int32), torch.int32),
            batch_u=t(win.batch_u, dtype),
            sensor_pix=t(spix.astype(np.int32), torch.int32),
        )


@dataclasses.dataclass(frozen=True)
class Linearization:
    """Per-measurement quantities of one linearization. Measurement k is
    the event pair (prev_idx[k], k); non-measurements are masked to zero."""

    e: torch.Tensor  # (N,) residuals (0 for non-inliers)
    inlier: torch.Tensor  # (N,) bool
    pm_pix: torch.Tensor  # (N,) int32 flat pano pixel of the sampling point
    num_ev_map: torch.Tensor  # (HW,) int32 inlier count per pano pixel
    dx: torch.Tensor  # (N,) dM/dGx = dp_x
    dy: torch.Tensor  # (N,) dM/dGy = dp_y
    Jc: torch.Tensor  # (D, N) pose Jacobian, curr half
    Jp: torch.Tensor  # (D, N) pose Jacobian, prev half
    i_c: torch.Tensor  # (N,) int32 segment of curr event
    i_p: torch.Tensor  # (N,) int32 segment of prev event


def linearize(knots, Gx, Gy, dev: DeviceWindow, cfg: ModelConfig):
    """Warp + pair + residual + per-measurement Jacobians (the reference's
    derivative mode; its light ``need_deriv=False`` mode comes with
    ``light_trial``)."""
    pm, cp_idx, dpm_dcp = warp.warp_events(
        knots, dev.batch_s, dev.batch_u, dev.batch_ids, dev.bearings, cfg.pano,
        cfg.spline_order,
    )
    pmx, pmy = pm
    d = cfg.dim_block
    prev = dev.prev_idx.long()
    # (pmx, pmy) and the 2D Jacobian rows of the prev event in one gather
    prev_src = torch.cat([torch.stack([pmx, pmy]), dpm_dcp.reshape(2 * d, -1)])
    prev_g = prev_src[:, prev]
    return linearize_from_warp(
        pmx, pmy, cp_idx, dpm_dcp, prev_g[:2], prev_g[2:].reshape(2, d, -1),
        cp_idx[prev], dev.has_prev, dev.pol_signed, Gx, Gy, cfg,
    )


def _pair_residual(pmx, pmy, ppx, ppy, has_prev, pol_signed, gmaps, cfg):
    """Pairing displacement + residual. Returns (dx, dy, inlier, pm_pix,
    g_at, e), ``g_at`` the stacked map gather at pm_pix."""
    dx = pmx - ppx
    dy = pmy - ppy
    dp_norm2 = dx * dx + dy * dy
    inlier = has_prev & (dp_norm2 <= cfg.outlier_dp_norm**2)
    if cfg.sample_mode == "mid":
        sx = 0.5 * (pmx + ppx)
        sy = 0.5 * (pmy + ppy)
    else:
        sx, sy = pmx, pmy
    # nearest pano pixel: floor(s + 0.5), then the clip (std::round, s >= 0)
    px = torch.clamp(torch.floor(sx + 0.5).to(torch.int32), 0, cfg.pano_width - 1)
    py = torch.clamp(torch.floor(sy + 0.5).to(torch.int32), 0, cfg.pano_height - 1)
    pm_pix = py * cfg.pano_width + px

    g_at = gmaps[:, pm_pix.long()]  # (5, n), one gather
    c_pred = g_at[0] * dx + g_at[1] * dy
    c_meas = pol_signed * cfg.c_th
    e = torch.where(inlier, c_meas - c_pred, torch.zeros_like(c_pred))
    return dx, dy, inlier, pm_pix, g_at, e


def _pose_jac_coeffs(g_at, dx, dy, cfg):
    """(tx, ty, hx, hy): ``Jc = tx dpm_c[0] + ty dpm_c[1]``,
    ``Jp = hx dpm_p[0] + hy dpm_p[1]`` ("curr": the reference math; "mid":
    the symmetric midpoint halves)."""
    gx, gy = g_at[0], g_at[1]
    if cfg.sample_mode == "mid":
        sx = dx * g_at[2] + dy * g_at[3]
        sy = dx * g_at[3] + dy * g_at[4]
        return gx + 0.5 * sx, gy + 0.5 * sy, 0.5 * sx - gx, 0.5 * sy - gy
    return (
        gx + dx * g_at[2] + dy * g_at[3],
        gy + dx * g_at[3] + dy * g_at[4],
        -gx,
        -gy,
    )


def _stacked_gmaps(Gx, Gy):
    """(5, HW) stacked map planes: values and second-order gradients."""
    gxx, gxy, gyy = second_order_gradients(Gx, Gy)
    return torch.stack([Gx.reshape(-1), Gy.reshape(-1), gxx.reshape(-1),
                        gxy.reshape(-1), gyy.reshape(-1)])


def linearize_from_warp(pmx, pmy, cp_idx, dpm_dcp, pm_prev, dpm_prev, i_p,
                        has_prev, pol_signed, Gx, Gy, cfg: ModelConfig):
    """Residual + Jacobian core given warped curr events and their prev data."""
    gmaps = _stacked_gmaps(Gx, Gy)
    dx, dy, inlier, pm_pix, g_at, e = _pair_residual(
        pmx, pmy, pm_prev[0], pm_prev[1], has_prev, pol_signed, gmaps, cfg
    )
    num_ev_map = torch.zeros(cfg.num_pix, dtype=torch.int32, device=pmx.device)
    num_ev_map.index_add_(0, pm_pix.long(), inlier.to(torch.int32))

    tx, ty, hx, hy = _pose_jac_coeffs(g_at, dx, dy, cfg)
    Jc = tx[None, :] * dpm_dcp[0] + ty[None, :] * dpm_dcp[1]  # (D, N)
    Jp = hx[None, :] * dpm_prev[0] + hy[None, :] * dpm_prev[1]
    return Linearization(e=e, inlier=inlier, pm_pix=pm_pix, num_ev_map=num_ev_map,
                         dx=dx, dy=dy, Jc=Jc, Jp=Jp, i_c=cp_idx, i_p=i_p)


# ---------------------------------------------------------------------------
# Costs.
# ---------------------------------------------------------------------------


def data_cost(e, cfg: ModelConfig):
    if not cfg.use_irls:
        return 0.5 * torch.sum(e * e)
    a = cfg.eta
    if cfg.cost_type == "cauchy":
        return (0.5 / a) * torch.sum(torch.log1p(a * e * e))
    abs_e = torch.abs(e)
    quad = 0.5 * abs_e * abs_e
    lin = a * abs_e - 0.5 * a * a
    return torch.sum(torch.where(abs_e < a, quad, lin))


def reg_cost(Gx, Gy, alpha):
    return alpha * 0.5 * (torch.sum(Gx * Gx) + torch.sum(Gy * Gy))


def irls_weights(e, cfg: ModelConfig):
    """Per-measurement IRLS weights."""
    if not cfg.use_irls:
        return torch.ones_like(e)
    a = cfg.eta
    if cfg.cost_type == "cauchy":
        return 1.0 / (1.0 + a * e * e)
    abs_e = torch.abs(e)
    return torch.where(abs_e < a, torch.ones_like(e), a / torch.clamp(abs_e, min=1e-30))


# ---------------------------------------------------------------------------
# Normal equations.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NormalEq:
    """Schur-structured normal equations over the map row space. A12 is
    (R_pad, 2*dp_pad): the Gx plane in columns [0:dp_pad), the Gy plane in
    [dp_pad:2*dp_pad). Rows are pano pixels (R_pad >= HW)."""

    A11: torch.Tensor  # (3K, 3K)
    b1: torch.Tensor  # (3K,)
    a22_xx: torch.Tensor  # (R_pad,)
    a22_xy: torch.Tensor
    a22_yy: torch.Tensor
    b2_x: torch.Tensor
    b2_y: torch.Tensor
    A12: torch.Tensor  # (R_pad, 2*dp_pad)
    active: torch.Tensor  # (R_pad,) bool row validity
    pix2row: torch.Tensor  # (HW,) int32 pano pixel -> row
    active_pix: torch.Tensor  # (HW,) bool pixel-space activity
    active_count: torch.Tensor  # () int32
    dropped: torch.Tensor  # () int32, always 0 without compaction


def _row_space(num_ev_map, cfg: ModelConfig):
    """Active-pixel mask + the full-pixel-domain row space."""
    hw = cfg.num_pix
    active = num_ev_map >= cfg.thres_valid_pixel
    r_pad = a12_accum.round_up(hw, a12_accum.ROW_ALIGN)
    pix2row = torch.arange(hw, dtype=torch.int32, device=num_ev_map.device)
    row_active = torch.nn.functional.pad(active, (0, r_pad - hw))
    return active, r_pad, pix2row, row_active


def _meas_weights(e, inlier, pm_pix, active, cfg, dt):
    """Per-measurement weight wA: the IRLS weight of an inlier on an active
    pixel, else 0 (the kernel derives the residual weight wA * e itself)."""
    w = inlier & active[pm_pix.long()]
    yi = irls_weights(e, cfg)
    return torch.where(w, yi, torch.zeros_like(yi)).to(dt)


def form_normal_eq(lin: Linearization, Gx, Gy, cfg: ModelConfig, num_knots: int,
                   reg_scale=None) -> NormalEq:
    """Build the Schur-structured normal equations with the L2 map
    regularizer. A measurement enters iff it is an inlier and lands on an
    active pixel (>= thres_valid_pixel inliers)."""
    dt = lin.e.dtype
    dim_pose = 3 * num_knots
    active, r_pad, pix2row, row_active = _row_space(lin.num_ev_map, cfg)
    wA = _meas_weights(lin.e, lin.inlier, lin.pm_pix, active, cfg, dt)
    a12, px5, a11b = a12_accum.a12_accumulate(
        lin.pm_pix, lin.i_c, lin.i_p, lin.Jc, lin.Jp, lin.dx, lin.dy, lin.e, wA,
        r_pad, dim_pose, cfg.spline_order,
    )
    dp_pad = a12.shape[1] // 2
    dropped = torch.zeros((), dtype=torch.int32, device=lin.e.device)
    return _finish_normal_eq(
        a11b[:dim_pose, :dim_pose], a11b[dp_pad, :dim_pose], px5[:, 0], px5[:, 1],
        px5[:, 2], px5[:, 3], px5[:, 4], a12, row_active, pix2row, active, Gx, Gy,
        cfg, r_pad, dt, dropped, reg_scale,
    )


def _finish_normal_eq(A11, b1, a22xx, a22xy, a22yy, b2x, b2y, A12, row_active,
                      pix2row, active_pix, Gx, Gy, cfg, r_pad, dt, dropped,
                      reg_scale=None):
    """Apply the L2 map regularizer on active rows and assemble the
    NormalEq (rows are pixels: ``pix2row`` is the identity)."""
    alpha = cfg.alpha if reg_scale is None else cfg.alpha * reg_scale
    act_f = row_active.to(dt)
    hw = cfg.num_pix

    def to_rows(G):
        g = torch.where(active_pix, G.reshape(-1).to(dt), torch.zeros((), dtype=dt,
                                                                       device=G.device))
        return torch.nn.functional.pad(g, (0, r_pad - hw))

    gx_row, gy_row = to_rows(Gx), to_rows(Gy)
    return NormalEq(
        A11=A11,
        b1=b1,
        a22_xx=a22xx + alpha * act_f,
        a22_xy=a22xy,
        a22_yy=a22yy + alpha * act_f,
        b2_x=b2x - alpha * gx_row * act_f,
        b2_y=b2y - alpha * gy_row * act_f,
        A12=A12,
        active=row_active,
        pix2row=pix2row,
        active_pix=active_pix,
        active_count=torch.sum(active_pix.to(torch.int32)).to(torch.int32),
        dropped=dropped,
    )


# ---------------------------------------------------------------------------
# Solving.
# ---------------------------------------------------------------------------


def _damped_a22_inv(neq: NormalEq, lam):
    """Per-pixel inverse of the LM-damped 2x2 blocks; zero where inactive.
    A22m = A22 + lam * diag(A22)."""
    dt = neq.a22_xx.dtype
    a = neq.a22_xx * (1.0 + lam)
    b = neq.a22_xy
    c = neq.a22_yy * (1.0 + lam)
    det = a * c - b * b
    det_safe = torch.where(torch.abs(det) < 1e-30, torch.ones_like(det), det)
    mask = (neq.active & (torch.abs(det) >= 1e-30)).to(dt)
    inv = mask / det_safe
    return c * inv, -b * inv, a * inv  # m00, m01, m11


def solve_normal_eq(neq: NormalEq, lam, fix_first: bool = False):
    """Schur-complement solve:

      A11m = A11 + lam diag(A11);  A22m^-1 per 2x2 block;
      S = A11m - A12 A22m^-1 A12^T  (two GEMMs over the column planes);
      x1 = chol_solve(S, b1 - A12 A22m^-1 b2);  x2 = A22m^-1 (b2 - A12^T x1).

    ``fix_first`` gauge-fixes the first control pose by masking its rows and
    columns. Returns x1 (3K,) and x2 (2, R_pad).
    """
    dt = neq.b1.dtype
    device = neq.b1.device
    dim = neq.b1.shape[0]
    dp_pad = neq.A12.shape[1] // 2
    A11, b1 = neq.A11, neq.b1
    cols = torch.arange(dp_pad, device=device)
    colmask = ((cols >= (3 if fix_first else 0)) & (cols < dim)).to(dt)
    if fix_first:
        m = (torch.arange(dim, device=device) >= 3).to(dt)
        A11 = A11 * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        b1 = b1 * m
    Ae = neq.A12[:, :dp_pad] * colmask[None, :]
    Ao = neq.A12[:, dp_pad:] * colmask[None, :]

    A11m = A11 + lam * torch.diag(torch.diag(A11))
    m00, m01, m11 = _damped_a22_inv(neq, lam)

    Ze = Ae * m00[:, None] + Ao * m01[:, None]
    Zo = Ae * m01[:, None] + Ao * m11[:, None]
    S_red = Ae.T @ Ze + Ao.T @ Zo
    S = A11m - S_red[:dim, :dim]

    ib2x = m00 * neq.b2_x + m01 * neq.b2_y
    ib2y = m01 * neq.b2_x + m11 * neq.b2_y
    rhs = b1 - (ib2x @ Ae + ib2y @ Ao)[:dim]

    # diagonal floor: unobserved knots solve to zero instead of NaN
    eps = 1e-10 * torch.clamp(torch.max(torch.diag(S)), min=1.0) + 1e-30
    S = S + eps * torch.eye(dim, dtype=dt, device=device)

    L = torch.linalg.cholesky(S)
    x1 = torch.cholesky_solve(rhs[:, None], L)[:, 0]

    x1_pad = torch.zeros(dp_pad, dtype=dt, device=device)
    x1_pad[:dim] = x1
    vx = neq.b2_x - Ae @ x1_pad
    vy = neq.b2_y - Ao @ x1_pad
    x2x = m00 * vx + m01 * vy
    x2y = m01 * vx + m11 * vy
    return x1, torch.stack([x2x, x2y])


def update_map(Gx, Gy, x2, damping, neq: NormalEq):
    """Active pixels ``G += damping * x2``; inactive pixels reset to zero."""
    shape = Gx.shape
    r_pad = x2.shape[1]
    rows = torch.clamp(neq.pix2row.long(), max=r_pad - 1)
    valid = (neq.pix2row < r_pad) & neq.active_pix
    act = neq.active_pix.reshape(shape)
    zero = torch.zeros((), dtype=Gx.dtype, device=Gx.device)
    dxp = torch.where(valid, x2[0, rows], zero).reshape(shape)
    dyp = torch.where(valid, x2[1, rows], zero).reshape(shape)
    return (torch.where(act, Gx + damping * dxp, zero),
            torch.where(act, Gy + damping * dyp, zero))


def update_knots(knots, x1, fix_first: bool = False):
    """Left-multiplicative trajectory update from the solved perturbation;
    ``fix_first`` zeroes the first knot's increment."""
    drotv = x1.reshape(-1, 3)
    if fix_first:
        drotv = drotv.clone()
        drotv[0] = 0.0
    return lie.exp(drotv) @ knots
