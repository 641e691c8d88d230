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
  kernel on the card, its plain version on the CPU), over the full pixel
  domain or, with ``compact_cap``, over the compacted active pixels;
* the light linearization (``need_deriv=False``: residual fields only) and
  its forming pass :func:`form_normal_eq_light`, for ``light_trial``;
* the streamed passes (``stream_chunk``): the objective, the light
  linearization and the forming pass recomputed chunk by chunk from the
  per-batch pose tables, the A12 kernel chained through its ``carry``
  (FULL tier: nothing event-sized survives a pass; LIGHT tier,
  ``stream_light``: the (N,) residual fields stay resident), and the
  map-only closed-form solve of a fixed trajectory;
* the Schur solve as two GEMMs over the A12 column planes and one Cholesky.

Per-event arrays keep the reference layouts: (N,) vectors, (3, N)
bearings, (D, N) Jacobians.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import lie, obs, warp
from .camera import EquirectangularCamera
from .device import add_at
from .kernels import a12_accum, schur_rows

# Row alignment of a compacted row space: the reference's TILE_PX, so that
# an undersized cap keeps the same slots, and drops the same active
# pixels, in both packages (the full pixel domain keeps the kernel's
# ROW_ALIGN: its rows past HW are inactive either way).
COMPACT_ALIGN = 512


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
        if self.compact_cap is not None and self.compact_cap < 1:
            raise ValueError(f"ModelConfig.compact_cap must be >= 1, got {self.compact_cap}")
        if self.stream_chunk is not None and self.stream_chunk < 1:
            raise ValueError(f"ModelConfig.stream_chunk must be >= 1, got {self.stream_chunk}")

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
                    device, pad_multiple: int = 1):
        """Build a ``pairing.EventWindow``'s device arrays on ``device``.
        Only its raw columns (x and y as int32, pol as int8: 9 bytes an
        event), its per-batch arrays and ``bearing_lut`` in ``dtype`` are
        copied (span ``upload.copy``, counter ``window.upload_bytes``); the
        sensor pixels, the pairing (:func:`pair_by_pixel`), the bearings (a
        gather of the LUT), the polarity signs and the batch ids are
        computed on ``device`` (span ``upload.pair``), equal bit for bit to
        the host's (a cast then a gather is a gather then a cast; the rest
        is integer or +-1). The window's own ``prev_idx`` is not read.

        The window's arrays are allocated first, in their final sizes, and
        the columns are copied into them (x into ``prev_idx``, y into
        ``sensor_pix``, pol into ``has_prev``) and consumed there, so the
        build holds no event-sized array beyond the window's own but the
        pairing's chunk (:data:`PAIR_CHUNK`).

        ``pad_multiple``: pad the per-event arrays to a multiple of this
        length (a streamed window's ``stream_chunk``, so that its last chunk
        is full). Padding slots are non-measurements: a unit-z bearing (a
        zero bearing warps to NaN), ``has_prev=False`` (an inlier nowhere),
        batch 0."""
        n, nb = win.num_events, len(win.batch_s)
        n_pad = -(-n // pad_multiple) * pad_multiple

        def empty(*shape, dt=torch.int32):
            return torch.empty(shape, dtype=dt, device=device)

        dev = cls(bearings=empty(3, n_pad, dt=dtype), pol_signed=empty(n_pad, dt=dtype),
                  prev_idx=empty(n_pad), has_prev=empty(n_pad, dt=torch.bool),
                  batch_ids=empty(n_pad), batch_s=empty(nb), batch_u=empty(nb, dt=dtype),
                  sensor_pix=empty(n_pad))
        pol = dev.has_prev.view(torch.int8)[:n]
        with obs.span("upload.copy"):
            lut = torch.from_numpy(np.ascontiguousarray(np.asarray(bearing_lut).T)).to(dtype)
            copies = [(dst, torch.from_numpy(np.ascontiguousarray(a, dt))) for dst, a, dt in (
                (dev.prev_idx[:n], win.x, np.int32), (dev.sensor_pix[:n], win.y, np.int32),
                (pol, win.pol, np.int8), (dev.batch_s, win.batch_s, np.int32))]
            copies.append((dev.batch_u, torch.from_numpy(np.asarray(win.batch_u)).to(dtype)))
            obs.count("window.upload_bytes", lut.nbytes + sum(src.nbytes for _, src in copies))
            for dst, src in copies:
                dst.copy_(src)
            lut = lut.to(device)

        with obs.span("upload.pair"):
            spix = dev.sensor_pix[:n].mul_(sensor_width).add_(dev.prev_idx[:n])
            dev.pol_signed[:n].copy_(pol).mul_(2).sub_(1)
            pair_by_pixel(spix, lut.shape[1], dev.prev_idx[:n], dev.has_prev[:n])
            for r in range(3):
                torch.index_select(lut[r], 0, spix, out=dev.bearings[r, :n])
            torch.arange(n, out=dev.batch_ids[:n]).div_(win.batch_size, rounding_mode="floor")
            if n_pad > n:
                for a in (dev.pol_signed, dev.prev_idx, dev.has_prev, dev.batch_ids,
                          dev.sensor_pix, dev.bearings):
                    a[..., n:] = 0
                dev.bearings[2, n:] = 1
        return dev


# Events paired a sort at a time by :func:`pair_by_pixel`, so that the
# sort's scratch (keys, int64 indices, the radix sort's buffers: ~40 bytes
# an event) does not grow with the window. On an H100 the benchmark's
# reserved peak reads the same at 2^16 and 2^18 and 57 MB more at 2^20.
PAIR_CHUNK = 1 << 18


def pair_by_pixel(spix, num_pix: int, prev_idx, has_prev):
    """Pair events in arrival order at their flat sensor pixels ``spix``
    (int32, (N,), any device; pixels below ``num_pix``): write into
    ``prev_idx`` (int32) the index of the previous event at the same pixel,
    clipped to >= 0, and into ``has_prev`` (bool) whether there is one; the
    device counterpart of ``pairing.compute_prev_index``. Chunk by chunk of
    :data:`PAIR_CHUNK` events in arrival order: a stable sort of the chunk's
    pixel keys keeps arrival order within a pixel, so an event's predecessor
    is its neighbour in sorted order when their keys are equal, and for the
    first of its pixel in the chunk the last event there of the chunks
    before (``last``, -1 if none)."""
    last = torch.full((num_pix,), -1, dtype=torch.int32, device=spix.device)
    for a in range(0, spix.numel(), PAIR_CHUNK):
        keys, order = torch.sort(spix[a:a + PAIR_CHUNK], stable=True)
        order += a
        prev = last.index_select(0, keys)
        prev[1:] = torch.where(keys[1:] == keys[:-1], order[:-1].to(torch.int32), prev[1:])
        has_prev.scatter_(0, order, prev >= 0)
        prev_idx.scatter_(0, order, prev.clamp_(min=0))
        last.scatter_reduce_(0, keys.long(), order.to(torch.int32), "amax")


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


def linearize(knots, Gx, Gy, dev: DeviceWindow, cfg: ModelConfig,
              need_deriv: bool = True):
    """Warp + pair + residual + per-measurement Jacobians. With
    ``need_deriv=False`` the light linearization: the (N,)-sized residual
    fields only, no warp Jacobians and no Jacobian rows in the prev gather
    (``Jc`` and ``Jp`` are empty (D, 0) placeholders)."""
    pm, cp_idx, dpm_dcp = warp.warp_events(
        knots, dev.batch_s, dev.batch_u, dev.batch_ids, dev.bearings, cfg.pano,
        cfg.spline_order, need_deriv,
    )
    pmx, pmy = pm
    d = cfg.dim_block
    prev = dev.prev_idx.long()
    if need_deriv:
        # (pmx, pmy) and the 2D Jacobian rows of the prev event in one gather
        prev_src = torch.cat([torch.stack([pmx, pmy]), dpm_dcp.reshape(2 * d, -1)])
        prev_g = prev_src[:, prev]
        pm_prev, dpm_prev = prev_g[:2], prev_g[2:].reshape(2, d, -1)
    else:
        pm_prev, dpm_prev = torch.stack([pmx, pmy])[:, prev], None
    return linearize_from_warp(
        pmx, pmy, cp_idx, dpm_dcp, pm_prev, dpm_prev, cp_idx[prev], dev.has_prev,
        dev.pol_signed, Gx, Gy, cfg, need_deriv,
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


def _stacked_gmaps(Gx, Gy, need_deriv: bool = True):
    """(5, HW) stacked map planes, values and second-order gradients; (2,
    HW), the values only, without ``need_deriv``."""
    if not need_deriv:
        return torch.stack([Gx.reshape(-1), Gy.reshape(-1)])
    gxx, gxy, gyy = second_order_gradients(Gx, Gy)
    return torch.stack([Gx.reshape(-1), Gy.reshape(-1), gxx.reshape(-1),
                        gxy.reshape(-1), gyy.reshape(-1)])


def linearize_from_warp(pmx, pmy, cp_idx, dpm_dcp, pm_prev, dpm_prev, i_p,
                        has_prev, pol_signed, Gx, Gy, cfg: ModelConfig,
                        need_deriv: bool = True):
    """Residual + Jacobian core given warped curr events and their prev
    data; without ``need_deriv`` the residual fields only (``dpm_dcp`` and
    ``dpm_prev`` are not read)."""
    gmaps = _stacked_gmaps(Gx, Gy, need_deriv)
    dx, dy, inlier, pm_pix, g_at, e = _pair_residual(
        pmx, pmy, pm_prev[0], pm_prev[1], has_prev, pol_signed, gmaps, cfg
    )
    num_ev_map = torch.zeros(cfg.num_pix, dtype=torch.int32, device=pmx.device)
    num_ev_map.index_add_(0, pm_pix.long(), inlier.to(torch.int32))

    if not need_deriv:
        empty = torch.zeros((cfg.dim_block, 0), dtype=pmx.dtype, device=pmx.device)
        return Linearization(e=e, inlier=inlier, pm_pix=pm_pix, num_ev_map=num_ev_map,
                             dx=dx, dy=dy, Jc=empty, Jp=empty, i_c=cp_idx, i_p=i_p)

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
    [dp_pad:2*dp_pad). A row is a pano pixel (R_pad >= HW) or, with
    ``compact_cap``, the slot of an active pixel (R_pad = the cap rounded
    up to ``COMPACT_ALIGN``); ``pix2row`` maps pixels to rows (R_pad:
    dropped)."""

    A11: torch.Tensor  # (3K, 3K)
    b1: torch.Tensor  # (3K,)
    a22_xx: torch.Tensor  # (R_pad,)
    a22_xy: torch.Tensor
    a22_yy: torch.Tensor
    b2_x: torch.Tensor
    b2_y: torch.Tensor
    A12: torch.Tensor  # (R_pad, 2*dp_pad)
    active: torch.Tensor  # (R_pad,) bool row validity
    pix2row: torch.Tensor  # (HW,) int32 pano pixel -> row (>= R_pad: dropped)
    active_pix: torch.Tensor  # (HW,) bool pixel-space activity
    active_count: torch.Tensor  # () int32
    dropped: torch.Tensor  # () int32 measurements past the cap (0 uncompacted)


def row_pad(cfg: ModelConfig) -> int:
    """R_pad, the rows of the map-domain row space the solve runs over: the
    pixels rounded up to the kernel's ``ROW_ALIGN``, or with
    ``compact_cap`` the cap (at most the pixels) rounded up to
    ``COMPACT_ALIGN``."""
    if cfg.compact_cap is None:
        return a12_accum.round_up(cfg.num_pix, a12_accum.ROW_ALIGN)
    return a12_accum.round_up(min(cfg.compact_cap, cfg.num_pix), COMPACT_ALIGN)


def _row_space(num_ev_map, cfg: ModelConfig):
    """Active-pixel mask + the map-domain row space: the full pixel domain,
    or with ``compact_cap`` the active pixels in pixel order, one slot each,
    up to the cap rounded up to ``COMPACT_ALIGN`` (the slots past the cap
    hold rows that stay inactive, as in the reference). Everything stays
    on the device (no size is read on the host), so a CUDA graph can hold
    it. Returns (active, r_pad, pix2row, row_active)."""
    hw = cfg.num_pix
    device = num_ev_map.device
    active = num_ev_map >= cfg.thres_valid_pixel
    r_pad = row_pad(cfg)
    if cfg.compact_cap is None:
        pix2row = torch.arange(hw, dtype=torch.int32, device=device)
        row_active = torch.nn.functional.pad(active, (0, r_pad - hw))
        return active, r_pad, pix2row, row_active
    r_dom = min(cfg.compact_cap, hw)
    compact_id = torch.cumsum(active.to(torch.int32), 0, dtype=torch.int32) - 1
    # active pixels -> their slot, slots past r_pad and inactive pixels ->
    # r_pad (dropped everywhere)
    pix2row = torch.where(active & (compact_id < r_pad), compact_id, r_pad).to(torch.int32)
    num_active = torch.sum(active.to(torch.int32))
    row_active = (torch.arange(r_pad, device=device)
                  < torch.clamp(num_active, max=r_dom))
    return active, r_pad, pix2row, row_active


def _meas_weights(e, inlier, pm_pix, active, cfg, dt, in_row=None):
    """Per-measurement weight wA: the IRLS weight of an inlier on an active
    pixel (and, where ``in_row`` is given, on a row of the row space),
    else 0 (the kernel derives the residual weight wA * e itself)."""
    w = inlier & active[pm_pix.long()]
    if in_row is not None:
        w = w & in_row
    yi = irls_weights(e, cfg)
    return torch.where(w, yi, torch.zeros_like(yi)).to(dt)


def _rows_and_weights(e, inlier, pm_pix, active, pix2row, r_pad, cfg, dt):
    """(row_of_meas, wA, dropped) of a measurement set in a row space."""
    if cfg.compact_cap is None:
        row_of_meas = pm_pix
        wA = _meas_weights(e, inlier, pm_pix, active, cfg, dt)
        dropped = torch.zeros((), dtype=torch.int32, device=e.device)
    else:
        row_of_meas = pix2row[pm_pix.long()]
        in_row = row_of_meas < r_pad
        wA = _meas_weights(e, inlier, pm_pix, active, cfg, dt, in_row)
        used = inlier & active[pm_pix.long()]
        dropped = torch.sum((used & ~in_row).to(torch.int32)).to(torch.int32)
    return row_of_meas, wA, dropped


def forming_inputs(lin: Linearization, cfg: ModelConfig, dt):
    """What one forming pass hands the A12 kernel, and its row space:
    (row_of_meas, wA, r_pad, dropped, (active, pix2row, row_active)).
    Uncompacted, a measurement's row is its pixel. Compacted, it is the
    pixel's slot; a measurement on an active pixel past the cap is dropped
    from every block (else the system turns asymmetric) and counted in
    ``dropped``, on the device."""
    active, r_pad, pix2row, row_active = _row_space(lin.num_ev_map, cfg)
    row_of_meas, wA, dropped = _rows_and_weights(lin.e, lin.inlier, lin.pm_pix, active,
                                                 pix2row, r_pad, cfg, dt)
    return row_of_meas, wA, r_pad, dropped, (active, pix2row, row_active)


def form_normal_eq(lin: Linearization, Gx, Gy, cfg: ModelConfig, num_knots: int,
                   reg_scale=None) -> NormalEq:
    """Build the Schur-structured normal equations with the L2 map
    regularizer. A measurement enters iff it is an inlier and lands on an
    active pixel (>= thres_valid_pixel inliers) that has a row."""
    dt = lin.e.dtype
    dim_pose = 3 * num_knots
    row_of_meas, wA, r_pad, dropped, (active, pix2row, row_active) = forming_inputs(
        lin, cfg, dt)
    a12, px5, a11b = a12_accum.a12_accumulate(
        row_of_meas, lin.i_c, lin.i_p, lin.Jc, lin.Jp, lin.dx, lin.dy, lin.e, wA,
        r_pad, dim_pose, cfg.spline_order,
    )
    dp_pad = a12.shape[1] // 2
    return _finish_normal_eq(
        a11b[:dim_pose, :dim_pose], a11b[dp_pad, :dim_pose], px5[:, 0], px5[:, 1],
        px5[:, 2], px5[:, 3], px5[:, 4], a12, row_active, pix2row, active, Gx, Gy,
        cfg, r_pad, dt, dropped, reg_scale,
    )


def form_normal_eq_light(lin: Linearization, knots, Gx, Gy, dev: DeviceWindow,
                         cfg: ModelConfig, num_knots: int, reg_scale=None) -> NormalEq:
    """The forming pass of ``light_trial``: ``lin`` is a light
    linearization (``linearize(..., need_deriv=False)``); this pass
    recomputes the (D, N) Jacobians (the warp's derivative chain and the
    prev gather of its rows) at ``knots`` and forms the normal equations,
    the same ops on the same inputs as ``form_normal_eq(linearize(...))``.
    LM runs it after accepted steps only, so a rejected trial pays for the
    cost alone."""
    d = cfg.dim_block
    _, _, dpm = warp.warp_events(knots, dev.batch_s, dev.batch_u, dev.batch_ids,
                                 dev.bearings, cfg.pano, cfg.spline_order)
    dpm_prev = dpm.reshape(2 * d, -1)[:, dev.prev_idx.long()].reshape(2, d, -1)
    g_at = _stacked_gmaps(Gx, Gy)[:, lin.pm_pix.long()]
    tx, ty, hx, hy = _pose_jac_coeffs(g_at, lin.dx, lin.dy, cfg)
    Jc = tx[None, :] * dpm[0] + ty[None, :] * dpm[1]
    Jp = hx[None, :] * dpm_prev[0] + hy[None, :] * dpm_prev[1]
    full = dataclasses.replace(lin, Jc=Jc, Jp=Jp)
    return form_normal_eq(full, Gx, Gy, cfg, num_knots, reg_scale)


# ---------------------------------------------------------------------------
# Streamed passes (``stream_chunk``).
# ---------------------------------------------------------------------------


def prev_records(dev: DeviceWindow):
    """(prev bearings (3, N), prev batch ids (N,)): each event's prev-event
    bearing and batch, gathered once a window. They do not depend on the
    state, so every streamed pass of every iteration reads contiguous
    slices of them instead of gathering by ``prev_idx`` per chunk."""
    prev = dev.prev_idx.long()
    return dev.bearings[:, prev], dev.batch_ids[prev]


def stream_bounds(n: int, chunk: int) -> list[tuple[int, int]]:
    """The (lo, hi) event slices of the streamed passes: ``ceil(n /
    chunk)`` of them (one, empty, for an empty window), from the shapes
    alone, so a CUDA graph holds a fixed chunk count a window shape. The
    last is short unless the window was padded to a chunk multiple
    (``DeviceWindow.from_window(..., pad_multiple=stream_chunk)``)."""
    return [(lo, min(lo + chunk, n)) for lo in range(0, max(n, 1), chunk)]


def _prev_or_records(dev, prev_bearings, prev_bids):
    if prev_bearings is None:
        return prev_records(dev)
    return prev_bearings, prev_bids


def _make_stream_chunk_fn(knots, Gx, Gy, dev: DeviceWindow, cfg: ModelConfig,
                          need_deriv: bool, prev_bearings=None, prev_bids=None):
    """The chunk recompute of the FULL tier: the per-batch pose tables and
    the stacked map planes once, then ``pieces(lo, hi)`` re-runs the warp
    of the events [lo, hi) and of their prev events (from the prev
    records), the pairing residual (the shared :func:`_pair_residual`) and,
    with ``need_deriv``, the Jacobians (:func:`_pose_jac_coeffs`): the
    values of :func:`linearize_from_warp` on those events. Chunk inputs
    are views of the window. Returns (bounds, pieces); ``pieces`` gives
    (e, inlier, pm_pix, i_c, i_p, dx, dy) and, with ``need_deriv``, (Jc,
    Jp) after them."""
    order = cfg.spline_order
    pb, pbid = _prev_or_records(dev, prev_bearings, prev_bids)
    R_b, J_b = warp.spline_tables(knots, dev.batch_s, dev.batch_u, order, need_deriv)
    gmaps = _stacked_gmaps(Gx, Gy, need_deriv)

    def pieces(lo, hi):
        pm_c, ic_c, dpm_c = warp.warp_from_tables(
            R_b, J_b, dev.batch_s, dev.batch_ids[lo:hi], dev.bearings[:, lo:hi],
            cfg.pano, order, need_deriv)
        pm_p, ip_c, dpm_p = warp.warp_from_tables(
            R_b, J_b, dev.batch_s, pbid[lo:hi], pb[:, lo:hi], cfg.pano, order, need_deriv)
        dx, dy, inl, pmp, g_at, e = _pair_residual(
            pm_c[0], pm_c[1], pm_p[0], pm_p[1], dev.has_prev[lo:hi],
            dev.pol_signed[lo:hi], gmaps, cfg)
        if not need_deriv:
            return e, inl, pmp, ic_c, ip_c, dx, dy
        tx, ty, hx, hy = _pose_jac_coeffs(g_at, dx, dy, cfg)
        Jc = tx[None, :] * dpm_c[0] + ty[None, :] * dpm_c[1]
        Jp = hx[None, :] * dpm_p[0] + hy[None, :] * dpm_p[1]
        return e, inl, pmp, ic_c, ip_c, dx, dy, Jc, Jp

    return stream_bounds(dev.pol_signed.shape[0], cfg.stream_chunk), pieces


def _make_stream_chunk_fn_light(lin: Linearization, knots, Gx, Gy, dev: DeviceWindow,
                                cfg: ModelConfig, prev_bearings=None, prev_bids=None):
    """The chunk recompute of the LIGHT tier: the (N,) fields of the light
    linearization ``lin`` stay resident (slices of them are the chunk's);
    only the Jacobians are recomputed, from one warp of the chunk's events
    and one of their prev events. ``pieces`` has the contract of
    :func:`_make_stream_chunk_fn` with ``need_deriv``."""
    order = cfg.spline_order
    pb, pbid = _prev_or_records(dev, prev_bearings, prev_bids)
    R_b, J_b = warp.spline_tables(knots, dev.batch_s, dev.batch_u, order, True)
    gmaps = _stacked_gmaps(Gx, Gy)

    def pieces(lo, hi):
        _, _, dpm_c = warp.warp_from_tables(R_b, J_b, dev.batch_s, dev.batch_ids[lo:hi],
                                            dev.bearings[:, lo:hi], cfg.pano, order)
        _, _, dpm_p = warp.warp_from_tables(R_b, J_b, dev.batch_s, pbid[lo:hi],
                                            pb[:, lo:hi], cfg.pano, order)
        pmp, dx, dy = lin.pm_pix[lo:hi], lin.dx[lo:hi], lin.dy[lo:hi]
        g_at = gmaps[:, pmp.long()]
        tx, ty, hx, hy = _pose_jac_coeffs(g_at, dx, dy, cfg)
        Jc = tx[None, :] * dpm_c[0] + ty[None, :] * dpm_c[1]
        Jp = hx[None, :] * dpm_p[0] + hy[None, :] * dpm_p[1]
        return (lin.e[lo:hi], lin.inlier[lo:hi], pmp, lin.i_c[lo:hi], lin.i_p[lo:hi],
                dx, dy, Jc, Jp)

    return stream_bounds(lin.e.shape[0], cfg.stream_chunk), pieces


def _activity_and_cost(bounds, pieces, cfg, dt, device):
    """Pass over the chunks: (data cost, (HW,) int32 inlier count map).
    Integer adds are exact, so the map is the same in any order."""
    cost = torch.zeros((), dtype=dt, device=device)
    nem = torch.zeros(cfg.num_pix, dtype=torch.int32, device=device)
    for lo, hi in bounds:
        e, inl, pmp = pieces(lo, hi)[:3]
        nem.index_add_(0, pmp.long(), inl.to(torch.int32))
        cost = cost + data_cost(e, cfg)
    return cost, nem


def cost_and_activity_streamed(knots, Gx, Gy, dev: DeviceWindow, cfg: ModelConfig,
                               prev_bearings=None, prev_bids=None):
    """The FULL tier's objective: (data cost, (HW,) inlier count map),
    chunk by chunk, with no event-sized output: the streamed counterpart
    of ``linearize(..., need_deriv=False)`` and :func:`data_cost`."""
    bounds, pieces = _make_stream_chunk_fn(knots, Gx, Gy, dev, cfg, False,
                                           prev_bearings, prev_bids)
    return _activity_and_cost(bounds, pieces, cfg, Gx.dtype, Gx.device)


def linearize_streamed_light(knots, Gx, Gy, dev: DeviceWindow, cfg: ModelConfig,
                             prev_bearings=None, prev_bids=None):
    """The LIGHT tier's objective: the light linearization of
    ``linearize(..., need_deriv=False)`` (the same fields, by the shared
    residual core), computed chunk by chunk into its (N,) fields, and the
    data cost summed a chunk at a time. Returns (lin, cost)."""
    dt, device = Gx.dtype, Gx.device
    n = dev.pol_signed.shape[0]
    bounds, pieces = _make_stream_chunk_fn(knots, Gx, Gy, dev, cfg, False,
                                           prev_bearings, prev_bids)
    e = torch.empty(n, dtype=dt, device=device)
    inl = torch.empty(n, dtype=torch.bool, device=device)
    pmp, ic, ip = (torch.empty(n, dtype=torch.int32, device=device) for _ in range(3))
    dx, dy = torch.empty(n, dtype=dt, device=device), torch.empty(n, dtype=dt, device=device)
    cost = torch.zeros((), dtype=dt, device=device)
    nem = torch.zeros(cfg.num_pix, dtype=torch.int32, device=device)
    for lo, hi in bounds:
        got = pieces(lo, hi)
        for buf, v in zip((e, inl, pmp, ic, ip, dx, dy), got):
            buf[lo:hi] = v
        nem.index_add_(0, got[2].long(), got[1].to(torch.int32))
        cost = cost + data_cost(got[0], cfg)
    empty = torch.zeros((cfg.dim_block, 0), dtype=dt, device=device)
    return Linearization(e=e, inlier=inl, pm_pix=pmp, num_ev_map=nem, dx=dx, dy=dy,
                         Jc=empty, Jp=empty, i_c=ic, i_p=ip), cost


def form_normal_eq_streamed(aux, knots, Gx, Gy, dev: DeviceWindow, cfg: ModelConfig,
                            num_knots: int, reg_scale=None, prev_bearings=None,
                            prev_bids=None) -> NormalEq:
    """The streamed forming pass: the normal equations of
    :func:`form_normal_eq`, with the linearization recomputed in chunks of
    ``cfg.stream_chunk`` events and each chunk added into the same
    accumulators: the A12 kernel's first call makes them and every later
    call adds into them in place (``carry``), so a pass launches the kernel
    once a chunk and holds one A12. ``aux`` is the objective's forming
    input at the state formed: the (HW,) inlier count map in the FULL tier
    (:func:`cost_and_activity_streamed`), the light linearization in the
    LIGHT tier (``cfg.stream_light``, :func:`linearize_streamed_light`).
    ``dropped`` sums each chunk's, on the device."""
    dt = Gx.dtype
    dim_pose = 3 * num_knots
    if cfg.stream_light:
        num_ev_map = aux.num_ev_map
        bounds, pieces = _make_stream_chunk_fn_light(aux, knots, Gx, Gy, dev, cfg,
                                                     prev_bearings, prev_bids)
    else:
        num_ev_map = aux
        bounds, pieces = _make_stream_chunk_fn(knots, Gx, Gy, dev, cfg, True,
                                               prev_bearings, prev_bids)
    active, r_pad, pix2row, row_active = _row_space(num_ev_map, cfg)
    carry = None
    dropped = torch.zeros((), dtype=torch.int32, device=Gx.device)
    for lo, hi in bounds:
        e, inl, pmp, ic, ip, dx, dy, Jc, Jp = pieces(lo, hi)
        rows, wA, drop = _rows_and_weights(e, inl, pmp, active, pix2row, r_pad, cfg, dt)
        carry = a12_accum.a12_accumulate(rows, ic, ip, Jc, Jp, dx, dy, e, wA, r_pad,
                                         dim_pose, cfg.spline_order, carry=carry)
        dropped = dropped + drop
    a12, px5, a11b = carry
    dp_pad = a12.shape[1] // 2
    return _finish_normal_eq(
        a11b[:dim_pose, :dim_pose], a11b[dp_pad, :dim_pose], px5[:, 0], px5[:, 1],
        px5[:, 2], px5[:, 3], px5[:, 4], a12, row_active, pix2row, active, Gx, Gy,
        cfg, r_pad, dt, dropped, reg_scale,
    )


# The map-only step sums its per-pixel blocks in a fixed order
# (``device.add_at``: sorted on CUDA, where ``index_add_`` would add by
# atomics), so two runs should agree in bits. The tolerance two runs are
# held to, as a fraction of the map's largest magnitude, is that of sums in
# any order: the regularizer keeps each 2x2 block's determinant >= alpha^2,
# so reordered f32 sums move the solved map by a few ulps of its largest
# values at most.
MAP_ONLY_REPEAT_REL_TOL = 1e-5


class _Whole:
    """The collectives of a window that one device holds whole: the
    interface of ``dist.Comm`` at one rank (every sum is the rank's own,
    its chunk is the whole)."""

    world, rank = 1, 0

    @staticmethod
    def all_reduce_sum(x):
        return x

    @staticmethod
    def reduce_scatter_sum(x, dim=0):
        return x

    @staticmethod
    def all_gather(x, dim=0):
        return x


def map_only_step(knots, Gx, Gy, dev: DeviceWindow, cfg: ModelConfig,
                  prev_bearings=None, prev_bids=None, comm=None):
    """One map-only step with the trajectory fixed (the super-resolution
    path): with the pose frozen the residual is affine in the map, so the
    map block decouples into per-pixel 2x2 systems ``(A22 + alpha I) x2 =
    b2 - alpha G`` and one closed-form solve is the exact minimizer of the
    quadratic cost. Two chunked passes (the inlier count map and the data
    cost; then the active-masked A22 / b2 sums, in a fixed order), no A11
    or A12, so memory is
    O(HW + chunk) at any panorama size. With ``use_irls`` the weights are
    taken at the input map. Returns (Gx', Gy', data cost at the input map,
    num_ev_map); inactive pixels reset to zero.

    ``comm`` (a ``dist.Comm``; ``dev`` its rank's shard, the prev records
    its halo's): the count map and the cost summed over the ranks, the
    five per-pixel sums reduce-scattered as one (5, HW_pad) tensor (HW
    padded to a multiple of the ranks), the 2x2 solves on the rank's chunk
    of pixels, the solved maps gathered."""
    comm = comm or _Whole
    dt, device = Gx.dtype, Gx.device
    hw = cfg.num_pix
    rows = -(-hw // comm.world)
    bounds, pieces = _make_stream_chunk_fn(knots, Gx, Gy, dev, cfg, False,
                                           prev_bearings, prev_bids)
    cost0, nem = _activity_and_cost(bounds, pieces, cfg, dt, device)
    cost0, nem = comm.all_reduce_sum(cost0), comm.all_reduce_sum(nem)
    active = nem >= cfg.thres_valid_pixel
    sums = comm.reduce_scatter_sum(
        map_only_sums(bounds, pieces, active, cfg, dt, device, rows * comm.world), dim=1)

    def chunk(v):
        v = torch.nn.functional.pad(v, (0, rows * comm.world - hw))
        return v[comm.rank * rows:(comm.rank + 1) * rows]

    gx_c, gy_c = map_only_solve(sums, chunk(active), chunk(Gx.reshape(-1).to(dt)),
                                chunk(Gy.reshape(-1).to(dt)), cfg)
    maps = comm.all_gather(torch.stack([gx_c, gy_c]), dim=1)[:, :hw]
    return maps[0].reshape(Gx.shape), maps[1].reshape(Gy.shape), cost0, nem


def map_only_sums(bounds, pieces, active, cfg, dt, device, size: int):
    """The map-only step's per-pixel sums over the chunks of ``pieces``:
    (5, ``size``) rows a22_xx, a22_xy, a22_yy, b2_x, b2_y of the
    active-masked measurements, each added in a fixed order
    (``device.add_at``); ``size`` >= HW (a sharded step pads the pixel
    axis to a multiple of its ranks)."""
    acc = torch.zeros((5, size), dtype=dt, device=device)
    for lo, hi in bounds:
        e, inl, pmp, _ic, _ip, dx, dy = pieces(lo, hi)
        pix = pmp.long()
        wA = _meas_weights(e, inl, pmp, active, cfg, dt)
        we = wA * e
        for row, v in zip(acc, (wA * dx * dx, wA * dx * dy, wA * dy * dy, we * dx,
                                we * dy)):
            add_at(row, pix, v)
    return acc


def map_only_solve(sums, active, gx_f, gy_f, cfg):
    """The closed-form per-pixel 2x2 solve of the map-only step on a run of
    pixels: ``sums`` (5, P) from :func:`map_only_sums`, ``active`` and the
    flat maps ``gx_f``, ``gy_f`` (P,). Returns the new flat maps; inactive
    pixels reset to zero. Each pixel's arithmetic is its own, so a rank
    solving a chunk of the pixels gets the bits of the whole solve."""
    a22xx, a22xy, a22yy, b2x, b2y = sums
    dt, device = gx_f.dtype, gx_f.device
    af = active.to(dt)
    a = a22xx + cfg.alpha * af
    b = a22xy
    d = a22yy + cfg.alpha * af
    rx = b2x - cfg.alpha * gx_f * af
    ry = b2y - cfg.alpha * gy_f * af
    det = a * d - b * b
    det_safe = torch.where(torch.abs(det) < 1e-30, torch.ones_like(det), det)
    ok = (active & (torch.abs(det) >= 1e-30)).to(dt) / det_safe
    x2x = (d * rx - b * ry) * ok
    x2y = (a * ry - b * rx) * ok
    zero = torch.zeros((), dtype=dt, device=device)
    return torch.where(active, gx_f + x2x, zero), torch.where(active, gy_f + x2y, zero)


def solve_map_only(knots, Gx, Gy, dev: DeviceWindow, cfg: ModelConfig, num_iters: int = 1,
                   prev_bearings=None, prev_bids=None, comm=None):
    """The map from a fixed trajectory (:func:`map_only_step`). One step is
    exact for the quadratic cost; ``num_iters > 1`` refreshes the IRLS
    weights between steps. Without ``stream_chunk`` it streams in chunks of
    2^20 events; compaction does not apply (rows are pixels). With
    ``comm``, over the ranks' shards (the prev records are then required:
    ``dist.prev_records``). Returns (Gx, Gy, costs): ``num_iters + 1`` data
    costs, the last at the final map."""
    if cfg.stream_chunk is None:
        cfg = dataclasses.replace(cfg, stream_chunk=1 << 20)
    if cfg.compact_cap is not None:
        cfg = dataclasses.replace(cfg, compact_cap=None)
    comm = comm or _Whole
    pb, pbid = _prev_or_records(dev, prev_bearings, prev_bids)
    costs = []
    for _ in range(num_iters):
        Gx, Gy, cost, _nem = map_only_step(knots, Gx, Gy, dev, cfg, pb, pbid, comm)
        costs.append(float(cost))
    bounds, pieces = _make_stream_chunk_fn(knots, Gx, Gy, dev, cfg, False, pb, pbid)
    cost = _activity_and_cost(bounds, pieces, cfg, Gx.dtype, Gx.device)[0]
    costs.append(float(comm.all_reduce_sum(cost)))
    return Gx, Gy, costs


def _finish_normal_eq(A11, b1, a22xx, a22xy, a22yy, b2x, b2y, A12, row_active,
                      pix2row, active_pix, Gx, Gy, cfg, r_pad, dt, dropped,
                      reg_scale=None):
    """Apply the L2 map regularizer on active rows and assemble the
    NormalEq; the map values reach their rows through ``pix2row``."""
    alpha = cfg.alpha if reg_scale is None else cfg.alpha * reg_scale
    act_f = row_active.to(dt)
    rows = pix2row.long()

    def to_rows(G):
        # one active pixel a row at most: the sums are exact; slot r_pad
        # takes the dropped pixels and is cut off
        g = torch.where(active_pix, G.reshape(-1).to(dt),
                        torch.zeros((), dtype=dt, device=G.device))
        out = torch.zeros(r_pad + 1, dtype=dt, device=G.device)
        return out.index_add_(0, rows, g)[:r_pad]

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


def _chol(S):
    """Lower Cholesky factor. ``cholesky_ex`` leaves its status on the
    device (a failed factor gives NaN, as ``cho_factor`` in the reference)
    instead of reading it on the host, so a CUDA graph can hold it."""
    return torch.linalg.cholesky_ex(S).L


def _chol_solve(L, b):
    return torch.cholesky_solve(b[:, None], L)[:, 0]


def _masked_pose_block(neq: NormalEq, fix_first: bool):
    """(A11, b1, first kept column): with ``fix_first`` the first pose's
    rows and columns masked out (A11 there the identity)."""
    A11, b1 = neq.A11, neq.b1
    if not fix_first:
        return A11, b1, 0
    dim = b1.shape[0]
    m = (torch.arange(dim, device=b1.device) >= 3).to(b1.dtype)
    return A11 * m[:, None] * m[None, :] + torch.diag(1.0 - m), b1 * m, 3


def _masked_planes(neq: NormalEq, fix_first: bool):
    """(A11, b1, Ae, Ao) with the padded pose columns (and, with
    ``fix_first``, the first pose's rows and columns) masked out."""
    dim = neq.b1.shape[0]
    dp_pad = neq.A12.shape[1] // 2
    A11, b1, lo = _masked_pose_block(neq, fix_first)
    cols = torch.arange(dp_pad, device=neq.b1.device)
    colmask = ((cols >= lo) & (cols < dim)).to(neq.b1.dtype)
    Ae = neq.A12[:, :dp_pad] * colmask[None, :]
    Ao = neq.A12[:, dp_pad:] * colmask[None, :]
    return A11, b1, Ae, Ao


def _damped_a22_inv(neq: NormalEq, lam):
    """Per-pixel inverse of the LM-damped 2x2 blocks; zero where inactive.
    A22m = A22 + lam * diag(A22). Returns (m00, m01, m11, live): live marks
    the rows whose inverse is kept (active, determinant not ~0)."""
    dt = neq.a22_xx.dtype
    a = neq.a22_xx * (1.0 + lam)
    b = neq.a22_xy
    c = neq.a22_yy * (1.0 + lam)
    det = a * c - b * b
    det_safe = torch.where(torch.abs(det) < 1e-30, torch.ones_like(det), det)
    live = neq.active & (torch.abs(det) >= 1e-30)
    inv = live.to(dt) / det_safe
    return c * inv, -b * inv, a * inv, live


def solve_normal_eq(neq: NormalEq, lam, fix_first: bool = False, reduce=None,
                    gather=None, rows_total=None):
    """Schur-complement solve:

      A11m = A11 + lam diag(A11);  A22m^-1 per 2x2 block;
      S = A11m - A12 A22m^-1 A12^T;
      x1 = chol_solve(S, b1 - A12 A22m^-1 b2);  x2 = A22m^-1 (b2 - A12^T x1).

    Only the rows whose A22m^-1 is nonzero add to S, to the right-hand side
    and to x2: they are listed on the device (``schur_rows.row_list``) and
    the products run over the list (``schur_rows``: the CUDA kernel for
    float32 on the card, the plain version on the CPU and for float64);
    x2 is zero on every other row.

    ``fix_first`` gauge-fixes the first control pose by masking its rows and
    columns. Returns x1 (3K,) and x2 (2, R_pad). ``rows_total``, a 0-d
    int64 tensor on the device, if given, is increased by the rows listed.

    The map rows of ``neq`` may be one rank's chunk of them (``dist``):
    ``reduce`` then sums a tensor over the ranks (the parts of S and of the
    right-hand side, in one call) and ``gather`` assembles x2 (2, rows)
    from the chunks into (2, R_pad).
    """
    dt = neq.b1.dtype
    device = neq.b1.device
    dim = neq.b1.shape[0]
    dp_pad = neq.A12.shape[1] // 2
    A11, b1, lo = _masked_pose_block(neq, fix_first)

    A11m = A11 + lam * torch.diag(torch.diag(A11))
    m00, m01, m11, live = _damped_a22_inv(neq, lam)
    rows, count = schur_rows.row_list(live)
    vecs = (m00, m01, m11, neq.b2_x.contiguous(), neq.b2_y.contiguous())
    a12 = neq.A12.contiguous()
    S_red, rhs_red = schur_rows.schur_reduce(a12, rows, count, *vecs, lo, dim)
    if reduce is not None:
        both = reduce(torch.cat([S_red, rhs_red[None]]))
        S_red, rhs_red = both[:dp_pad], both[dp_pad]
    S = A11m - S_red[:dim, :dim]
    rhs = b1 - rhs_red[:dim]

    # diagonal floor: unobserved knots solve to zero instead of NaN
    eps = 1e-10 * torch.clamp(torch.max(torch.diag(S)), min=1.0) + 1e-30
    S = S + eps * torch.eye(dim, dtype=dt, device=device)

    x1 = _chol_solve(_chol(S), rhs)

    x1_pad = torch.zeros(dp_pad, dtype=dt, device=device)
    x1_pad[lo:dim] = x1[lo:]
    x2 = schur_rows.back_substitute(a12, rows, count, *vecs, x1_pad)
    if rows_total is not None:
        rows_total.add_(count)
    return x1, x2 if gather is None else gather(x2)


def solve_normal_eq_cg(neq: NormalEq, lam, fix_first: bool = False,
                       max_iter: int = 100, tol: float = 1e-6,
                       early_exit: bool = True, reduce=None, gather=None):
    """Matrix-free conjugate gradient on the full system
    [A11m A12; A12^T A22m] (counterpart of ``emba_tpu.model.solve_normal_eq_cg``),
    the operator applied blockwise, with the block-Jacobi preconditioner:
    exact A11m by one Cholesky, exact per-pixel 2x2 A22m blocks.

    It stops after ``max_iter`` iterations or once the residual norm falls
    below ``tol`` times the right-hand side's. With ``early_exit`` it reads
    that test on the host each iteration and leaves the loop; without, it
    runs all ``max_iter`` iterations and freezes the state once the test is
    met (the same result and iteration count), as a loop captured in a CUDA
    graph must. Returns (x1 (3K,), x2 (2, R_pad), iterations, relative
    residual).

    ``reduce`` and ``gather``: a rank's chunk of the map rows, as in
    :func:`solve_normal_eq`. The pose vectors stay whole on every rank; the
    A12 cross term and the map part of each inner product are summed over
    the ranks, so every rank takes the same iterations.
    """
    dt = neq.b1.dtype
    device = neq.b1.device
    dim = neq.b1.shape[0]
    dp_pad = neq.A12.shape[1] // 2
    A11, b1, Ae, Ao = _masked_planes(neq, fix_first)

    A11m = A11 + lam * torch.diag(torch.diag(A11))
    axx = neq.a22_xx * (1.0 + lam)
    axy = neq.a22_xy
    ayy = neq.a22_yy * (1.0 + lam)
    act = neq.active.to(dt)

    def pad(x1):
        return torch.nn.functional.pad(x1, (0, dp_pad - dim))

    def matvec(x1, x2x, x2y):
        cross = x2x @ Ae + x2y @ Ao
        if reduce is not None:
            cross = reduce(cross)
        y1 = A11m @ x1 + cross[:dim]
        a22x = axx * x2x + axy * x2y
        a22y = axy * x2x + ayy * x2y
        # inactive pixels: identity rows (their rhs is zero, so they stay zero)
        y2x = Ae @ pad(x1) + torch.where(neq.active, a22x, x2x)
        y2y = Ao @ pad(x1) + torch.where(neq.active, a22y, x2y)
        return y1, y2x, y2y

    def dot(a, b):
        if reduce is None:
            return sum(torch.sum(x * y) for x, y in zip(a, b))
        return torch.sum(a[0] * b[0]) + reduce(torch.sum(a[1] * b[1])
                                               + torch.sum(a[2] * b[2]))

    b = (b1, neq.b2_x * act, neq.b2_y * act)
    bnorm2 = dot(b, b)

    eps11 = 1e-10 * torch.clamp(torch.max(torch.diag(A11m)), min=1.0) + 1e-30
    L11 = _chol(A11m + eps11 * torch.eye(dim, dtype=dt, device=device))
    det22 = axx * ayy - axy * axy
    det22_safe = torch.where(torch.abs(det22) < 1e-30, torch.ones_like(det22), det22)
    inv_ok = neq.active & (torch.abs(det22) >= 1e-30)
    one, zero = torch.ones_like(det22), torch.zeros_like(det22)
    i00 = torch.where(inv_ok, ayy / det22_safe, one)
    i01 = torch.where(inv_ok, -axy / det22_safe, zero)
    i11 = torch.where(inv_ok, axx / det22_safe, one)

    def precond(r1, r2x, r2y):
        return _chol_solve(L11, r1), i00 * r2x + i01 * r2y, i01 * r2x + i11 * r2y

    x = tuple(torch.zeros_like(v) for v in b)
    r = b
    p = precond(*r)
    rz = dot(r, p)
    rs = bnorm2
    it = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(max_iter):
        run = rs > tol * tol * bnorm2
        if early_exit and not bool(run):
            break
        ap = matvec(*p)
        alpha = rz / (dot(p, ap) + 1e-300)
        x_new = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r_new = tuple(ri - alpha * api for ri, api in zip(r, ap))
        z = precond(*r_new)
        rz_new = dot(r_new, z)
        rs_new = dot(r_new, r_new)
        beta = rz_new / (rz + 1e-300)
        p_new = tuple(zi + beta * pi for zi, pi in zip(z, p))
        x = tuple(torch.where(run, n, o) for n, o in zip(x_new, x))
        r = tuple(torch.where(run, n, o) for n, o in zip(r_new, r))
        p = tuple(torch.where(run, n, o) for n, o in zip(p_new, p))
        rz = torch.where(run, rz_new, rz)
        rs = torch.where(run, rs_new, rs)
        it = it + run.to(it.dtype)
    x1, x2x, x2y = x
    rel = torch.sqrt(rs / torch.clamp(bnorm2, min=1e-300))
    x2 = torch.stack([x2x * act, x2y * act])
    return x1, x2 if gather is None else gather(x2), it, rel


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
