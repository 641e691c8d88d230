"""Batched event -> panorama warping with chained analytic Jacobians
(counterpart of ``emba_tpu/warp.py``).

One spline evaluation per event batch (NB = N/100), then per-event work as
elementwise torch ops over (N,) component vectors. Left-perturbation
convention: ``d rb / d eps = -hat(rb)``, chained with the spline knot
Jacobian ``d pm / d cp = (d pm / d rb)(d rb / d rot)(d rot / d cp)``.
"""

from __future__ import annotations

import torch

from . import spline
from .camera import EquirectangularCamera


def spline_tables(knots, batch_s, batch_u, order: int, need_jacobian: bool = True):
    """Per-batch pose tables: (R_b (NB, 3, 3), J_b (NB, order, 3, 3) or
    None without ``need_jacobian``)."""
    if need_jacobian:
        return spline.evaluate(knots, batch_s, batch_u, order, True)
    return spline.evaluate(knots, batch_s, batch_u, order, False), None


def warp_events(knots, batch_s, batch_u, batch_ids, bearings,
                pano: EquirectangularCamera, order: int, need_jacobian: bool = True):
    """Warp all events of a window onto the panorama.

    Args:
      knots: (K, 3, 3) spline control poses.
      batch_s: (NB,) int32 spline segment per event batch.
      batch_u: (NB,) normalized offset per batch.
      batch_ids: (N,) int32 event -> batch index.
      bearings: (3, N) per-event unit bearing vectors.

    Returns ``((pmx, pmy), cp_idx, dpm_dcp)`` with pmx, pmy (N,), cp_idx
    (N,) int32 first involved knot, dpm_dcp (2, 3*order, N), or None
    without ``need_jacobian``.
    """
    R_b, J_b = spline_tables(knots, batch_s, batch_u, order, need_jacobian)
    return warp_from_tables(R_b, J_b, batch_s, batch_ids, bearings, pano, order,
                            need_jacobian)


def warp_from_tables(R_b, J_b, batch_s, batch_ids, bearings,
                     pano: EquirectangularCamera, order: int,
                     need_jacobian: bool = True):
    """Per-event warp given precomputed per-batch pose tables."""
    bid = batch_ids.long()
    # component-major tables, one gather each: (9, N) and (order*9, N)
    R9 = R_b.reshape(-1, 9).T.contiguous()[:, bid]
    bx, by, bz = bearings[0], bearings[1], bearings[2]
    x = R9[0] * bx + R9[1] * by + R9[2] * bz
    y = R9[3] * bx + R9[4] * by + R9[5] * bz
    z = R9[6] * bx + R9[7] * by + R9[8] * bz

    rho2 = x * x + y * y + z * z
    rho = torch.sqrt(rho2)
    fx, fy = pano.fx, pano.fy
    pmx = pano.width / 2.0 + torch.atan2(x, z) * fx
    y_div_rho = torch.clamp(y / rho, -1.0, 1.0)
    pmy = pano.height / 2.0 + torch.asin(y_div_rho) * fy

    cp_idx = batch_s[bid]
    if not need_jacobian:
        return (pmx, pmy), cp_idx, None

    # equirect projection Jacobian rows (z-axis / pole safe)
    xz2 = x * x + z * z
    xz2_safe = torch.where(xz2 < 1e-24, torch.ones_like(xz2), xz2)
    j00 = fx * z / xz2_safe
    j02 = -fx * x / xz2_safe
    one_m_w2 = torch.clamp(1.0 - y_div_rho * y_div_rho, min=1e-12)
    inv_sq = 1.0 / torch.sqrt(one_m_w2)
    tmp3 = y_div_rho / rho2
    j10 = fy * inv_sq * (-tmp3 * x)
    j11 = fy * inv_sq * (1.0 / rho - tmp3 * y)
    j12 = fy * inv_sq * (-tmp3 * z)

    # dpm_drot = Jproj @ (-hat(rb)); -hat rows: [0, z, -y], [-z, 0, x], [y, -x, 0]
    prow = torch.stack([
        torch.stack([j02 * y, j00 * z - j02 * x, -j00 * y]),
        torch.stack([-j11 * z + j12 * y, j10 * z - j12 * x, -j10 * y + j11 * x]),
    ])  # (2, 3[k], N)

    # dpm_dcp[r, 3o+j] = sum_k prow[r][k] * J_b[b, o, k, j]
    Jg = J_b.reshape(-1, order * 9).T.contiguous()[:, bid].reshape(order, 3, 3, -1)
    dpm_dcp = (
        prow[:, None, 0, None] * Jg[None, :, 0]
        + prow[:, None, 1, None] * Jg[None, :, 1]
        + prow[:, None, 2, None] * Jg[None, :, 2]
    )  # (2, order, 3, N)
    return (pmx, pmy), cp_idx, dpm_dcp.reshape(2, 3 * order, -1)
