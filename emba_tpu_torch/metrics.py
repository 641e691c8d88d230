"""Evaluation metrics: rotation RMSE against ground truth, with SO(3)
alignment (counterpart of ``emba_tpu/metrics.py``), on numpy."""

from __future__ import annotations

import numpy as np

from . import spline


def align_rotations(R_est: np.ndarray, R_gt: np.ndarray) -> np.ndarray:
    """Best single global rotation Q minimizing sum ||log(Q R_est R_gt^T)||
    (chordal L2 via SVD of the correlation)."""
    C = np.einsum("nij,nkj->ik", R_gt, R_est)
    U, _, Vt = np.linalg.svd(C)
    d = np.sign(np.linalg.det(U @ Vt))
    return U @ np.diag([1.0, 1.0, d]) @ Vt


def rotation_rmse_deg(R_est: np.ndarray, R_gt: np.ndarray, align: bool = True) -> float:
    """RMSE of the geodesic angle between estimated and GT rotations [deg]."""
    if align:
        Q = align_rotations(R_est, R_gt)
        R_est = np.einsum("ij,njk->nik", Q, R_est)
    rel = np.einsum("nij,nkj->nik", R_est, R_gt)
    ang = np.linalg.norm(spline._np_log(rel), axis=-1)
    return float(np.degrees(np.sqrt(np.mean(ang**2))))


def trajectory_rmse_deg(traj: "spline.Trajectory", times: np.ndarray,
                        R_gt: np.ndarray, align: bool = True) -> float:
    R_est = np.asarray(traj.evaluate(times))
    return rotation_rmse_deg(R_est, R_gt, align=align)
