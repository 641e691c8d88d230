"""Rotation RMSE against ground truth after the best global alignment, in
degrees: a copy of the program's ``metrics.rotation_rmse_deg``, kept here so
that a change to the program cannot move the yardstick."""

from __future__ import annotations

import numpy as np
import torch

from .geometry import log_so3


def align_rotations(R_est: np.ndarray, R_gt: np.ndarray) -> np.ndarray:
    """The rotation Q that best aligns ``R_est`` to ``R_gt`` (chordal, by
    the SVD of their correlation)."""
    C = np.einsum("nij,nkj->ik", R_gt, R_est)
    U, _, Vt = np.linalg.svd(C)
    d = np.sign(np.linalg.det(U @ Vt))
    return U @ np.diag([1.0, 1.0, d]) @ Vt


def rotation_rmse_deg(R_est: np.ndarray, R_gt: np.ndarray, align: bool = True) -> float:
    """RMSE of the geodesic angle between estimated and true rotations."""
    if align:
        R_est = np.einsum("ij,njk->nik", align_rotations(R_est, R_gt), R_est)
    rel = np.einsum("nij,nkj->nik", R_est, R_gt)
    ang = np.linalg.norm(log_so3(torch.from_numpy(rel)).numpy(), axis=-1)
    return float(np.degrees(np.sqrt(np.mean(ang ** 2))))
